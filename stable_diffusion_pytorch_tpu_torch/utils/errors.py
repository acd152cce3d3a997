"""Crash reports (port of utils/errors.py).

:func:`record` wraps a training entry point's ``main``: on an exception it
writes a JSON report (host index, time, function, exception, traceback,
argv) to ``logs/crashes/host{i}_{time}.json`` and re-raises, so a launcher
can collect every host's failure after a multi-process run. The host index
is the ``torch.distributed`` rank, or 0 outside a process group.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time
import traceback
from typing import Callable


def _host_index() -> int:
    try:
        import torch.distributed as dist

        return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    except Exception:
        return 0


def record(fn: Callable, crash_dir: str = "logs/crashes") -> Callable:
    """``fn`` that, on an exception other than ``KeyboardInterrupt`` or
    ``SystemExit``, persists a crash report, then re-raises."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except BaseException as e:
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            host = _host_index()
            try:
                os.makedirs(crash_dir, exist_ok=True)
                report = {
                    "host": host,
                    "time": time.time(),
                    "fn": getattr(fn, "__name__", str(fn)),
                    "exception": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc(),
                    "argv": sys.argv,
                }
                path = os.path.join(crash_dir, f"host{host}_{int(time.time())}.json")
                with open(path, "w") as f:
                    json.dump(report, f, indent=2)
                print(f"[record] crash report written to {path}", file=sys.stderr)
            except Exception:
                pass  # never mask the original error
            raise

    return wrapper
