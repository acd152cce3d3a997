"""Build and load the CUDA C++ kernels; count kernel launches.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use (never at import), from the sources in the checkout, into ``build/``
at the repository root, keyed by a hash of the sources so an edit rebuilds.
Nothing here falls back: a missing ``nvcc`` or a failed build raises.

Launches under CUDA graph capture are recorded, not launched: a wrapper's
``hit`` during capture goes to the counter's ``captured`` tally, which
:func:`end_capture` hands to the graph; each replay of the graph adds that
tally to ``replays`` (:func:`add_replays`). ``count`` stays the launches
made by the host's calls, ``count + replays`` is every launch.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC",
]


class LaunchCounter:
    """Counts one kernel's launches, in all, by launch shape and, where a
    source holds more than one implementation, by the one the launch ran
    (the attention kernels: ``"wgmma"`` on the tensor cores for bf16,
    ``"fma"`` for f32, as the C entry point reports it).

    A wrapper calls :meth:`hit` once per kernel launch, after the launch
    succeeded, and nowhere else: the plain CPU path does not count. Under
    CUDA graph capture the launch is only recorded: it goes to ``captured``
    (by launch shape), and ``replays`` counts the launches that replays of a
    captured graph made (:func:`add_replays`)."""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def hit(self, key: Tuple, impl: Optional[str] = None) -> None:
        if torch.cuda.is_current_stream_capturing():
            self.captured[key] += 1
            return
        self.count += 1
        self.shapes[key] += 1
        if impl is not None:
            self.impls[impl] += 1

    def reset(self) -> None:
        self.count = 0
        self.shapes: Dict[Tuple, int] = collections.Counter()
        self.impls: Dict[str, int] = collections.Counter()
        self.captured: Dict[Tuple, int] = collections.Counter()
        self.replays = 0
        self.replay_shapes: Dict[Tuple, int] = collections.Counter()


COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    COUNTERS[name] = LaunchCounter(name)
    return COUNTERS[name]


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


_AFTER_CAPTURE: List[Callable[[], None]] = []


def after_capture(fn: Callable[[], None]) -> None:
    """Run ``fn`` once the current capture has ended (:func:`end_capture`):
    host-to-device work a wrapper needs for the graph that capture itself
    cannot hold."""
    _AFTER_CAPTURE.append(fn)


def begin_capture() -> None:
    """Before a capture: drop launches recorded under an earlier capture that
    no graph took, and its pending work."""
    _AFTER_CAPTURE.clear()
    for c in COUNTERS.values():
        c.captured = collections.Counter()


def end_capture(ok: bool = True) -> Dict[str, Dict[Tuple, int]]:
    """After a capture: run the wrappers' pending work (only when it
    succeeded) -> the launches recorded under it, {counter: {launch shape:
    n}}, which each replay of the graph makes."""
    pending = list(_AFTER_CAPTURE)
    _AFTER_CAPTURE.clear()
    if ok:
        for fn in pending:
            fn()
    tally = {}
    for name, c in COUNTERS.items():
        if c.captured:
            tally[name] = dict(c.captured)
        c.captured = collections.Counter()
    return tally


def add_replays(tally: Dict[str, Dict[Tuple, int]], replays: int = 1) -> None:
    """Count ``replays`` replays of a graph whose capture recorded ``tally``."""
    for name, keys in tally.items():
        c = COUNTERS[name]
        for key, n in keys.items():
            c.replays += n * replays
            c.replay_shapes[key] += n * replays


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn = lib.sd_flash_attention_forward
    fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i] + [ll] * 12 + [f, p, ctypes.POINTER(i)]
    fn.restype = ctypes.c_int
    fn = lib.sd_flash_attention_backward
    fn.argtypes = [i] + [p] * 12 + [i] * 5 + [ctypes.POINTER(ll), f, p, ctypes.POINTER(i)]
    fn.restype = ctypes.c_int
    fn = lib.sd_flash_attention_backward_split
    fn.argtypes = [i] + [p] * 10 + [i] * 5 + [ctypes.POINTER(ll), f, p, ctypes.POINTER(i)]
    fn.restype = ctypes.c_int
    fn = lib.sd_group_norm_forward
    fn.argtypes = [i] + [p] * 7 + [i] * 10 + [ll, i, f, p]
    fn.restype = ctypes.c_int
    fn = lib.sd_group_norm_backward
    fn.argtypes = [i] + [p] * 13 + [i] * 10 + [ll, i, p]
    fn.restype = ctypes.c_int
    fn = lib.sd_adam8bit_step
    fn.argtypes = [i, p, p, ll, p, p, p] + [f] * 7 + [i, p]
    fn.restype = ctypes.c_int


def _run(cmds) -> None:
    """Run the commands in parallel; raise with the output of the first failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256()
    for path in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libsd_kernels_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        obj_dir = BUILD_DIR / f"obj_{digest.hexdigest()[:16]}_{os.getpid()}"
        obj_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        objs = [obj_dir / f"{src.stem}.o" for src in sources]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for src, o in zip(sources, objs)])
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
        shutil.rmtree(obj_dir, ignore_errors=True)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    return lib
