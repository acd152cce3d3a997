"""Build and load the CUDA C++ kernels; count kernel launches.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use (never at import), from the sources in the checkout, into ``build/``
at the repository root, keyed by a hash of the sources so an edit rebuilds. Triton's kernel cache goes under ``build/`` too. Nothing here falls
back: a missing ``nvcc`` or a failed build raises.
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
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
TRITON_CACHE_DIR = BUILD_DIR / "triton"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC",
]


def import_triton():
    """Import triton with its kernel cache under ``build/`` (not ``$HOME``)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(TRITON_CACHE_DIR))
    import triton

    return triton


class LaunchCounter:
    """Counts one kernel's launches, in all and by launch shape.

    A wrapper calls :meth:`hit` once per kernel launch, after the launch
    succeeded, and nowhere else: the plain CPU path does not count."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.shapes: Dict[Tuple, int] = collections.Counter()

    def hit(self, key: Tuple) -> None:
        self.count += 1
        self.shapes[key] += 1

    def reset(self) -> None:
        self.count = 0
        self.shapes = collections.Counter()


COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    COUNTERS[name] = LaunchCounter(name)
    return COUNTERS[name]


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


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
    fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i] + [ll] * 12 + [f, p]
    fn.restype = ctypes.c_int
    fn = lib.sd_flash_attention_backward
    fn.argtypes = [i] + [p] * 11 + [i] * 5 + [ctypes.POINTER(ll), f, p]
    fn.restype = ctypes.c_int
    fn = lib.sd_flash_attention_backward_split
    fn.argtypes = [i] + [p] * 10 + [i] * 5 + [ctypes.POINTER(ll), f, p]
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
