"""What every driver shares: the run's context (the cell, its configuration
and traffic files found by name), host spans and CUDA-event timers placed
around the program's calls, the device trace, the gap a comparison reads,
and the judgement of the compared numbers against their limits.

A driver (``drivers/<name>.py``, named by the traffic file's ``driver``)
exposes ``run(bench) -> Outcome``. The harness never names a cell, a
configuration, a traffic mix or a metric in code: ``run.py`` reads them from
``BENCHMARK.json`` and the files under this directory.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# staged weights (the diffusers VAE directory), inside the checkout at a fixed path
STAGE = os.path.join(os.path.dirname(HERE), "build", "sdbench_stage")


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's directory."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's directory, loaded from its
    path (a metric's name holds dots, which ``import`` would read as packages)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"sdbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cli_flags(section: dict) -> List[str]:
    """A configuration section as the port's command-line flags
    (``channels_list`` -> ``--channels-list 320,640,...``)."""
    out = []
    for k, v in section.items():
        out += [f"--{k.replace('_', '-')}", ",".join(map(str, v)) if isinstance(v, list) else str(v)]
    return out


def dtype_of(config: dict) -> torch.dtype:
    """A configuration's compute dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["dtype"]]


@dataclass
class Bench:
    """One run: the cell's entry, its configuration and traffic files, the
    command line's seed, seconds and trace switch, and the device."""

    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    limits: Dict[str, float]
    t_start: float  # perf_counter at process start

    @property
    def dtype(self) -> torch.dtype:
        return dtype_of(self.config)


@dataclass
class Outcome:
    """What a driver hands back: the end-to-end readings, the traced record
    the per-layer readers take, the comparisons, the request counts."""

    end_to_end: Dict[str, float]
    record: Dict[str, Any]
    checks: List[Tuple[str, float]]
    attempted: int
    failed: int
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    notes: Dict[str, Any] = field(default_factory=dict)


class Spans:
    """Host spans (perf_counter) by name, and CUDA-event timers whose device
    milliseconds are summed by name once the run has synchronized."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host: List[Tuple[str, float, float]] = []
        self._events: Dict[str, List[Tuple[Any, Any]]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.host.append((name, t0, time.perf_counter()))

    @contextlib.contextmanager
    def timed(self, name: str):
        """Host span and, on a card, a pair of CUDA events around the block."""
        if self.device.type != "cuda":
            with self.span(name):
                yield
            return
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            with self.span(name):
                yield
        finally:
            end.record()
            self._events.setdefault(name, []).append((start, end))

    def restart(self) -> None:
        """Forget the CUDA-event timers (the window's own start afresh)."""
        self._events.clear()

    def device_ms(self, name: str) -> List[float]:
        """Each timed block's device milliseconds (call after a synchronize)."""
        return [s.elapsed_time(e) for s, e in self._events.get(name, [])]


def rel_gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap, max|a - ref|, over the reference's scale, max|ref|."""
    a, ref = a.float(), ref.float().to(a.device)
    return float((a - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def leaf_gap(prog: List[float], ref: List[float]) -> float:
    """The worst leaf's gap between two lists of norms: |p - r| over the
    larger of r and the median reference norm."""
    ref_t = torch.tensor(ref, dtype=torch.float64)
    med = float(ref_t.median())
    return max(abs(p - r) / max(r, med, 1e-30) for p, r in zip(prog, ref))


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_reserved(device)) if device.type == "cuda" else 0


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def trace_device(fn: Callable[[], Any], device: torch.device) -> dict:
    """Run ``fn`` under the profiler, tracing the card only -> ``kernels``
    [(name, start s, end s)] on the window's clock (0 = the window's start,
    aligned by a marker kernel launched at it), ``window_s`` and ``value``
    (what ``fn`` returned). Only device activities are recorded: with the
    host's operations traced too, the host slows and the idle share grows."""
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":  # nothing to trace: the readers find no kernels
        t0 = time.perf_counter()
        value = fn()
        return {"kernels": [], "window_s": time.perf_counter() - t0, "value": value, "t0": t0}
    sync(device)
    marker = torch.zeros(1, device=device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync(device)
        t0 = time.perf_counter()
        marker.add_(1.0)
        value = fn()
        sync(device)
        window = time.perf_counter() - t0
    events = []
    for e in prof.events():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        tr = e.time_range
        if tr.end > tr.start:
            events.append((e.name, tr.start * 1e-6, tr.end * 1e-6))
    if not events:
        return {"kernels": [], "window_s": window, "value": value, "t0": t0}
    events.sort(key=lambda k: k[1])
    origin = events[0][1]  # the marker, launched at t0
    return {"kernels": [(n, s - origin, e - origin) for n, s, e in events[1:]], "window_s": window,
            "value": value, "t0": t0}


def busy_seconds(kernels: List[Tuple[str, float, float]]) -> float:
    """The length of the union of the kernels' intervals."""
    busy, end = 0.0, float("-inf")
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


CATEGORIES = [
    ("K9 int8 Adam", ("adam8bit",)),
    ("K1 flash attention fwd", ("fa_forward_kernel", "fa_forward_wgmma")),
    ("attention bwd stats pass", ("bwd_stats_wgmma",)),
    ("K4/K5 split attention bwd", ("split_dq_kernel", "split_dkv_kernel", "split_delta_kernel", "split_dq_wgmma",
                                   "split_dkv_wgmma")),
    ("K3 flash attention bwd", ("fused_bwd_wgmma", "dkv_kernel", "delta_kernel", "cast_kernel<")),
    ("K7 GroupNorm bwd", ("gn_bwd_cluster",)),
    ("K6 GroupNorm fwd", ("gn_fwd_cluster",)),
    ("K8 GroupNorm-concat fwd", ("gn_cat_cluster",)),
    ("optimizer and accumulation (foreach)", ("multi_tensor_apply", "foreach")),
    ("conv (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
    ("copies and fills", ("memcpy", "memset", "copy", "fill")),
    ("other elementwise and reductions", ("elementwise", "vectorized", "reduce", "softmax", "norm", "index")),
]


def category(name: str) -> str:
    low = name.lower()
    return next((c for c, keys in CATEGORIES if any(k in low for k in keys)), "other")


def breakdown(traced: dict, spans: List[Tuple[str, float, float]]) -> dict:
    """The ten categories of device operations that took most time, and the
    ten longest idle gaps, each named by the host span open at its start."""
    by_cat: Dict[str, float] = {}
    for name, s, e in traced["kernels"]:
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + (e - s)
    ops = sorted(by_cat.items(), key=lambda kv: -kv[1])[:10]
    t0, gaps, end = traced["t0"], [], 0.0
    for _, s, e in sorted(traced["kernels"], key=lambda k: k[1]):
        if s > end:
            gaps.append((end, s - end))
        end = max(end, e)
    if traced["window_s"] > end:
        gaps.append((end, traced["window_s"] - end))
    named = []
    for at, length in sorted(gaps, key=lambda g: -g[1])[:10]:
        host = t0 + at
        open_spans = [n for n, a, b in spans if a <= host < b]
        named.append([open_spans[-1] if open_spans else "outside any span", length])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def compared(gaps: Dict[str, float], limits: Dict[str, float]) -> List[Tuple[str, float]]:
    """The numbers that have a limit, by name; the rest of ``gaps`` are diagnostics."""
    return [(name, gaps[name]) for name in sorted(limits) if name in gaps]


def within(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limit's number read, and each at most its limit (a NaN fails)."""
    return bool(values) and set(values) == set(limits) and all(v <= limits[k] for k, v in values.items())
