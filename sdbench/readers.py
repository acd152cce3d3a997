"""What the per-layer metric files share: the traced record's device time
by kernel name, its busy share, and the roofline share of a set of kernels.

A traced record (``harness.trace_device`` plus the driver's additions) holds
``kernels`` [(name, start s, end s)], ``window_s``, ``units`` (the cell's
units of work traced), ``work`` (``work.py``'s tallies for one unit) and the
driver's spans. A reader that finds nothing to read returns None, and the
metric is left out of the result.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

from harness import busy_seconds
from peaks import BF16_FLOPS, bound_s


def kernel_seconds(rec: dict, names: Sequence[str]) -> float:
    """Device seconds of the kernels whose name holds any of ``names``."""
    return sum(e - s for n, s, e in rec.get("kernels", ()) if any(k in n for k in names))


def idle_share(rec: dict) -> Optional[float]:
    """% of the traced window in which no operation ran on the device (the
    union of the operations' intervals, so overlapping kernels count once)."""
    if not rec.get("kernels") or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - busy_seconds(rec["kernels"]) / rec["window_s"])


def model_flops_share(rec: dict) -> Optional[float]:
    """% of the bf16 peak: the reference's model FLOPs of the traced units
    over the traced window's wall time."""
    if not rec.get("kernels") or not rec.get("units") or "work" not in rec:
        return None
    return 100.0 * rec["work"]["model_flops"] * rec["units"] / rec["window_s"] / BF16_FLOPS


def roofline_share(rec: dict, names: Sequence[str], calls: Callable[[dict], Iterable[tuple]]) -> Optional[float]:
    """% : the least time the card could take for ``calls(work)`` (each a
    (FLOPs, bytes) pair of one unit) times the traced units, over the device
    time of the kernels named ``names``."""
    spent = kernel_seconds(rec, names)
    if spent <= 0 or not rec.get("units") or "work" not in rec:
        return None
    least = sum(bound_s(f, b) for f, b in calls(rec["work"])) * rec["units"]
    return 100.0 * least / spent


def attn_fwd(b, h, n, m, d, train: bool):
    """Forward attention: 4 B H N M D FLOPs; q, k, v read and o written in
    bf16, and in training the f32 log-sum-exp rows written too."""
    return 4.0 * b * h * n * m * d, 2.0 * b * h * d * (2 * n + 2 * m) + (4.0 * b * h * n if train else 0.0)


def attn_bwd(b, h, n, m, d):
    """Backward attention: 10 B H N M D FLOPs (the scores recomputed, dV,
    dP, dQ, dK); q, k, v, o, dO and the log-sum-exp read, dQ, dK, dV written."""
    return 10.0 * b * h * n * m * d, 2.0 * b * h * d * (4 * n + 4 * m) + 4.0 * b * h * n


def gn_fwd(n_in, n_out):
    """GroupNorm forward: each bf16 input element read once, each output written once."""
    return 0.0, 2.0 * (n_in + n_out)


def gn_bwd(n_in, n_out):
    """GroupNorm backward: x and dY read, dX written, bf16."""
    return 0.0, 2.0 * (2 * n_in + n_out)
