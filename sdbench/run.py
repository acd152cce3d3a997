"""The benchmark of the PyTorch/CUDA port, one cell per run:

    python3 sdbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in ``BENCHMARK.json`` names its
configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``);
the limits of its comparisons are ``limits/<cell>.json`` and each per-layer
metric is read by ``metrics/<metric>.py``. Nothing here names a cell.

The run makes its weights and inputs from ``--seed``, warms every shape the
cell uses (counted in ``setup_s``), measures for ``--seconds``, then checks
what the timed path produced against the plain reference under
``reference/``. With ``--trace 1`` a stretch of the cell's work runs under
the device profiler first, and the result holds the per-layer metrics in
place of the end-to-end ones. The last line of standard output is the
result; the compared numbers and their limits are the last lines of
standard error. The run exits non-zero, printing no result, without enough
CUDA devices, or if the JAX package or JAX was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "stable_diffusion_pytorch_tpu")


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no library loads JAX."""
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    for flag in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[flag] = "0"
    for path in (HERE, ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def _entries(bench: dict, section: str, cell: str) -> list:
    return [m for m in bench[section] if "workloads" not in m or cell in m["workloads"]]


def per_layer_metrics(spec: dict, cell: str, record: dict) -> dict:
    """Each per-layer metric of the cell that its reader (``metrics/<name>.py``) finds."""
    from harness import load_module

    out = {}
    for m in _entries(spec, "per_layer", cell):
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(outcome, metrics: dict, limits: dict, chips: int, kind: str, trace: bool) -> dict:
    """The result object: ``correct`` only when every limit's number was
    read and lies within it and no request failed; the compared numbers come
    last, each beside its limit."""
    from harness import within

    checks = [{"name": n, "value": v, "limit": limits[n]} for n, v in outcome.checks]
    correct = outcome.failed == 0 and within(dict(outcome.checks), limits)
    device = {"platform": "gpu", "kind": kind, "count": chips, "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed, "metrics": metrics,
              "device": device}
    if trace:
        device["busy_s"], device["window_s"] = outcome.busy_s, outcome.window_s
        if outcome.breakdown is not None:
            result["breakdown"] = outcome.breakdown
    result["compared"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from harness import Bench, load_json, load_module

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    traffic = load_json("traffic", cell["traffic"])
    bench = Bench(workload=cell, config=load_json("configs", cell["config"]), traffic=traffic, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace), device=torch.device("cuda", 0),
                  limits=load_json("limits", cell["name"]), t_start=T_START)
    outcome = load_module("drivers", traffic["driver"]).run(bench)

    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded in the benchmark's process: {loaded}", file=sys.stderr)
        return 3

    if args.trace:
        metrics = per_layer_metrics(spec, cell["name"], outcome.record)
    else:
        metrics = {m["name"]: {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in _entries(spec, "end_to_end", cell["name"])}
    result = result_line(outcome, metrics, bench.limits, cell["chips"], torch.cuda.get_device_name(0),
                         bool(args.trace))
    for c in result["compared"]:
        print(f"compared {c['name']} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
