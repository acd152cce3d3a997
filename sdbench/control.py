"""The control and the readings the limits of a cell are set from, on the card
at the cell's own size, all seeds in one process:

    python3 sdbench/control.py --workload <cell> --seeds 11,12,13 --seconds 5 [--fault F] [--out FILE]

For each seed it runs the cell as ``run.py`` does (a short window) and prints
one JSON line: the program's gap for every compared number and, beside it,
the control's: the plain reference put in the program's place one precision
below the configuration's (float8 e4m3 for bfloat16; ``reference/numerics.py``),
read on the same records; for a training cell also the readings of two
faults planted in the reference (half of the batch left out, one row's
answer altered). The limits in ``limits/<cell>.json`` lie between the
program's largest reading and the smallest upper reading.

With ``--fault replayed_half_batch`` the fault is planted in the program
instead (``replayed_half_batch``) and each line holds the run's ``correct``
and its compared numbers.
"""

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import run as bench_run  # noqa: E402


@contextlib.contextmanager
def replayed_half_batch():
    """The training step's loss taken over the first half of the batch's rows
    from the step's second trace on: on the graph route the first step runs
    eagerly and the captured graph, which every later step replays, holds the
    fault; eagerly every step after the first holds it."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.trainers import steps

    mse, calls = steps._mse, [0]

    def half(pred, target, *args, **kwargs):
        calls[0] += 1
        if calls[0] == 1:
            return mse(pred, target, *args, **kwargs)
        h = pred.shape[0] // 2
        args = [a[:h] if isinstance(a, torch.Tensor) else a for a in args]
        return mse(pred[:h], target[:h], *args, **kwargs)

    steps._mse = half
    try:
        yield
    finally:
        steps._mse = mse


FAULTS = {"replayed_half_batch": replayed_half_batch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench_run._environment()
    import torch

    from harness import Bench, load_json, load_module

    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        cell = {w["name"]: w for w in json.load(f)["workloads"]}[args.workload]
    traffic = load_json("traffic", cell["traffic"])
    driver = load_module("drivers", traffic["driver"])
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        bench = Bench(workload=cell, config=load_json("configs", cell["config"]), traffic=traffic, seed=seed,
                      seconds=args.seconds, trace=False, device=torch.device("cuda", 0),
                      limits=load_json("limits", cell["name"]), t_start=time.perf_counter())
        if args.fault:
            with FAULTS[args.fault]():
                out = driver.run(bench)
            line = {"seed": seed, "fault": args.fault, "program": out.notes.pop("gaps"),
                    **bench_run.result_line(out, {}, bench.limits, 1, "", trace=False)}
        else:
            out = driver.run(bench, control=True)
            line = {"seed": seed, "program": out.notes.pop("gaps"), "control": out.notes.pop("control"),
                    "faults": out.notes.pop("faults", None), "notes": out.notes, "end_to_end": out.end_to_end}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
