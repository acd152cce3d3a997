"""The comparison that decides ``correct``, shown to fail: each cell's run at
a tiny float32 size on the CPU, past the harness's look for a card, comes
out correct as it is, and not correct with the control in the program's
place or with the timed path broken underneath (each fault a cell can have
on one card: a step that returns its state unchanged, half of the batch left
out, an answer altered where it is produced), judged by the cell's own
limits (``limits/<cell>.json``).

At the cell's own size the control runs on the card: ``python3
sdbench/control.py --workload <cell> --seeds a,b,c``."""

import json
import os
import time

import pytest
import torch

import harness
import run as bench_run

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
TINY = {**json.load(open(os.path.join(HERE, "tiny.json"))), "dtype": "float32"}
SMALL = {"sd15.txt2img-512-b4": dict(batch=2, image_size=32, steps=4, warmup_calls=1, checked_calls=2),
         "sd15.train-512-b8": dict(batch=2, image_size=32, ref_rows=1, pool_batches=4)}


def _workloads():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return {c["name"]: c for c in json.load(f)["workloads"]}


def _cells(driver):
    return [n for n, c in _workloads().items() if harness.load_json("traffic", c["traffic"])["driver"] == driver]


def _run(cell_name, control=False):
    cell = _workloads()[cell_name]
    traffic = {**harness.load_json("traffic", cell["traffic"]), **SMALL[cell_name]}
    bench = harness.Bench(workload=cell, config=TINY, traffic=traffic, seed=2 ** 35 + 11, seconds=2.0, trace=False,
                          device=torch.device("cpu"), limits=harness.load_json("limits", cell_name),
                          t_start=time.perf_counter())
    out = harness.load_module("drivers", traffic["driver"]).run(bench, control=control)
    line = bench_run.result_line(out, {}, bench.limits, 1, "cpu", trace=False)
    return line, out


def _broken(monkeypatch, fault, trainer):
    from stable_diffusion_pytorch_tpu_torch.models import schedule
    from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel
    from stable_diffusion_pytorch_tpu_torch.trainers import optim
    from stable_diffusion_pytorch_tpu_torch.trainers.trainer import Trainer

    if fault == "unchanged":
        if trainer:
            monkeypatch.setattr(optim.AdamW, "_update_leaves", lambda self, *a, **k: None)
        else:
            monkeypatch.setattr(schedule, "ddim_step", lambda sched, eps, x, *a, **k: (x, x))
            monkeypatch.setattr(schedule, "dpmpp_2m_step", lambda sched, eps, x, *a, **k: (x, x))
    elif fault == "half_batch":
        if trainer:  # the trainer places the first half of each batch's rows and trains on those
            place = Trainer._place_batch
            monkeypatch.setattr(Trainer, "_place_batch", lambda self, batch: {
                k: v[: v.shape[0] // 2] for k, v in place(self, batch).items()})
        else:
            fwd = UNetModel.forward

            def half(self, x, t, context=None, **kw):
                h = x.shape[0] // 2
                out = fwd(self, x[:h], t[:h], None if context is None else context[:h], **kw)
                return torch.cat([out, out])

            monkeypatch.setattr(UNetModel, "forward", half)
    else:  # an answer altered where it is produced: row 0 of the UNet's output negated
        forward = UNetModel.forward

        def altered(self, *a, **k):
            out = forward(self, *a, **k)
            return torch.cat([-out[:1], out[1:]])

        monkeypatch.setattr(UNetModel, "forward", altered)


@pytest.mark.parametrize("cell", _cells("txt2img"))
def test_sampling_cell_passes_as_it_is_and_fails_under_the_control(cell):
    line, out = _run(cell, control=True)
    assert line["correct"] is True, line["compared"]
    limits = harness.load_json("limits", cell)
    assert not harness.within({k: out.notes["control"][k] for k in limits}, limits)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", _cells("txt2img"))
def test_sampling_cell_fails_with_the_timed_path_broken(cell, fault, monkeypatch):
    _broken(monkeypatch, fault, trainer=False)
    line, _ = _run(cell)
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("cell", _cells("train"))
def test_training_cell_passes_as_it_is_and_fails_under_the_control(cell):
    line, out = _run(cell, control=True)
    assert line["correct"] is True, line["compared"]
    limits = harness.load_json("limits", cell)
    assert not harness.within({k: out.notes["control"][k] for k in limits}, limits)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", _cells("train"))
def test_training_cell_fails_with_the_timed_path_broken(cell, fault, monkeypatch):
    _broken(monkeypatch, fault, trainer=True)
    line, _ = _run(cell)
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("cell", _cells("train"))
def test_training_cell_fails_with_half_the_batch_left_out_after_the_first_step(cell):
    """On the card the first step runs eagerly and the later ones replay its
    graph: a fault there leaves step 1's gradient sound and is read in the
    gradients of steps 2 and 3."""
    import control

    with control.replayed_half_batch():
        line, out = _run(cell)
    limits = harness.load_json("limits", cell)
    assert line["correct"] is False, line["compared"]
    assert out.notes["gaps"]["grad"] <= limits["grad"] and out.notes["gaps"]["grad_replayed"] > limits["grad_replayed"]
