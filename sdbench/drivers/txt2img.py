"""Text-to-image, closed loop, one client: back-to-back ``pipeline.sample``
calls on a model from ``models/build.py:build_models`` (its autoencoder the
seed's, staged as a diffusers directory; ``weights.stage_vae``), each with
``batch`` distinct prompts drawn from the seed, the traffic's negative
prompt and one seed per row, through the replayed reverse loop and the whole
VAE decode; nothing is saved.

``images_per_s`` is the images of every call finished in the window over the
window's wall time (the last call ends it). What the timed path produced is
recorded as it runs and checked once the window has closed and the program
is freed (``sampling.py``), on the last call to finish and others drawn
from the seed.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict

import torch

import inputs
import sampling
import weights as bench_weights
import work as bench_work
from harness import STAGE, Bench, Outcome, Spans, breakdown, busy_seconds, compared, peak_bytes, sync, trace_device


def call_inputs(seed: int, index: int, tr: dict):
    """Call ``index``'s prompts and its per-row seeds."""
    gen = inputs.rng(seed, 101, index + (1 << 20))
    return (inputs.prompts(gen, tr["batch"], tr["prompt_letters"], tr["word_letters"]),
            [int(s) for s in gen.integers(0, 1 << 62, tr["batch"])])


def run(bench: Bench, control: bool = False) -> Outcome:
    """The cell's run; ``control`` also reads the control's gaps on the same
    records (``outcome.notes["control"]``), for ``control.py``."""
    from stable_diffusion_pytorch_tpu_torch import pipeline
    from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig, ClipConfig, DDPMConfig, UnetConfig
    from stable_diffusion_pytorch_tpu_torch.models.build import build_models

    cfg, tr, dev, seed = bench.config, bench.traffic, bench.device, bench.seed
    spans = Spans(dev)
    with spans.span("build"):
        bench_weights.stage_vae(cfg, seed, bench.dtype, dev, os.path.join(STAGE, "vae"))
        model = build_models(UnetConfig(**cfg["unet"]), AutoencoderConfig(**cfg["vae"]),
                             ClipConfig(max_seq_len=cfg["clip"]["max_seq_len"], model_dir=None),
                             DDPMConfig(**cfg["ddpm"]), dtype=bench.dtype, device=dev, seed=0, pretrained_dir=STAGE)
        with torch.no_grad():
            for kind, module in (("unet", model.unet), ("clip", model.text_encoder.module)):
                module.load_state_dict(bench_weights.make_state(kind, cfg, seed, bench.dtype, dev), strict=True)
        sync(dev)
    keep = sampling.recorded_steps(seed, tr["steps"])
    tap = sampling.UNetTap(model.unet, tr["steps"], keep)
    sample_loop, decode = model.sample, model.decode_latent
    last = {}

    def timed_loop(*a, **kw):
        with spans.timed("loop"):
            return sample_loop(*a, **kw)

    def tapped_decode(latent, *a, **kw):
        with spans.timed("decode"):
            out = decode(latent, *a, **kw)
        last["latent"], last["image"] = latent.to("cpu", copy=True), out.to("cpu", copy=True)
        return out

    model.sample, model.decode_latent = timed_loop, tapped_decode
    records: Dict[int, dict] = {}

    def call(i: int) -> None:
        prompts, seeds = call_inputs(seed, i, tr)
        with spans.span("call"):
            pipeline.sample(model, image_size=tr["image_size"], prompt=prompts, time_steps=tr["steps"],
                            guidance_scale=tr["guidance_scale"], save_dir=None, sampler=tr["sampler"],
                            eta=tr["eta"], seed=seeds, negative_prompt=tr["negative_prompt"])
        records[i] = {"prompts": prompts, "seeds": seeds, **tap.take(len(prompts)), **last,
                      "done": time.perf_counter()}

    for i in range(tr["warmup_calls"]):  # the capture, then replays
        call(-1 - i)
    records.clear()
    setup_s = time.perf_counter() - bench.t_start

    traced = None
    if bench.trace:
        base = len(records)
        traced = trace_device(lambda: [call(-100 - j) for j in range(tr["trace_calls"])], dev)
        traced["units"] = len(records) - base
    spans.restart()
    t0 = time.perf_counter()
    n = 0
    while True:
        call(n)
        n += 1
        if time.perf_counter() - t0 >= bench.seconds:
            break
    sync(dev)
    window = time.perf_counter() - t0
    memory = peak_bytes(dev)
    loop_ms, decode_ms = spans.device_ms("loop"), spans.device_ms("decode")
    model.sample, model.decode_latent = sample_loop, decode
    del model, tap, sample_loop, decode
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    order = sorted(records, key=lambda i: records[i]["done"])
    sample = [records[order[i]] for i in sampling.checked(seed, tr["checked_calls"], len(order))]
    gaps = sampling.compare(sample, cfg, tr, seed, dev, keep)
    checks = compared(gaps, bench.limits)
    notes = {"gaps": gaps, "latent_absmax": max(float(r["latent"].float().abs().max()) for r in sample)}
    if control:
        notes["control"] = sampling.compare(sample, cfg, tr, seed, dev, keep, control=True)

    record = {"kind": "sample", "config": cfg, "traffic": tr, "loop_ms": loop_ms, "decode_ms": decode_ms,
              "steps": tr["steps"]}
    outcome = Outcome(end_to_end={"images_per_s": tr["batch"] * n / window, "setup_s": setup_s,
                                  "peak_reserved_gb": memory / 1e9},
                      record=record, checks=checks, attempted=len(records), failed=0,
                      memory_peak_bytes=memory, notes=notes)
    if traced is not None:
        record.update(kernels=traced["kernels"], window_s=traced["window_s"], units=traced["units"],
                      work=bench_work.sample_work(cfg, tr))
        outcome.busy_s, outcome.window_s = busy_seconds(traced["kernels"]), traced["window_s"]
        outcome.breakdown = breakdown(traced, spans.host)
    return outcome
