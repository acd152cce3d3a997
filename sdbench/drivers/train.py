"""Training, one process, the trainer's default route (on a card one replayed
CUDA graph an optimizer step): the UNet trainer of ``scripts/train_unet.py``,
built by its CLI's ``build_trainer`` from the configuration's widths and the
traffic's flags (its frozen autoencoder the seed's, staged as a diffusers
directory; ``weights.stage_vae``), fed batches the benchmark makes from the
seed through the trainer's own loop body (``Trainer._micro_steps``: fetch,
place, dispatch, pull), with its ``place`` phase timed by the trainer's
``PhaseTimer``.

Set-up builds the trainer once, loads the weights made from the seed, and
drives it through its first three optimizer steps on rows that all differ;
the window goes on with the same trainer and loop. On the graph route the
first step runs eagerly while the graph is captured and every later step is
a replay. Read on the way: each step's loss, each leaf's gradient as AdamW
took it at each step (from its first moments: m1 / (1 - beta1) at step 1,
(m_k - beta1 m_(k-1)) / (1 - beta1) after), and each leaf's change over the
three steps (against a host copy of the start). ``samples_per_s`` is the
rows of every optimizer step finished in the window over its wall time.

Once the window has closed and the trainer is freed, the reference follows
the same three steps in float32 from the same weights, batches and draws
(it seeds the trainer's per-step generators as the trainer does and draws
in its order): the frozen encoders, the forward, the loss, the backward and
the AdamW update. Compared, by the worst leaf, the gap between the two
sides' norms over the larger of the reference leaf's norm and the median
leaf's: the gradient at step 1 (``grad``, the eager step), the gradient at
steps 2 and 3 (``grad_replayed``, the replays) and the change over the
three steps (``change``). Leaves whose reference gradient at step 1 is
under a thousandth of the median leaf's move by round-off alone and are
left out of the change. The widest relative loss gap over the three steps
(``loss``) is read beside them; ``limits/<cell>.json`` names what is
compared.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import (
    STAGE,
    Bench,
    Outcome,
    Spans,
    breakdown,
    busy_seconds,
    cli_flags,
    compared,
    dtype_of,
    leaf_gap,
    peak_bytes,
    sync,
    trace_device,
)
from reference import diffusion as ref_diffusion
from reference import models as ref_models
from reference import tokenizer as ref_tokenizer
from reference.adamw import AdamW as RefAdamW
from reference.numerics import Prec, exact_f32
import inputs
import weights as bench_weights
import work as bench_work

CHECKED_STEPS = 3


def trainer_seed(seed: int) -> int:
    return bench_weights.derive_seed(seed, 7) % (1 << 31)


def batch_rows(seed: int, index: int, cfg: dict, tr: dict) -> Dict[str, np.ndarray]:
    """Batch ``index`` of the pool: images uniform in [-1, 1] and captions
    tokenized as the reference tokenizes them."""
    gen = inputs.rng(seed, 201, index)
    b, s = tr["batch"], tr["image_size"]
    images = gen.uniform(-1.0, 1.0, (b, s, s, cfg["vae"]["in_channels"])).astype(np.float32)
    captions = inputs.prompts(gen, b, tr["prompt_letters"], tr["word_letters"])
    return {"pixel_values": images,
            "input_ids": ref_tokenizer.tokenize(captions, cfg["clip"]["max_seq_len"]).astype(np.int32)}


def build(bench: Bench):
    """The trainer as its CLI builds it, with the weights made from the seed
    -> (trainer, the UNet, its parameter names)."""
    from stable_diffusion_pytorch_tpu_torch.scripts.train_unet import build_trainer

    cfg, tr, dev = bench.config, bench.traffic, bench.device
    bench_weights.stage_vae(cfg, bench.seed, bench.dtype, dev, os.path.join(STAGE, "vae"))
    ckpt = os.path.join(os.path.dirname(STAGE), "sdbench_ckpt")  # never written: no step saves
    argv = ["--device", dev.type, "--dataset", "synthetic", "--resolution", str(tr["image_size"]),
            "--train-batch-size", str(tr["batch"]), "--gradient-accumulation-steps", "1",
            "--max-train-steps", "1000000", "--log-interval", "0", "--checkpointing-steps", "1000000000",
            "--max-train-samples", str(tr["batch"]), "--max-val-samples", str(tr["batch"]),
            "--ckpt-dir", ckpt, "--model-dir", STAGE, "--seed", str(trainer_seed(bench.seed)),
            *cli_flags(cfg["vae"]), *cli_flags(cfg["unet"]), *cli_flags(cfg["ddpm"]), *tr["flags"]]
    trainer = build_trainer(argv)
    unet, clip = trainer.model.unet, trainer.model.text_encoder.module
    with torch.no_grad():
        unet.load_state_dict(bench_weights.make_state("unet", cfg, bench.seed, torch.float32, dev), strict=True)
        clip.load_state_dict(bench_weights.make_state("clip", cfg, bench.seed, bench.dtype, dev), strict=True)
    names = [n for n, p in unet.named_parameters() if p.requires_grad]
    return trainer, unet, names


def run(bench: Bench, control: bool = False) -> Outcome:
    from stable_diffusion_pytorch_tpu_torch.utils.profiling import PhaseTimer, StepTimer

    cfg, tr, dev, seed = bench.config, bench.traffic, bench.device, bench.seed
    spans = Spans(dev)
    with spans.span("build"):
        trainer, trained, names = build(bench)
        pool = [batch_rows(seed, j, cfg, tr) for j in range(tr["pool_batches"])]
    opt = trainer.state.optimizer
    params = list(opt.params)
    start = [p.detach().to("cpu", copy=True) for p in params]

    def feed():
        j = 0
        while True:
            with spans.span("fetch"):
                batch = pool[j % len(pool)]
            yield batch
            j += 1

    phases = PhaseTimer(warmup=2)
    steps = trainer._micro_steps(feed(), skip_until=-1, micro_step0=0, step_timer=StepTimer(warmup=2),
                                 max_train_steps=10 ** 9, ckpt_steps=None, phases=phases)

    def step():
        with spans.span("step"):
            return next(steps)[0]

    metrics = [step()]
    with torch.no_grad():
        grad_norms = [[float(n) / (1.0 - opt.b1) for n in torch.stack(torch._foreach_norm(opt.mu)).cpu()]]
        prev = [m.to("cpu", copy=True) for m in opt.mu]
    for _ in range(CHECKED_STEPS - 1):  # the replays: each step's gradient from two first moments
        metrics.append(step())
        with torch.no_grad():
            cur = [m.to("cpu", copy=True) for m in opt.mu]
            grad_norms.append([float(torch.linalg.vector_norm(torch.sub(c, p, alpha=opt.b1))) / (1.0 - opt.b1)
                               for c, p in zip(cur, prev)])
        prev = cur
    del prev, cur
    with torch.no_grad():
        change_norms = [float(torch.linalg.vector_norm(p.detach() - s.to(p.device))) for p, s in zip(params, start)]
    del start
    setup_s = time.perf_counter() - bench.t_start

    traced, n_traced = None, 0
    if bench.trace:
        traced = trace_device(lambda: [step() for _ in range(tr["trace_steps"])], dev)
        traced["units"] = tr["trace_steps"]
        n_traced = tr["trace_steps"]
    phases.samples.clear()
    t0 = time.perf_counter()
    n = 0
    while True:
        step()
        n += 1
        if time.perf_counter() - t0 >= bench.seconds:
            break
    sync(dev)
    window = time.perf_counter() - t0
    memory = peak_bytes(dev)
    place_ms = phases.summary_ms().get("place_ms_p50")
    steps.close()
    del steps, trainer, trained, opt, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    program = {"loss": [float(m["loss"]) for m in metrics], "grad": grad_norms, "change": change_norms}
    ref = reference_steps(cfg, tr, seed, dev, names)
    gaps = readings(program, ref)
    checks = compared(gaps, bench.limits)
    notes = {"gaps": gaps, "losses": program["loss"], "ref_losses": ref["loss"]}
    if control:
        notes["control"] = readings(reference_steps(cfg, tr, seed, dev, names, fp8=True), ref)
        notes["faults"] = {f: readings(reference_steps(cfg, tr, seed, dev, names, fault=f), ref)
                           for f in ("half_batch", "altered")}

    record = {"kind": "train", "config": cfg, "traffic": tr, "place_ms_p50": place_ms}
    outcome = Outcome(end_to_end={"samples_per_s": tr["batch"] * n / window, "setup_s": setup_s,
                                  "peak_reserved_gb": memory / 1e9},
                      record=record, checks=checks, attempted=n + n_traced + CHECKED_STEPS, failed=0,
                      memory_peak_bytes=memory, notes=notes)
    if traced is not None:
        record.update(kernels=traced["kernels"], window_s=traced["window_s"], units=traced["units"],
                      work=bench_work.train_work(cfg, tr))
        outcome.busy_s, outcome.window_s = busy_seconds(traced["kernels"]), traced["window_s"]
        outcome.breakdown = breakdown(traced, spans.host)
    return outcome


def readings(side: dict, ref: dict) -> Dict[str, float]:
    """The numbers of one side against the reference: the widest relative
    loss gap over the steps, and the worst leaf's gradient gap at step 1,
    at steps 2 and 3, and change gap."""
    med = float(np.median(ref["grad"][0]))
    moving = [i for i, g in enumerate(ref["grad"][0]) if g >= 1e-3 * med]
    return {"loss": max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(side["loss"], ref["loss"])),
            "grad": leaf_gap(side["grad"][0], ref["grad"][0]),
            "grad_replayed": max(leaf_gap(p, r) for p, r in zip(side["grad"][1:], ref["grad"][1:])),
            "change": leaf_gap([side["change"][i] for i in moving], [ref["change"][i] for i in moving])}


def _step_generator(dev, seed: int, micro: int) -> torch.Generator:
    """The trainer's per-step generator: seeded with SeedSequence([0, seed,
    micro step]), its first 64-bit word shifted right once."""
    s = int(np.random.SeedSequence([0, seed, micro]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=dev).manual_seed(s)


def reference_steps(cfg: dict, tr: dict, seed: int, dev, names: List[str], fp8: bool = False,
                    fault: Optional[str] = None) -> dict:
    """Three AdamW steps of the float32 reference (``fp8``: the control) from
    the seed's weights on the first three batches -> each step's loss, each
    leaf's clipped gradient norm at each step and change norm after step 3,
    in the program's leaf order. ``fault`` plants one in the reference:
    "half_batch" (the loss the mean over the first half of the rows) or
    "altered" (row 0's prediction negated where it is produced)."""
    prec = Prec(fp8=fp8)
    frozen_dtype = dtype_of(cfg)
    model = ref_models.load(ref_models.build("unet", cfg, prec),
                            bench_weights.make_state("unet", cfg, seed, torch.float32, dev), trainable=True)
    by_name = dict(model.named_parameters())
    params = [by_name[n] for n in names]
    vae = ref_models.load(ref_models.build("vae", cfg, prec),
                          bench_weights.make_state("vae", cfg, seed, frozen_dtype, dev))
    clip = ref_models.load(ref_models.build("clip", cfg, prec),
                           bench_weights.make_state("clip", cfg, seed, frozen_dtype, dev))
    abar = ref_diffusion.alpha_bar(cfg["ddpm"])
    uncond = torch.from_numpy(ref_tokenizer.tokenize([""], cfg["clip"]["max_seq_len"])).to(dev)
    opt = RefAdamW(params, tr["optim"], total_steps=1_000_000)
    f = 2 ** (len(cfg["vae"]["autoencoder_channels_list"]) - 1)
    tseed, rows = trainer_seed(seed), tr["ref_rows"]
    losses, grad_norms = [], []
    with exact_f32():
        for m in range(CHECKED_STEPS):
            host = batch_rows(seed, m, cfg, tr)
            img = torch.from_numpy(host["pixel_values"]).to(dev)
            b, s = img.shape[0], img.shape[1]
            latent_shape = (b, s // f, s // f, cfg["vae"]["latent_channels"])
            g = _step_generator(dev, tseed, m)
            for p in params:
                p.grad = None
            total = 0.0
            used_rows = b // 2 if fault == "half_batch" else b
            eps = torch.randn(latent_shape, generator=g, device=dev)
            noise = torch.randn(latent_shape, generator=g, device=dev)
            t = torch.randint(0, cfg["ddpm"]["noise_steps"], (b,), generator=g, device=dev)
            drop = torch.rand((b,), generator=g, device=dev) < tr["cfg_dropout_prob"]
            ids = torch.from_numpy(host["input_ids"]).long().to(dev)
            ids = torch.where(drop[:, None], uncond.expand_as(ids), ids)
            for r in range(0, used_rows, rows):
                sl = slice(r, min(r + rows, used_rows))
                with torch.no_grad():
                    mean, log_var = vae.encode(img[sl])
                    z = prec.out(mean + eps[sl] * torch.exp(0.5 * log_var))
                    ctx = prec.out(clip(ids[sl]))
                    x_t = prec.out(ref_diffusion.q_sample(abar, z, noise[sl], t[sl]))
                pred = model(x_t, t[sl], ctx)
                if fault == "altered" and r == 0:  # row 0 of the step negated
                    pred = torch.cat([-pred[:1], pred[1:]])
                part = ref_diffusion.eps_sq_sum(pred, noise[sl]) / noise[:used_rows].numel()
                part.backward()
                total += float(part.detach())
            losses.append(total)
            used = opt.step([p.grad if p.grad is not None else torch.zeros_like(p) for p in params])
            grad_norms.append([float(x) for x in used])
    start = bench_weights.make_state("unet", cfg, seed, torch.float32, dev)
    with torch.no_grad():
        change = [float(torch.linalg.vector_norm(by_name[n].detach() - start[n])) for n in names]
    return {"loss": losses, "grad": grad_norms, "change": change}
