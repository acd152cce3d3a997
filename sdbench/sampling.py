"""The check of a sampling cell (the txt2img driver's).

What the timed path produced is recorded as it runs. ``UNetTap`` wraps the
UNet's forward: at a few steps of every reverse loop (``recorded_steps``) it
copies the UNet's input latents (the CFG batch's first half), its raw output
and, at the first step, the text context into buffers made at the loop's
first, eager, call; on a card these copies are captured into the loop's CUDA
graph and repeat at every replay, each batch size into its own buffers. The
driver also keeps each batch's prompts, seeds, the loop's x_0 and the
decoded image.

``compare`` then follows the program stage by stage from its own state (the
loop runs as one graph, so its state between the recorded steps is not
seen), against the float32 reference: the start (x_T, drawn again from each
row's seed as the pipeline draws it), the text context (the reference
tokenizes and encodes the prompts itself), the UNet's raw output at each
recorded step, the sampler's update (guidance and DDIM or DPM-Solver++(2M))
of each recorded step whose successor is recorded, and the decode of x_0.
With ``control`` the reference at float8 takes the program's place on the
same states: every product's inputs in float8, and the update's operations
each rounded to float8 in the program's order.

Each number is the widest gap over the reference's scale (``harness.rel_gap``),
so a fault confined to a few rows or pixels shows; the root-mean-square gap
is kept beside each as a diagnostic.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

import inputs
import weights as bench_weights
from harness import dtype_of, rel_gap
from reference import diffusion as ref_diffusion
from reference import models as ref_models
from reference import tokenizer as ref_tokenizer
from reference.numerics import Prec, exact_f32


def recorded_steps(seed: int, steps: int) -> List[int]:
    """The loop steps the tap keeps: the first three, three in a row drawn
    from the seed, and the last two (a second-order update needs the step
    before it)."""
    k = int(inputs.rng(seed, 102).integers(3, max(steps - 3, 4)))
    return sorted({0, 1, 2, k - 1, k, k + 1, steps - 2, steps - 1} & set(range(steps)))


def checked(seed: int, count: int, finished: int) -> List[int]:
    """Which of ``finished`` units (calls or batches, in the order they
    finished) the reference checks: the last, and others drawn from the seed."""
    if not finished:
        return []
    rest = list(range(finished - 1))
    picked = inputs.rng(seed, 103).choice(rest, min(count - 1, len(rest)), replace=False) if rest else []
    return sorted({finished - 1, *map(int, picked)})


class UNetTap:
    """Wraps the UNet's forward (see the module docstring)."""

    def __init__(self, unet, steps: int, keep: List[int]):
        self.orig, self.steps, self.keep = unet.forward, steps, keep
        self.calls = 0
        self.buf: Dict[int, Dict[str, torch.Tensor]] = {}
        unet.forward = self

    def __call__(self, x, t, context=None, **kw):
        out = self.orig(x, t, context, **kw)
        k = self.calls % self.steps
        self.calls += 1
        if k in self.keep:
            half = x.shape[0] // 2
            if half not in self.buf:
                self.buf[half] = {"context": torch.empty_like(context)}
                for j in self.keep:
                    self.buf[half][f"in{j}"] = torch.empty_like(x[:half])
                    self.buf[half][f"eps{j}"] = torch.empty_like(out)
            buf = self.buf[half]
            buf[f"in{k}"].copy_(x[:half])
            buf[f"eps{k}"].copy_(out)
            if k == 0:
                buf["context"].copy_(context)
        return out

    def take(self, batch: int) -> Dict[str, torch.Tensor]:
        """Host copies of the last loop's records at ``batch`` rows."""
        return {k: v.to("cpu", copy=True) for k, v in self.buf[batch].items()}


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return Prec(fp8=True).q(x)


def _fp8_update(sampler, abar, x, eps_raw, x0_last, b, g, t, t_prev, t_last):
    """The control's guidance and update: the program's operations in their
    order, each result rounded to float8 -> (x_prev, x0)."""
    q = _fp8
    u, c = q(eps_raw[:b]), q(eps_raw[b:])
    eps = q(u + q(g * q(c - u)))
    a_t = float(abar[t])
    a_prev = float(abar[t_prev]) if t_prev >= 0 else 1.0
    x0 = q(q(a_t ** -0.5 * q(x)) - q((1.0 / a_t - 1.0) ** 0.5 * eps))
    if sampler == "ddim":
        return q(q(a_prev ** 0.5 * x0) + q((1.0 - a_prev) ** 0.5 * eps)), x0
    lam = ref_diffusion.half_log_snr(abar, t)
    h = ref_diffusion.half_log_snr(abar, t_prev) - lam
    d = x0
    if t_last is not None:
        coef = 0.5 * h / (lam - ref_diffusion.half_log_snr(abar, t_last))
        d = q(q((1.0 + coef) * x0) - q(coef * q(x0_last)))
    ratio = ((1.0 - a_prev) / (1.0 - a_t)) ** 0.5
    return q(q(ratio * q(x)) + q(a_prev ** 0.5 * -math.expm1(-h) * d)), x0


@torch.no_grad()
def compare(records: List[dict], cfg: dict, sampling: dict, seed: int, dev, keep: List[int],
            control: bool = False) -> Dict[str, float]:
    """Each number's widest reading over ``records`` (each a batch: its
    "prompts", "seeds", the tap's records, "latent" and "image"), the
    program's against the float32 reference, or with ``control`` the float8
    reference's. ``sampling``: "sampler" (ddim or dpmpp), "steps",
    "guidance_scale", "negative_prompt"."""
    prec = Prec()
    models = {kind: ref_models.load(ref_models.build(kind, cfg, prec),
                                    bench_weights.make_state(kind, cfg, seed, dtype_of(cfg), dev))
              for kind in ("unet", "vae", "clip")}
    abar = ref_diffusion.alpha_bar(cfg["ddpm"])
    ts = ref_diffusion.sampling_timesteps(cfg["ddpm"]["noise_steps"], sampling["steps"])
    g, sampler = sampling["guidance_scale"], sampling["sampler"]
    gaps: Dict[str, float] = {}

    def put(name, side, ref):
        side, ref = side.float().to(ref.device), ref.float()
        gaps[name] = max(gaps.get(name, 0.0), rel_gap(side, ref))
        rms = float((side - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt().clamp_min(1e-30))
        gaps[name + "_rms"] = max(gaps.get(name + "_rms", 0.0), rms)

    def both(fn):
        """(the reference's output, the control's or None)."""
        prec.fp8 = False
        ref = fn()
        if not control:
            return ref, None
        prec.fp8 = True
        try:
            return ref, fn()
        finally:
            prec.fp8 = False

    def combined(rec, k, b):
        eps = rec[f"eps{k}"].to(dev).float()
        return ref_diffusion.cfg(eps[:b], eps[b:], g)

    with exact_f32():
        for rec in records:
            b = len(rec["prompts"])
            ids = torch.from_numpy(ref_tokenizer.tokenize([sampling["negative_prompt"]] + rec["prompts"])).to(dev)
            shape = (1,) + tuple(rec["in0"].shape[1:])
            noise = torch.cat([torch.randn(shape, generator=torch.Generator().manual_seed(s), dtype=torch.float32)
                               for s in rec["seeds"]])
            put("start", _fp8(noise) if control else rec["in0"], noise)
            ref_ctx, ctl_ctx = both(lambda: models["clip"](ids))
            uncond = [c[:1].expand(b, -1, -1) for c in (ref_ctx, ctl_ctx) if c is not None]
            put("context", torch.cat([uncond[1], ctl_ctx[1:]]) if control else rec["context"],
                torch.cat([uncond[0], ref_ctx[1:]]))
            ctx = rec["context"].to(dev)
            for k in keep:
                x = rec[f"in{k}"].to(dev)
                t = torch.full((2 * b,), ts[k], dtype=torch.long, device=dev)
                ref_eps, ctl_eps = both(lambda: models["unet"](torch.cat([x, x]), t, ctx))
                put("unet", ctl_eps if control else rec[f"eps{k}"], ref_eps)
                last = k + 1 == len(ts)
                second = sampler == "dpmpp" and k > 0
                if not (last or k + 1 in keep) or (second and k - 1 not in keep):
                    continue
                t_prev = -1 if last else ts[k + 1]
                x0_last = t_last = None
                if second:  # the previous step's data prediction, from the program's own state
                    t_last = ts[k - 1]
                    x_last = rec[f"in{k - 1}"].to(dev).float()
                    a_last = float(abar[t_last])
                    x0_last = (x_last - (1.0 - a_last) ** 0.5 * combined(rec, k - 1, b)) / a_last ** 0.5
                if sampler == "ddim":
                    ref_x = ref_diffusion.ddim_step(abar, x, combined(rec, k, b), ts[k], t_prev)
                else:
                    ref_x, _ = ref_diffusion.dpmpp_2m_step(abar, x, combined(rec, k, b), x0_last, ts[k], t_prev,
                                                           t_last)
                if control:
                    side, _ = _fp8_update(sampler, abar, x, rec[f"eps{k}"].to(dev).float(), x0_last, b, g, ts[k],
                                          t_prev, t_last)
                else:
                    side = rec["latent"] if last else rec[f"in{k + 1}"]
                put("update", side, ref_x)
            x0 = rec["latent"].to(dev)
            ref_img, ctl_img = both(lambda: torch.cat([models["vae"].decode(x0[j:j + 1]) for j in range(b)]))
            side = ctl_img if control else rec["image"]
            put("decode", side, ref_img)
    return gaps
