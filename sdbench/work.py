"""The work of a cell's unit (a txt2img call, a training step) at its shapes,
tallied on the reference run on the ``meta`` device: the same work whatever
implements it.

- ``attn_fwd`` / ``attn_bwd``: one (B, H, N, M, D) per attention call of the
  UNet and the VAE (the calls the program sends to its attention kernels;
  the text tower's masked attention is not among them), the backward ones
  for the model that trains.
- ``gn_fwd`` / ``gn_bwd``: one (elements read, elements written) per
  GroupNorm call (a concat's two parts both read), backward likewise.
- ``model_flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the
  reference's forward (and, for training, its backward; no recompute).
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import models as ref_models

META = torch.device("meta")


def _model(kind: str, cfg: dict, trainable: bool = False):
    m = ref_models.build(kind, cfg)  # its parameters are on ``meta`` already
    for p in m.parameters():
        p.requires_grad_(trainable)
    return m


class _Tally:
    """Forward hooks on the attention and GroupNorm modules of ``models``."""

    def __init__(self, models):
        self.attn: List[tuple] = []
        self.gn: List[tuple] = []
        self.handles = []
        for m in models:
            for mod in m.modules():
                if isinstance(mod, (ref_models.CrossAttention, ref_models.VAEAttention)):
                    self.handles.append(mod.register_forward_hook(self._attn))
                elif isinstance(mod, ref_models.GroupNorm):
                    self.handles.append(mod.register_forward_hook(self._gn))

    def _attn(self, mod, args, out):
        x = args[0]
        ctx = args[1] if len(args) > 1 and args[1] is not None else None
        n = x.numel() // (x.shape[0] * x.shape[-1])
        m = n if ctx is None else ctx.shape[1]
        self.attn.append((x.shape[0], mod.n_heads, n, m, mod.d_head))

    def _gn(self, mod, args, out):
        skip = args[1] if len(args) > 1 else None
        self.gn.append((args[0].numel() + (skip.numel() if skip is not None else 0), out.numel()))

    def close(self):
        for h in self.handles:
            h.remove()


def sample_work(cfg: dict, tr: dict) -> Dict:
    """One txt2img call: the text tower over the prompts and the negative
    prompt, ``steps`` UNet calls on the CFG batch, the decode of the batch."""
    b, size, f = tr["batch"], tr["image_size"], 2 ** (len(cfg["vae"]["autoencoder_channels_list"]) - 1)
    h, c = size // f, cfg["vae"]["latent_channels"]
    unet, vae, clip = _model("unet", cfg), _model("vae", cfg), _model("clip", cfg)
    s = cfg["clip"]["max_seq_len"]
    flops = 0.0
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            clip(torch.zeros((b + 1, s), dtype=torch.long, device=META))
        flops += fc.get_total_flops()
        tally = _Tally([unet])
        with FlopCounterMode(display=False) as fc:
            unet(torch.empty((2 * b, h, h, c), device=META), torch.zeros(2 * b, dtype=torch.long, device=META),
                 torch.empty((2 * b, s, cfg["unet"]["context_dim"]), device=META))
        tally.close()
        flops += fc.get_total_flops() * tr["steps"]
        attn, gn = tally.attn * tr["steps"], tally.gn * tr["steps"]
        tally = _Tally([vae])
        with FlopCounterMode(display=False) as fc:
            vae.decode(torch.empty((b, h, h, c), device=META))
        tally.close()
        flops += fc.get_total_flops()
    return {"model_flops": flops, "attn_fwd": attn + tally.attn, "attn_bwd": [], "gn_fwd": gn + tally.gn,
            "gn_bwd": []}


def train_work(cfg: dict, tr: dict) -> Dict:
    """One optimizer step of ``tr["batch"]`` rows of the UNet trainer: the
    frozen text tower and VAE encode, then the UNet's forward and backward."""
    b, size = tr["batch"], tr["image_size"]
    f = 2 ** (len(cfg["vae"]["autoencoder_channels_list"]) - 1)
    c, s = cfg["vae"]["latent_channels"], cfg["clip"]["max_seq_len"]
    img = torch.empty((b, size, size, cfg["vae"]["in_channels"]), device=META)
    clip, vae, unet = _model("clip", cfg), _model("vae", cfg), _model("unet", cfg, trainable=True)
    with torch.no_grad():
        tally = _Tally([vae])
        with FlopCounterMode(display=False) as fc:
            clip(torch.zeros((b, s), dtype=torch.long, device=META))
            vae.encode(img)
        tally.close()
        flops = fc.get_total_flops()
        fwd_attn, fwd_gn = tally.attn, tally.gn
    tally = _Tally([unet])
    with FlopCounterMode(display=False) as fc:
        out = unet(torch.empty((b, size // f, size // f, c), device=META), torch.zeros(b, dtype=torch.long, device=META),
                   torch.empty((b, s, cfg["unet"]["context_dim"]), device=META))
        (out ** 2).mean().backward()
    tally.close()
    flops += fc.get_total_flops()
    return {"model_flops": flops, "attn_fwd": fwd_attn + tally.attn, "attn_bwd": list(tally.attn),
            "gn_fwd": fwd_gn + tally.gn, "gn_bwd": list(tally.gn)}
