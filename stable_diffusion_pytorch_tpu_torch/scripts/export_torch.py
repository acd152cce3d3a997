"""Export a port checkpoint in the PyTorch reference's ``.pt`` format (counterpart of tools/export_torch.py).

    python -m stable_diffusion_pytorch_tpu_torch.scripts.export_torch --checkpoint ckpt --export-model unet \\
        --output unet_export.pt [the training run's model flags]
    python -m stable_diffusion_pytorch_tpu_torch.scripts.export_torch --checkpoint ckpt_vae --export-model vae

The port's UNet and VAE carry the reference's parameter names, so the export
is the checkpoint's parameters (the EMA weights where the run kept them, as
``load_params_for_inference`` picks; a checkpoint root resolves to its newest
``checkpoint-N``), loaded ``strict=True`` into the port's ``UNetModel`` /
``AutoEncoderKL`` built from the model flags on ``--device``, then written as
a float32 state dict of contiguous tensors (``torch.save``) that loads
``strict=True`` into the reference's modules and into the port's. Prints one
JSON line: ``{"exported", "checkpoint", "output", "model"}``. ``--device``
(default ``cuda``; without a card the run stops unless given ``--device
cpu``) is the port's own.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import torch

from stable_diffusion_pytorch_tpu_torch.config import compat_from_cfg, load_config
from stable_diffusion_pytorch_tpu_torch.models.autoencoder import AutoEncoderKL
from stable_diffusion_pytorch_tpu_torch.models.build import require_device, without_default_init
from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import load_params_for_inference, resolve_checkpoint


def export_state(params: Dict[str, torch.Tensor], kind: str, cfg, device="cpu") -> Dict[str, torch.Tensor]:
    """``params`` (a port checkpoint's, by name) as the reference's state
    dict of ``kind`` (``unet`` or ``vae``): loaded strictly into the port's
    module built from ``cfg.model`` on ``device`` (a checkpoint of another
    module or other widths raises), returned as contiguous f32 CPU tensors."""
    compat = compat_from_cfg(cfg)
    vae_cfg = cfg.model.autoencoder
    with torch.device(require_device(device)), without_default_init():
        if kind == "unet":
            module = UNetModel(vae_cfg.latent_channels, vae_cfg.groups, cfg.model.unet,
                               flipped_time_embedding=compat.flipped_time_embedding,
                               bottleneck_default_groups=compat.bottleneck_default_groups)
        else:
            module = AutoEncoderKL(vae_cfg, bottleneck_default_groups=compat.bottleneck_default_groups)
    module.load_state_dict(params, strict=True)
    return {k: v.detach().to("cpu", torch.float32).contiguous() for k, v in module.state_dict().items()}


def main(argv=None) -> dict:
    """Export and print the JSON line -> its dict."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--checkpoint", required=True, help="trainer checkpoint dir (or ckpt root; latest wins)")
    parser.add_argument("--export-model", choices=["unet", "vae"], default="unet")
    parser.add_argument("--output", default=None, help="output .pt path (default <model>_export.pt)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda; the CPU only when asked: --device cpu)")
    ns, rest = parser.parse_known_args(argv)
    try:
        require_device(ns.device)
    except RuntimeError as exc:
        raise SystemExit(f"export_torch: {exc}") from None
    _, cfg = load_config(rest)
    path = resolve_checkpoint(ns.checkpoint)
    sd = export_state(load_params_for_inference(path), ns.export_model, cfg, ns.device)
    out_path = ns.output or f"{ns.export_model}_export.pt"
    torch.save(sd, out_path)
    out = {"exported": len(sd), "checkpoint": path, "output": out_path, "model": ns.export_model}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
