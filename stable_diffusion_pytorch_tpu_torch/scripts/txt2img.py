"""txt2img CLI of the PyTorch port.

    python -m stable_diffusion_pytorch_tpu_torch.scripts.txt2img \\
        --prompt "a cat" --image-size 512 --sampling-steps 50 --guidance-scale 7.5 \\
        --channels-list 320,640,1280,1280 ...

Flag names are the JAX CLI's for the ported subset: the sampling flags (every
sampler, Karras spacing, v-prediction, trailing spacing, guidance rescale,
``--unet-checkpoint`` from one of the port's trainer checkpoints), the
model-size flags of the UNet/VAE/CLIP/DDPM config groups, the compat switches
the slice reads, ``--seed``, ``--guidance-scale`` and ``--mixed-precision``.
``--device`` (default ``cuda``; without a card the run stops unless given
``--device cpu``) is the port's own. Weights are
random, made from ``--seed``: no pretrained weights ship with the repository.
"""

from __future__ import annotations

import argparse
import logging
import time

from stable_diffusion_pytorch_tpu_torch.config import (
    AutoencoderConfig,
    ClipConfig,
    DDPMConfig,
    UnetConfig,
    add_dataclass_args,
)
from stable_diffusion_pytorch_tpu_torch.models.build import build_models, require_device, resolve_dtype
from stable_diffusion_pytorch_tpu_torch.pipeline import SamplingConfig, sample
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import load_unet_for_inference
from stable_diffusion_pytorch_tpu_torch.utils.compat import CompatConfig

logger = logging.getLogger("txt2img")

_GROUPS = (UnetConfig, AutoencoderConfig, ClipConfig, DDPMConfig, CompatConfig, SamplingConfig)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="text-to-image sampling (PyTorch port)")
    for dc in _GROUPS:
        add_dataclass_args(parser, dc)
    parser.add_argument("--seed", type=int, default=42, help="seed for weights and init noise")
    parser.add_argument("--guidance-scale", type=float, default=7.5,
                        help="guidance scale for classifier free guidance")
    parser.add_argument("--mixed-precision", default="bf16", choices=["no", "bf16", "fp16", "fp32"],
                        help="compute dtype on a CUDA device (the CPU always computes in float32)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda; the CPU only when asked: --device cpu)")
    args = parser.parse_args(argv)
    configs = {
        dc: dc(**{f: getattr(args, f) for f in dc.__dataclass_fields__}) for dc in _GROUPS
    }
    return args, configs


def main(argv=None) -> None:
    args, cfg = parse_args(argv)
    try:
        require_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"txt2img: {exc}") from None
    dtype = resolve_dtype(args.mixed_precision, args.device)
    model = build_models(
        cfg[UnetConfig], cfg[AutoencoderConfig], cfg[ClipConfig], cfg[DDPMConfig],
        compat=cfg[CompatConfig], dtype=dtype, device=args.device, seed=args.seed,
    )
    s = cfg[SamplingConfig]
    if s.unet_checkpoint:
        logger.info(f"loaded trained UNet weights from {load_unet_for_inference(model.unet, s.unet_checkpoint)}")
    logger.info(
        f"sampling {s.num_images} image(s) for prompt={s.prompt!r} ({s.sampler}, "
        f"{s.sampling_steps} steps, cfg={args.guidance_scale}) on {args.device} in {dtype}"
    )
    start = time.perf_counter()
    sample(
        model, image_size=s.image_size, prompt=s.prompt, time_steps=s.sampling_steps,
        guidance_scale=args.guidance_scale, scale_factor=s.scale_factor, save_dir=s.output_dir,
        sampler=s.sampler, eta=s.eta, num_images=s.num_images, repeat_noise=s.repeat_noise, seed=args.seed,
        name=s.output_name, negative_prompt=s.negative_prompt, karras=s.karras,
        prediction_type=s.prediction_type, timestep_spacing=s.timestep_spacing,
        guidance_rescale=s.guidance_rescale, hires_scale=s.hires_scale,
        hires_strength=s.hires_strength, vae_tile=s.vae_tile,
    )
    logger.info(f"saved to {s.output_dir}/ in {time.perf_counter() - start:.2f} s")


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s %(levelname)s %(name)s: %(message)s", level=logging.INFO)
    main()
