"""txt2img CLI of the PyTorch port.

    python -m stable_diffusion_pytorch_tpu_torch.scripts.txt2img \\
        --prompt "a cat" --image-size 512 --sampling-steps 50 --guidance-scale 7.5 \\
        --channels-list 320,640,1280,1280 ...

The flags are the JAX CLI's: the whole config parses through
``config.py:load_config`` with ``SamplingConfig`` as an extra group, as the
JAX CLI's does, so ``--config-file`` (a path, or a preset's name) and every
trainer flag parse, and those sampling does not read are accepted and
ignored. Sampling reads every flag of ``SamplingConfig`` (every sampler,
Karras spacing, v-prediction, trailing spacing, guidance rescale, the hires
fix, DeepCache, ``--unet-checkpoint``, ``--lora-checkpoint``/``--lora-scale``,
``--textual-inversion``, ``--controlnet-checkpoint`` (a comma list)/
``--control-image``/``--control-scale``, each a checkpoint in the port's
layout), the model-size flags of the UNet/VAE/CLIP/DDPM config groups, the
compat switches, ``--seed``, ``--guidance-scale`` and ``--mixed-precision``.
``--device`` (default ``cuda``; without a card the run stops unless given
``--device cpu``) is the port's own. Weights staged under ``--model-dir``
(default ``data/pretrained``: ``unet.pt``, ``vae/`` or ``vae.pt``,
``text_encoder/``; ``models/build.py``) are loaded, as the JAX CLI loads
them; the rest are random, made from ``--seed``: no pretrained weights ship
with the repository.
"""

from __future__ import annotations

import logging
import time

from stable_diffusion_pytorch_tpu_torch.config import (
    AutoencoderConfig,
    ClipConfig,
    DDPMConfig,
    UnetConfig,
    load_config,
)
from stable_diffusion_pytorch_tpu_torch.models.build import (
    build_models,
    load_controlnets,
    load_unet_weights,
    require_device,
    resolve_dtype,
)
from stable_diffusion_pytorch_tpu_torch.pipeline import SamplingConfig, sample
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import load_params_for_inference, resolve_checkpoint
from stable_diffusion_pytorch_tpu_torch.utils.compat import CompatConfig

logger = logging.getLogger("txt2img")

_GROUPS = (UnetConfig, AutoencoderConfig, ClipConfig, DDPMConfig, CompatConfig)


def _add_device(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda; the CPU only when asked: --device cpu)")


def parse_args(argv=None, extra=SamplingConfig):
    """-> (args, {config dataclass: its instance}): the whole config through
    ``load_config`` with ``extra`` (``SamplingConfig``, or the img2img CLI's
    group) as an extra group and ``--device``; the instances are those of
    the model groups, the compat switches and ``extra``. ``args`` holds
    every flag, ``--seed``, ``--guidance-scale`` and ``--mixed-precision``
    among them."""
    args, _ = load_config(argv, extra_data_classes=[extra], parser_hook=_add_device)
    configs = {dc: dc(**{f: getattr(args, f) for f in dc.__dataclass_fields__}) for dc in (*_GROUPS, extra)}
    return args, configs


def build_for_sampling(args, cfg: dict, dtype, unet_checkpoint=None, lora_checkpoint=None, lora_scale=1.0,
                       textual_inversion=None, controlnet_checkpoint=None, control_image=None):
    """The seeded model with the sampling flags' weights: the UNet
    checkpoint, the LoRA merged in float32 (into the checkpoint's weights, or
    into the random ones before the cast), the textual-inversion concept and
    the ControlNets of the comma list ``controlnet_checkpoint``, attached."""
    lora = None
    if lora_checkpoint and not unet_checkpoint:
        lora = (load_params_for_inference(resolve_checkpoint(lora_checkpoint)), lora_scale)
    model = build_models(
        cfg[UnetConfig], cfg[AutoencoderConfig], cfg[ClipConfig], cfg[DDPMConfig],
        compat=cfg[CompatConfig], dtype=dtype, device=args.device, seed=args.seed, lora=lora,
        pretrained_dir=cfg[ClipConfig].model_dir, logger=logger,
    )
    if unet_checkpoint:
        path = load_unet_weights(model.unet, unet_checkpoint, lora=lora_checkpoint, lora_scale=lora_scale)
        logger.info(f"loaded trained UNet weights from {path}")
    if lora_checkpoint:
        logger.info(f"merged LoRA weights from {lora_checkpoint} (scale {lora_scale:g})")
    if controlnet_checkpoint:
        if not control_image:
            raise SystemExit("--controlnet-checkpoint needs --control-image")
        paths = [p for p in controlnet_checkpoint.split(",") if p]
        model.attach_controlnet(load_controlnets(paths, cfg[UnetConfig], cfg[AutoencoderConfig],
                                                 cfg[CompatConfig], dtype, args.device))
        logger.info(f"{len(paths)} ControlNet(s) attached (hints: {control_image})")
    if textual_inversion:
        token = model.text_encoder.load_textual_inversion(textual_inversion)
        logger.info(f"loaded textual inversion from {textual_inversion}: placeholder {token!r}")
    return model


def control_images(controlnet_checkpoint, control_image):
    """``--control-image`` as the pipelines take it: a list when it is a comma
    list, else the one path; None without ``--controlnet-checkpoint``."""
    if not controlnet_checkpoint:
        return None
    return [p for p in control_image.split(",") if p] if "," in control_image else control_image


def main(argv=None):
    """Sample and write the image(s) -> the model they were sampled with."""
    args, cfg = parse_args(argv)
    try:
        require_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"txt2img: {exc}") from None
    dtype = resolve_dtype(args.mixed_precision, args.device)
    s = cfg[SamplingConfig]
    model = build_for_sampling(
        args, cfg, dtype, unet_checkpoint=s.unet_checkpoint, lora_checkpoint=s.lora_checkpoint,
        lora_scale=s.lora_scale, textual_inversion=s.textual_inversion,
        controlnet_checkpoint=s.controlnet_checkpoint, control_image=s.control_image)
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
        guidance_rescale=s.guidance_rescale, control_image=control_images(s.controlnet_checkpoint, s.control_image),
        control_scale=s.control_scale, deep_cache_interval=s.deep_cache_interval, hires_scale=s.hires_scale,
        hires_strength=s.hires_strength, vae_tile=s.vae_tile,
    )
    logger.info(f"saved to {s.output_dir}/ in {time.perf_counter() - start:.2f} s")
    return model


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s %(levelname)s %(name)s: %(message)s", level=logging.INFO)
    main()
