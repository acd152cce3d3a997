"""img2img / inpainting CLI of the PyTorch port (counterpart of the JAX
package's scripts/img2img.py).

    python -m stable_diffusion_pytorch_tpu_torch.scripts.img2img --init-image photo.png \\
        --prompt "a watercolor" --strength 0.7 --image-size 512 --channels-list 320,640,1280,1280 ...
    python -m stable_diffusion_pytorch_tpu_torch.scripts.img2img --init-image photo.png \\
        --mask-image mask.png --prompt "a red hat"    # inpainting: white mask = repaint

``Img2ImgConfig`` holds the JAX CLI's fields; the whole config parses
through ``load_config`` with it as an extra group, as txt2img's and the JAX
CLI's do (``--config-file`` and every trainer flag parse; the model-size
flags, the compat switches, ``--seed``, ``--guidance-scale`` and
``--mixed-precision`` are read). ``--controlnet-checkpoint`` takes a checkpoint in the port's
layout (``models/controlnet.py``), or a comma list. ``--device`` (default
``cuda``; without a card the run stops unless given ``--device cpu``) is the
port's own. Weights staged under ``--model-dir`` are loaded
(``models/build.py``), the rest are random, made from ``--seed``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Optional

from stable_diffusion_pytorch_tpu_torch.config import BaseConfig
from stable_diffusion_pytorch_tpu_torch.models.build import require_device, resolve_dtype
from stable_diffusion_pytorch_tpu_torch.pipeline import img2img, inpaint
from stable_diffusion_pytorch_tpu_torch.scripts.txt2img import build_for_sampling, control_images, parse_args

logger = logging.getLogger("img2img")


@dataclass
class Img2ImgConfig(BaseConfig):
    prompt: str = field(default="", metadata={"help": "text prompt."})
    negative_prompt: str = field(default="", metadata={"help": "negative prompt."})
    init_image: Optional[str] = field(
        default=None, metadata={"help": "path to the input image (required)."}
    )
    mask_image: Optional[str] = field(
        default=None,
        metadata={"help": "optional inpainting mask PNG (white = repaint)."},
    )
    strength: float = field(
        default=0.75, metadata={"help": "img2img noise strength in (0, 1]."}
    )
    image_size: int = field(default=64, metadata={"help": "working resolution."})
    sampling_steps: int = field(default=50, metadata={"help": "denoising steps."})
    sampler: str = field(
        default="ddim",
        metadata={"help": "sampling algorithm.", "choices": ["ddim", "ddpm", "dpmpp"]},
    )
    output_dir: str = field(default="output", metadata={"help": "output directory."})
    controlnet_checkpoint: Optional[str] = field(
        default=None,
        metadata={
            "help": "ControlNet checkpoint dir (train_controlnet.py); "
            "requires --control-image."
        },
    )
    control_image: Optional[str] = field(
        default=None,
        metadata={"help": "conditioning image steering through the ControlNet."},
    )
    control_scale: float = field(
        default=1.0, metadata={"help": "ControlNet residual strength."}
    )


def main(argv=None) -> None:
    args, cfg = parse_args(argv, Img2ImgConfig)
    icfg = cfg[Img2ImgConfig]
    if not icfg.init_image:
        raise SystemExit("img2img: --init-image is required")
    try:
        require_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"img2img: {exc}") from None
    dtype = resolve_dtype(args.mixed_precision, args.device)
    model = build_for_sampling(args, cfg, dtype, controlnet_checkpoint=icfg.controlnet_checkpoint,
                               control_image=icfg.control_image)
    common = dict(
        prompt=icfg.prompt, image_size=icfg.image_size, time_steps=icfg.sampling_steps,
        guidance_scale=args.guidance_scale, sampler=icfg.sampler, save_dir=icfg.output_dir, seed=args.seed,
        negative_prompt=icfg.negative_prompt,
        control_image=control_images(icfg.controlnet_checkpoint, icfg.control_image),
        control_scale=icfg.control_scale,
    )
    start = time.perf_counter()
    if icfg.mask_image:
        logger.info(f"inpainting {icfg.init_image} with mask {icfg.mask_image} on {args.device} in {dtype}")
        inpaint(model, icfg.init_image, icfg.mask_image, **common)
    else:
        logger.info(f"img2img on {icfg.init_image} (strength {icfg.strength}) on {args.device} in {dtype}")
        img2img(model, icfg.init_image, strength=icfg.strength, **common)
    logger.info(f"saved to {icfg.output_dir}/ in {time.perf_counter() - start:.2f} s")


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s %(levelname)s %(name)s: %(message)s", level=logging.INFO)
    main()
