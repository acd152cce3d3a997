"""UNet training CLI of the PyTorch port (counterpart of the root train_unet.py).

    python -m stable_diffusion_pytorch_tpu_torch.scripts.train_unet --dataset synthetic \\
        --resolution 512 --train-batch-size 4 --channels-list 320,640,1280,1280 ...

Builds the models (frozen CLIP text encoder, frozen VAE, trainable UNet with f32
parameters computing in ``--mixed-precision``), loads the synthetic train and
validation datasets and runs ``UNetTrainer``. The flags and their defaults are
the JAX CLI's; ``--device`` (default ``cuda``; without a card the run stops
unless given ``--device cpu``) is the port's own. Weights are random, made
from ``--seed``. Tiny run on the CPU:

    python -m stable_diffusion_pytorch_tpu_torch.scripts.train_unet --device cpu \\
        --dataset synthetic --resolution 32 --max-train-steps 3 --train-batch-size 2 \\
        --eval-batch-size 2 --gradient-accumulation-steps 1 --max-train-samples 8 \\
        --max-val-samples 4 --log-interval 2 --checkpointing-steps 2 --ckpt-dir /tmp/ckpt \\
        --channels-list 32,64 --n-heads 4 --time-emb-dim 64 --n-layers 1 \\
        --autoencoder-channels-list 16,32 --groups 8
"""

from __future__ import annotations

from stable_diffusion_pytorch_tpu_torch.config import (
    AutoencoderConfig,
    ClipConfig,
    DDPMConfig,
    UnetConfig,
    compat_from_cfg,
    load_config,
)
from stable_diffusion_pytorch_tpu_torch.models.build import build_models, require_device, resolve_dtype
from stable_diffusion_pytorch_tpu_torch.trainers.trainer import UNetTrainer, check_supported
from stable_diffusion_pytorch_tpu_torch.utils.data import get_dataset
from stable_diffusion_pytorch_tpu_torch.utils.tracking import get_logger


def _add_device(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cuda; the CPU only when asked: --device cpu)")


def build_trainer(argv=None) -> UNetTrainer:
    """Parse the flags and build the models, datasets and trainer."""
    logger = get_logger("train_unet")
    args, cfg = load_config(argv, parser_hook=_add_device)
    try:
        device = require_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"train_unet: {exc}") from None
    check_supported(cfg)
    compat = compat_from_cfg(cfg)
    dtype = resolve_dtype(cfg.parallel.mixed_precision, device)
    m = cfg.model
    model = build_models(
        UnetConfig(**m.unet.to_dict()), AutoencoderConfig(**m.autoencoder.to_dict()),
        ClipConfig(**m.clip.to_dict()), DDPMConfig(**m.ddpm.to_dict()),
        compat=compat, dtype=dtype, device=device, seed=cfg.train.seed, for_training=True,
    )
    tokenizer = model.text_encoder.tokenizer
    train_dataset = get_dataset(cfg.dataset, split="train", tokenizer=tokenizer, logger=logger)
    eval_dataset = get_dataset(cfg.dataset, split="validation", tokenizer=tokenizer, logger=logger)
    return UNetTrainer(model, cfg, train_dataset, eval_dataset, logger=logger, compat=compat, device=device)


def main(argv=None) -> UNetTrainer:
    trainer = build_trainer(argv)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
