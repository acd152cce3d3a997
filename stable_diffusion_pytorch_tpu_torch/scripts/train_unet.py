"""UNet training CLI of the PyTorch port (counterpart of the root train_unet.py).

    python -m stable_diffusion_pytorch_tpu_torch.scripts.train_unet --dataset synthetic \\
        --resolution 512 --train-batch-size 4 --channels-list 320,640,1280,1280 ...

Builds the models (frozen CLIP text encoder, frozen VAE, trainable UNet with f32
parameters computing in ``--mixed-precision``), loads the synthetic train and
validation datasets and runs ``UNetTrainer``. The flags and their defaults are
the JAX CLI's; ``--device`` (default ``cuda``; without a card the run stops
unless given ``--device cpu``) is the port's own. Weights staged under
``--model-dir`` are loaded (``models/build.py``), the rest are random, made
from ``--seed``. Tiny run on the CPU:

    python -m stable_diffusion_pytorch_tpu_torch.scripts.train_unet --device cpu \\
        --dataset synthetic --resolution 32 --max-train-steps 3 --train-batch-size 2 \\
        --eval-batch-size 2 --gradient-accumulation-steps 1 --max-train-samples 8 \\
        --max-val-samples 4 --log-interval 2 --checkpointing-steps 2 --ckpt-dir /tmp/ckpt \\
        --channels-list 32,64 --n-heads 4 --time-emb-dim 64 --n-layers 1 \\
        --autoencoder-channels-list 16,32 --groups 8

The memory-lean configuration (int8 Adam moments, a bf16 gradient
accumulator, per-block remat saving the ResBlock convs) adds
``--use-8bit-adam --accum-dtype bf16 --remat-policy conv-save``. The JAX
trainer's other options run here too: ``--prediction-type v_prediction``
(with ``--zero-terminal-snr``), ``--snr-gamma``, ``--latent-cache PATH``
(built on first use), ``--device-preprocess``, ``--log-grad-noise-scale``,
``--spike-threshold``, ``--log-image``, ``--no-fused-adamw`` and a Hugging
Face ``--dataset``.

On N cards, one process per card (``--train-batch-size`` is per card):

    torchrun --nproc_per_node N -m stable_diffusion_pytorch_tpu_torch.scripts.train_unet \
        --dataset synthetic --resolution 512 --train-batch-size 4 ... [--shard-optimizer-state]

``--shard-optimizer-state`` (ZeRO), ``--use-deepspeed`` (logged and mapped to
it, as the JAX CLI does), ``--offload-optimizer`` and ``--shard-params``
(FSDP) apply there; the trainer's docstring (``trainers/trainer.py``) gives
the semantics.
"""

from __future__ import annotations

import os

from stable_diffusion_pytorch_tpu_torch.config import (
    AutoencoderConfig,
    ClipConfig,
    DDPMConfig,
    UnetConfig,
    compat_from_cfg,
    load_config,
)
from stable_diffusion_pytorch_tpu_torch.models.build import build_models, require_device, resolve_dtype
from stable_diffusion_pytorch_tpu_torch.parallel.distributed import main_first, maybe_initialize
from stable_diffusion_pytorch_tpu_torch.trainers.trainer import UNetTrainer
from stable_diffusion_pytorch_tpu_torch.utils.data import get_dataset
from stable_diffusion_pytorch_tpu_torch.utils.errors import record
from stable_diffusion_pytorch_tpu_torch.utils.latent_cache import (
    LatentCacheDataset,
    build_latent_cache,
    collate_latents,
)
from stable_diffusion_pytorch_tpu_torch.utils.tracking import get_logger


def _add_device(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cuda; the CPU only when asked: --device cpu)")


def parse_training_flags(argv, name: str, logger, map_deepspeed: bool = False):
    """Parse and check the flags, join the process group when a launcher
    started this process (``parallel/distributed.py``) -> (cfg, device).
    ``map_deepspeed``: ``--use-deepspeed`` turns on optimizer-state sharding
    (the UNet and VAE CLIs, as the JAX ones)."""
    args, cfg = load_config(argv, parser_hook=_add_device)
    try:
        device = require_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"{name}: {exc}") from None
    if map_deepspeed and cfg.train.use_deepspeed:
        logger.info("--use-deepspeed requested: mapping to optimizer-state sharding over the data group "
                    "(ZeRO-2 analog)")
        cfg.parallel.shard_optimizer_state = True
    maybe_initialize(device=str(device))
    return cfg, device


def build_training_models(argv, name: str, map_deepspeed: bool = False):
    """Parse the flags, check them and build the models for a UNet-loss
    trainer (frozen CLIP and VAE, the UNet with f32 parameters and the run's
    remat policy) -> (cfg, device, compat, model, logger)."""
    logger = get_logger(name)
    cfg, device = parse_training_flags(argv, name, logger, map_deepspeed)
    compat = compat_from_cfg(cfg)
    dtype = resolve_dtype(cfg.parallel.mixed_precision, device)
    m = cfg.model
    model = build_models(
        UnetConfig(**m.unet.to_dict()), AutoencoderConfig(**m.autoencoder.to_dict()),
        ClipConfig(**m.clip.to_dict()), DDPMConfig(**m.ddpm.to_dict()),
        compat=compat, dtype=dtype, device=device, seed=cfg.train.seed, for_training=True,
        remat=cfg.parallel.remat_policy, pretrained_dir=m.clip.model_dir, logger=logger,
    )
    return cfg, device, compat, model, logger


def build_trainer(argv=None, capture: bool = True) -> UNetTrainer:
    """Parse the flags and build the models, datasets and trainer (``capture``:
    the trainer's). With ``--latent-cache PATH`` the training rows come from
    that cache, built first from the training set (the frozen VAE and CLIP
    on the run's device) when the file does not exist."""
    cfg, device, compat, model, logger = build_training_models(argv, "train_unet", map_deepspeed=True)
    tokenizer = model.text_encoder.tokenizer
    train_dataset = get_dataset(cfg.dataset, split="train", tokenizer=tokenizer, logger=logger)
    eval_dataset = get_dataset(cfg.dataset, split="validation", tokenizer=tokenizer, logger=logger)
    collate = None
    cache = cfg.dataset.latent_cache
    if cache:
        if not os.path.exists(cache):
            main_first(build_latent_cache, model.autoencoder, train_dataset, cache, logger=logger,
                       text_encoder=model.text_encoder)
        train_dataset, collate = LatentCacheDataset(cache), collate_latents
        logger.info(f"training from cached latents: {cache}")
    return UNetTrainer(model, cfg, train_dataset, eval_dataset, logger=logger, compat=compat, device=device,
                       train_collate=collate, capture=capture)


def _main(argv=None) -> UNetTrainer:
    trainer = build_trainer(argv)
    trainer.train()
    return trainer


def main(argv=None) -> UNetTrainer:
    """Build and train; a failure leaves a crash report under ``logs/crashes`` (``utils/errors.py``)."""
    return record(_main)(argv)


if __name__ == "__main__":
    main()
