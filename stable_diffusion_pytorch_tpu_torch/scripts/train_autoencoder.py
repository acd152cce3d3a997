"""KL-VAE training CLI of the PyTorch port (counterpart of the root train_autoencoder.py).

    python -m stable_diffusion_pytorch_tpu_torch.scripts.train_autoencoder --dataset synthetic \\
        --resolution 256 --train-batch-size 4 --autoencoder-channels-list 128,256,512,512 --groups 32

Trains the VAE alone (f32 parameters computing in ``--mixed-precision``, random
weights made from ``--seed``) end to end on the reconstruction MSE plus
``--kl-weight`` times the KL, the batch-mean KL by default (the reference's
example-0 KL under ``--kl-per-example0``), with ``AutoencoderTrainer``. The
offline tokenizer serves only the dataset. The flags and their defaults are
the JAX CLI's; ``--device`` (default ``cuda``; without a card the run stops
unless given ``--device cpu``) is the port's own. Tiny run on the CPU:

    python -m stable_diffusion_pytorch_tpu_torch.scripts.train_autoencoder --device cpu \\
        --dataset synthetic --resolution 32 --max-train-steps 3 --train-batch-size 2 \\
        --eval-batch-size 2 --gradient-accumulation-steps 1 --max-train-samples 8 \\
        --max-val-samples 4 --max-test-samples 2 --log-interval 2 --checkpointing-steps 2 \\
        --ckpt-dir /tmp/ckpt_vae --autoencoder-channels-list 16,32 --groups 8

On N cards: ``torchrun --nproc_per_node N -m
stable_diffusion_pytorch_tpu_torch.scripts.train_autoencoder ...``;
``--use-deepspeed`` maps to ``--shard-optimizer-state``, as in the JAX CLI.
"""

from __future__ import annotations

from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig, ClipConfig, compat_from_cfg
from stable_diffusion_pytorch_tpu_torch.models.build import build_autoencoder
from stable_diffusion_pytorch_tpu_torch.models.clip import resolve_tokenizer
from stable_diffusion_pytorch_tpu_torch.scripts.train_unet import parse_training_flags
from stable_diffusion_pytorch_tpu_torch.trainers.trainer import AutoencoderTrainer
from stable_diffusion_pytorch_tpu_torch.utils.data import get_dataset, sample_test_image
from stable_diffusion_pytorch_tpu_torch.utils.errors import record
from stable_diffusion_pytorch_tpu_torch.utils.tracking import get_logger


def build_trainer(argv=None, capture: bool = True) -> AutoencoderTrainer:
    """Parse the flags and build the VAE, datasets, test images and trainer."""
    logger = get_logger("train_autoencoder")
    cfg, device = parse_training_flags(argv, "train_autoencoder", logger, map_deepspeed=True)
    compat = compat_from_cfg(cfg)
    vae = build_autoencoder(AutoencoderConfig(**cfg.model.autoencoder.to_dict()), compat=compat, device=device,
                            seed=cfg.train.seed)
    tokenizer = resolve_tokenizer(ClipConfig(**cfg.model.clip.to_dict()))
    train_dataset = get_dataset(cfg.dataset, split="train", tokenizer=tokenizer, logger=logger)
    eval_dataset = get_dataset(cfg.dataset, split="validation", tokenizer=tokenizer, logger=logger)
    test_images = sample_test_image(cfg.dataset, split="test", tokenizer=tokenizer, logger=logger, num=10)
    return AutoencoderTrainer(vae, cfg, train_dataset, eval_dataset, test_images=test_images, logger=logger,
                              compat=compat, device=device, capture=capture)


def _main(argv=None) -> AutoencoderTrainer:
    trainer = build_trainer(argv)
    trainer.train()
    return trainer


def main(argv=None) -> AutoencoderTrainer:
    """Build and train; a failure leaves a crash report under ``logs/crashes`` (``utils/errors.py``)."""
    return record(_main)(argv)


if __name__ == "__main__":
    main()
