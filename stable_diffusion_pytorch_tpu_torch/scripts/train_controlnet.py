"""ControlNet training CLI of the PyTorch port (counterpart of the root train_controlnet.py).

    python -m stable_diffusion_pytorch_tpu_torch.scripts.train_controlnet --dataset synthetic ...

Trains a control branch (a copy of the UNet's encoder, a hint embedding and
zero convs; ``models/controlnet.py``) on (image, hint, caption) rows while the
UNet, VAE and CLIP stay frozen (Zhang et al. 2023). The hint is the edge map
of the target image (``utils/data.py:edge_hint``); it reaches the latent
resolution through one stride-2 conv per VAE downsample. Each row's prompt
drops with ``--cfg-dropout-prob``. ``txt2img --controlnet-checkpoint ckpt
--control-image hint.png`` samples with the result. The flags and their
defaults are the JAX CLI's; ``--device`` (default ``cuda``; without a card
the run stops unless given ``--device cpu``) is the port's own. Weights
staged under ``--model-dir`` are loaded (``models/build.py``), the rest are
random, made from ``--seed``.
"""

from __future__ import annotations

from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig, UnetConfig
from stable_diffusion_pytorch_tpu_torch.models.build import build_controlnet
from stable_diffusion_pytorch_tpu_torch.scripts.train_unet import build_training_models
from stable_diffusion_pytorch_tpu_torch.trainers.trainer import ControlNetTrainer
from stable_diffusion_pytorch_tpu_torch.utils.data import ControlNetDataset, get_dataset
from stable_diffusion_pytorch_tpu_torch.utils.errors import record


def build_trainer(argv=None, capture: bool = True) -> ControlNetTrainer:
    """Parse the flags and build the models, the ControlNet, the datasets and the trainer."""
    cfg, device, compat, model, logger = build_training_models(argv, "train_controlnet")
    vae_cfg = AutoencoderConfig(**cfg.model.autoencoder.to_dict())
    controlnet = build_controlnet(UnetConfig(**cfg.model.unet.to_dict()), vae_cfg, compat=compat, device=device,
                                  seed=cfg.train.seed, for_training=True)
    logger.info(f"ControlNet: UNet-encoder copy + hint embedding ({len(vae_cfg.autoencoder_channels_list) - 1} hint "
                f"downsamples), prompt dropout {cfg.train.cfg_dropout_prob:g}")
    tokenizer = model.text_encoder.tokenizer
    datasets = [ControlNetDataset(get_dataset(cfg.dataset, split=split, tokenizer=tokenizer, logger=logger))
                for split in ("train", "validation")]
    return ControlNetTrainer(model, controlnet, cfg, *datasets, logger=logger, device=device,
                             capture=capture)


def _main(argv=None) -> ControlNetTrainer:
    trainer = build_trainer(argv)
    trainer.train()
    return trainer


def main(argv=None) -> ControlNetTrainer:
    """Build and train; a failure leaves a crash report under ``logs/crashes`` (``utils/errors.py``)."""
    return record(_main)(argv)


if __name__ == "__main__":
    main()
