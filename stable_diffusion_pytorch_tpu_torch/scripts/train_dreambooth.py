"""DreamBooth training CLI of the PyTorch port (counterpart of the root train_dreambooth.py).

    python -m stable_diffusion_pytorch_tpu_torch.scripts.train_dreambooth \\
        --instance-data-dir data/my_dog --instance-prompt "a photo of sks dog" \\
        --with-prior-preservation --class-data-dir data/dog_class \\
        --class-prompt "a photo of a dog" --num-class-images 8 --lora-rank 8 ...

Fine-tunes the UNet on a few subject images captioned with one identifier
prompt (Ruiz et al. 2022), as a whole or, with ``--lora-rank``, as rank-r
factors on a frozen base. ``--with-prior-preservation`` first fills
``--class-data-dir`` up to ``--num-class-images`` with images of
``--class-prompt`` that the model itself samples (DDIM,
``--class-sampling-steps``, the seed of each image ``--seed`` plus its index),
then interleaves an instance and a class row per pair and adds
``--prior-loss-weight`` times the class rows' MSE: the UNet's batch is twice
``--train-batch-size``. Evaluation runs on the instance images. The flags and
their defaults are the JAX CLI's; ``--device`` (default ``cuda``; without a
card the run stops unless given ``--device cpu``) is the port's own. Weights
staged under ``--model-dir`` are loaded (``models/build.py``), the rest are
random, made from ``--seed``. A LoRA checkpoint samples through
``txt2img --lora-checkpoint``, a whole UNet through ``--unet-checkpoint``.
"""

from __future__ import annotations

import os

from stable_diffusion_pytorch_tpu_torch import pipeline
from stable_diffusion_pytorch_tpu_torch.models.build import sampling_model
from stable_diffusion_pytorch_tpu_torch.parallel.distributed import main_first
from stable_diffusion_pytorch_tpu_torch.scripts.train_unet import build_training_models
from stable_diffusion_pytorch_tpu_torch.trainers.trainer import UNetTrainer
from stable_diffusion_pytorch_tpu_torch.utils.data import (
    DreamBoothDataset,
    FolderPromptDataset,
    dreambooth_collate,
    to_img,
)
from stable_diffusion_pytorch_tpu_torch.utils.errors import record

CLASS_BATCH = 4  # class images sampled per call


def ensure_class_images(model, cfg_train, resolution: int, logger) -> int:
    """Sample the class images ``--class-data-dir`` lacks with the current model
    (the prior is the model's own class distribution, Ruiz et al. 2022 §3.2),
    ``CLASS_BATCH`` a call, image ``n`` from seed ``seed + n``, written as
    ``class_{n:05d}.png``; the UNet computes in the run's dtype
    (``models/build.py:sampling_model``), and on a card every batch of one
    size replays the loop captured at the first. -> how many were made."""
    folder = cfg_train.class_data_dir
    os.makedirs(folder, exist_ok=True)
    have = sorted(f for f in os.listdir(folder) if f.lower().endswith(FolderPromptDataset.EXTS))
    need = cfg_train.num_class_images - len(have)
    if need <= 0:
        logger.info(f"prior preservation: {len(have)} class images present in {folder!r}")
        return 0
    logger.info(f"prior preservation: generating {need} class image(s) for {cfg_train.class_prompt!r} into "
                f"{folder!r} ({cfg_train.class_sampling_steps} DDIM steps)")
    sampler = sampling_model(model, capture=True)
    done = 0
    while done < need:
        n = min(CLASS_BATCH, need - done)
        first = len(have) + done
        images = pipeline.sample(
            sampler, image_size=resolution, prompt=[cfg_train.class_prompt] * n,
            time_steps=cfg_train.class_sampling_steps, guidance_scale=cfg_train.guidance_scale, save_dir=None,
            sampler="ddim", seed=[cfg_train.seed + first + i for i in range(n)],
        )
        for i, img in enumerate(images):
            to_img(img, folder, f"class_{first + i:05d}.png")
        done += n
    return need


def build_trainer(argv=None, read=None, capture: bool = True) -> UNetTrainer:
    """Parse the flags and build the models, the class images, the datasets
    and the trainer; ``read(path)`` decodes an image file (Pillow by default)."""
    cfg, device, compat, model, logger = build_training_models(argv, "train_dreambooth")
    t = cfg.train
    if not t.instance_data_dir:
        raise SystemExit("train_dreambooth: --instance-data-dir is required")
    tokenizer = model.text_encoder.tokenizer
    instance_ds = FolderPromptDataset(t.instance_data_dir, t.instance_prompt, cfg.dataset, tokenizer, read=read)
    logger.info(f"DreamBooth: {len(instance_ds)} instance image(s), prompt {t.instance_prompt!r}")
    train_dataset, collate = instance_ds, None
    if t.with_prior_preservation:
        if not t.class_data_dir:
            raise SystemExit("train_dreambooth: --with-prior-preservation needs --class-data-dir")
        main_first(ensure_class_images, model, t, cfg.dataset.resolution, logger)
        class_ds = FolderPromptDataset(t.class_data_dir, t.class_prompt, cfg.dataset, tokenizer, read=read)
        train_dataset, collate = DreamBoothDataset(instance_ds, class_ds), dreambooth_collate
        logger.info(f"prior preservation on: {len(class_ds)} class image(s), weight {t.prior_loss_weight:g} "
                    f"(UNet batch {2 * t.train_batch_size})")
    return UNetTrainer(model, cfg, train_dataset, instance_ds, logger=logger, compat=compat, device=device,
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
