"""Textual-inversion training CLI of the PyTorch port (counterpart of the root
train_textual_inversion.py).

    python -m stable_diffusion_pytorch_tpu_torch.scripts.train_textual_inversion --dataset synthetic \\
        --placeholder-token "<concept>" --num-vectors 2 --initializer-token toy ...

Learns ``--num-vectors`` embedding vectors for ``--placeholder-token`` (Gal
et al. 2022) with everything else frozen: the dataset's images, each caption
replaced by a template holding the placeholder. The vectors start as the
mean embedding of ``--initializer-token`` or as small noise. The checkpoint
holds ``{"ti": [K, 768]}``, and the checkpoint directory the
``textual_inversion.json`` sidecar; ``txt2img --textual-inversion`` samples
with it. The flags and their defaults are the JAX CLI's; ``--device``
(default ``cuda``; without a card the run stops unless given ``--device
cpu``) is the port's own. Weights staged under ``--model-dir`` are loaded
(``models/build.py``), the rest are random, made from ``--seed``.
"""

from __future__ import annotations

import numpy as np

from stable_diffusion_pytorch_tpu_torch.scripts.train_unet import build_training_models
from stable_diffusion_pytorch_tpu_torch.trainers.trainer import TextualInversionTrainer
from stable_diffusion_pytorch_tpu_torch.utils.data import TextualInversionDataset, get_dataset
from stable_diffusion_pytorch_tpu_torch.utils.errors import record


def init_concept_vectors(text_encoder, cfg_train, seed: int = 0) -> np.ndarray:
    """The [K, d_model] initial vectors: the initializer's token embedding
    (the mean row of a multi-token initializer), tiled, or without one
    ``default_rng(seed)`` normals times 0.02."""
    k = cfg_train.num_vectors
    if cfg_train.initializer_token:
        ids = text_encoder._plain_ids(cfg_train.initializer_token)
        if not ids:
            raise ValueError(f"initializer token {cfg_train.initializer_token!r} tokenized to nothing")
        table = text_encoder.module.text_model.embeddings.token_embedding.weight
        row = table.detach()[ids].float().cpu().numpy().mean(axis=0)
        return np.tile(row[None, :], (k, 1)).astype(np.float32)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, text_encoder.module.d_model)) * 0.02).astype(np.float32)


def build_trainer(argv=None, capture: bool = True) -> TextualInversionTrainer:
    """Parse the flags, register the concept and build the datasets and trainer."""
    cfg, device, _, model, logger = build_training_models(argv, "train_textual_inversion")
    te, t = model.text_encoder, cfg.train
    te.add_textual_inversion(t.placeholder_token, init_concept_vectors(te, t, seed=t.seed))
    logger.info(f"textual inversion: placeholder {t.placeholder_token!r} -> {t.num_vectors} vector(s)"
                + (f", initialized from {t.initializer_token!r}" if t.initializer_token else ", random init"))
    datasets = [TextualInversionDataset(get_dataset(cfg.dataset, split=split, tokenizer=te.tokenizer, logger=logger),
                                        t.placeholder_token, te.tokenize) for split in ("train", "validation")]
    return TextualInversionTrainer(model, cfg, *datasets, logger=logger, device=device,
                                   capture=capture)


def _main(argv=None) -> TextualInversionTrainer:
    trainer = build_trainer(argv)
    trainer.train()
    return trainer


def main(argv=None) -> TextualInversionTrainer:
    """Build and train; a failure leaves a crash report under ``logs/crashes`` (``utils/errors.py``)."""
    return record(_main)(argv)


if __name__ == "__main__":
    main()
