"""Reference-compat switches (port of stable_diffusion_pytorch_tpu/utils/compat.py).

The whole ``CompatConfig`` of the JAX package, with the same field names,
defaults and help: the correct math by default, each reference quirk behind a
flag, ``--reference-compat`` flipping all of them (``resolved()``). The
sampling path reads ``cfg_formula``, ``ascending_sample_loop`` (the loop in
ascending t over the reference's leading few-step schedule),
``uniform_init_noise`` (U[0, 1) init noise), ``flipped_time_embedding`` and
``bottleneck_default_groups``; the UNet trainer reads ``train_with_cfg``,
``cfg_formula`` and ``reference_compat`` (whole-batch CFG dropout); the
autoencoder trainer reads ``kl_per_example0`` (and the VAE
``bottleneck_default_groups``).
"""

from dataclasses import dataclass, field

from stable_diffusion_pytorch_tpu_torch.config import BaseConfig


@dataclass
class CompatConfig(BaseConfig):
    reference_compat: bool = field(
        default=False,
        metadata={"help": "Enable ALL reference-parity quirks at once."},
    )
    cfg_formula: bool = field(
        default=False,
        metadata={"help": "Use the reference's swapped CFG combine (uncond + g*(uncond-cond))."},
    )
    ascending_sample_loop: bool = field(
        default=False,
        metadata={"help": "Run the sampling loop t ascending (0..T-1) like the reference."},
    )
    uniform_init_noise: bool = field(
        default=False,
        metadata={"help": "Initialize sampling from U[0,1) noise instead of N(0,1)."},
    )
    flipped_time_embedding: bool = field(
        default=False,
        metadata={"help": "Use the reference's sign-flipped sinusoid frequencies."},
    )
    bottleneck_default_groups: bool = field(
        default=False,
        metadata={"help": "First bottleneck ResBlock uses 2 GroupNorm groups (reference bug)."},
    )
    kl_per_example0: bool = field(
        default=False,
        metadata={"help": "VAE loss uses example 0's KL instead of the batch mean."},
    )
    train_with_cfg: bool = field(
        default=False,
        metadata={"help": "Train the UNet through the CFG-combined doubled forward like the reference."},
    )

    def resolved(self) -> "CompatConfig":
        """Return a copy with reference_compat fanning out to every individual flag."""
        if not self.reference_compat:
            return self
        return CompatConfig(
            reference_compat=True,
            cfg_formula=True,
            ascending_sample_loop=True,
            uniform_init_noise=True,
            flipped_time_embedding=True,
            bottleneck_default_groups=True,
            kl_per_example0=True,
            train_with_cfg=True,
        )
