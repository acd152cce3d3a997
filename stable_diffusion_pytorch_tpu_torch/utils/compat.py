"""Reference-compat switches the text-to-image slice reads.

The subset of the JAX package's ``utils/compat.py:CompatConfig`` that the
sampling path consults, with the same field names, defaults and help. The
other switches (ascending loop, uniform init noise, the training quirks)
belong to paths not ported yet.
"""

from dataclasses import dataclass, field

from stable_diffusion_pytorch_tpu.config import BaseConfig


@dataclass
class CompatConfig(BaseConfig):
    cfg_formula: bool = field(
        default=False,
        metadata={"help": "Use the reference's swapped CFG combine (uncond + g*(uncond-cond))."},
    )
    flipped_time_embedding: bool = field(
        default=False,
        metadata={"help": "Use the reference's sign-flipped sinusoid frequencies."},
    )
    bottleneck_default_groups: bool = field(
        default=False,
        metadata={"help": "First bottleneck ResBlock uses 2 GroupNorm groups (reference bug)."},
    )
