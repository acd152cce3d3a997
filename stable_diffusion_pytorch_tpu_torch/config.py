"""The slice's config dataclasses, with the JAX package's field names and defaults.

The JAX package's ``config.load_config`` imports its flax model modules to
collect these dataclasses, so the port declares its own copies. A test pins
each field (name, default, help, choices) equal to the JAX dataclass.
``BaseConfig`` and ``add_dataclass_args`` are stdlib-only and reused as they are.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from stable_diffusion_pytorch_tpu.config import BaseConfig, add_dataclass_args

__all__ = [
    "AutoencoderConfig",
    "BaseConfig",
    "ClipConfig",
    "DDPMConfig",
    "UnetConfig",
    "add_dataclass_args",
]


@dataclass
class UnetConfig(BaseConfig):
    """JAX: stable_diffusion_pytorch_tpu/models/unet.py:UnetConfig."""

    num_res_blocks: int = field(
        default=2, metadata={"help": "Number of residual blocks at each level."}
    )
    n_heads: int = field(
        default=8, metadata={"help": "Number of attention heads in transformers."}
    )
    attention_resolutions: List[int] = field(
        default_factory=lambda: [0, 1],
        metadata={
            "help": "At which level attention should be performed. e.g., [1, 2] means attention is performed at level 1 and 2."
        },
    )
    channels_list: List[int] = field(
        default_factory=lambda: [160, 320],
        metadata={"help": "Channels at each level."},
    )
    time_emb_dim: Optional[int] = field(
        default=512,
        metadata={
            "help": "Time embedding dimension. If not specified, use 4 * channels_list[0] instead."
        },
    )
    dropout: float = field(default=0.1, metadata={"help": "Dropout rate."})
    n_layers: int = field(default=2, metadata={"help": "Number of transformer layers."})
    context_dim: int = field(
        default=768, metadata={"help": "Embedding dim of context condition."}
    )


@dataclass
class AutoencoderConfig(BaseConfig):
    """JAX: stable_diffusion_pytorch_tpu/models/autoencoder.py:AutoencoderConfig."""

    in_channels: int = field(
        default=3, metadata={"help": "Number of input channels of the input image."}
    )
    latent_channels: int = field(
        default=4, metadata={"help": "Embedding channels of the latent vector."}
    )
    out_channels: Optional[int] = field(
        default=3,
        metadata={
            "help": "Number of output channels of the decoded image. Should be the same as in_channels."
        },
    )
    autoencoder_channels_list: List[int] = field(
        default_factory=lambda: [64, 128],
        metadata={"help": "Comma-separated list of channel multipliers for each level."},
    )
    autoencoder_num_res_blocks: int = field(
        default=2, metadata={"help": "Number of residual blocks per level."}
    )
    groups: int = field(default=32, metadata={"help": "Number of groups for GroupNorm."})
    kl_weight: float = field(default=1.0, metadata={"help": "Weight of the KL loss."})


@dataclass
class ClipConfig(BaseConfig):
    """JAX: stable_diffusion_pytorch_tpu/models/clip.py:ClipConfig."""

    tokenizer: str = field(
        default="runwayml/stable-diffusion-v1-5",
        metadata={"help": "Tokenizer to use for text encoding."},
    )
    text_encoder: str = field(
        default="runwayml/stable-diffusion-v1-5",
        metadata={"help": "Text encoder model to use."},
    )
    max_seq_len: int = field(
        default=77, metadata={"help": "Maximum sequence length for tokenized text."}
    )
    model_dir: Optional[str] = field(
        default="data/pretrained",
        metadata={"help": "Path to a directory to store the pretrained CLIP model."},
    )


@dataclass
class DDPMConfig(BaseConfig):
    """JAX: stable_diffusion_pytorch_tpu/models/schedule.py:DDPMConfig."""

    noise_schedule: str = field(
        default="linear",
        metadata={
            "help": "Noise schedule type.",
            "choices": ["linear", "cosine", "cubic"],
        },
    )
    noise_steps: int = field(default=1000, metadata={"help": "Number of noise steps."})
    beta_start: float = field(default=1e-4, metadata={"help": "Starting value of beta."})
    beta_end: float = field(default=0.02, metadata={"help": "Ending value of beta."})
    zero_terminal_snr: bool = field(
        default=False,
        metadata={
            "help": "rescale betas so alpha_bar(T) = 0 (Lin et al. 2023, "
            "'Common Diffusion Noise Schedules and Sample Steps are Flawed'). "
            "Requires --prediction-type v_prediction (eps is undefined at "
            "SNR 0); sample with --timestep-spacing trailing."
        },
    )
