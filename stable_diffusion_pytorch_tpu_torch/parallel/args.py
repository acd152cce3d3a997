"""Parallelism / runtime configuration (copy of the JAX package's ``parallel/args.py``).

The same fields, defaults and help strings (a test pins them equal). The port
runs one process per device (``torchrun``; ``parallel/distributed.py``):
``num_devices`` must equal the data size when given, ``shard_optimizer_state``
is ZeRO over the data group (``parallel/data_parallel.py``),
``offload_optimizer`` keeps the moments in pinned host memory between steps,
``shard_params`` is FSDP2 (``parallel/fsdp.py``), ``mixed_precision`` picks
the compute dtype and ``remat_policy`` the UNet's per-block remat;
``tensor_parallel`` T above 1 splits the attention and feed-forward
weights of the UNet trainer over model groups of T adjacent ranks
(``parallel/tensor_parallel.py``), and ``use_pallas_attention`` changes
nothing (the kernels always run).
"""

from dataclasses import dataclass, field
from typing import Optional

from stable_diffusion_pytorch_tpu_torch.config import BaseConfig


@dataclass
class ParallelConfig(BaseConfig):
    num_devices: Optional[int] = field(
        default=None,
        metadata={"help": "Devices for the data mesh axis. Default: all local devices."},
    )
    mixed_precision: str = field(
        default="bf16",
        metadata={
            "help": "Compute dtype for model forward/backward.",
            "choices": ["no", "bf16", "fp16", "fp32"],
        },
    )
    shard_optimizer_state: bool = field(
        default=False,
        metadata={"help": "Shard optax state along the data axis (ZeRO-2 analog)."},
    )
    offload_optimizer: bool = field(
        default=False,
        metadata={
            "help": "Keep optimizer state in host memory between steps "
            "(DeepSpeed offload_optimizer_device='cpu' analog, "
            "train_unet.py:101-109): moments live in pinned host RAM and "
            "stream to the device only inside the update."
        },
    )
    shard_params: bool = field(
        default=False,
        metadata={
            "help": "Shard model parameters along the data axis (FSDP analog); "
            "XLA inserts the all-gather/reduce-scatter pattern."
        },
    )
    tensor_parallel: int = field(
        default=1,
        metadata={
            "help": "Model-parallel group size: attention/FFN weights split "
            "over a second mesh axis (Megatron-style column/row parallel, "
            "heads-sharded flash attention). Beyond the reference, which is "
            "data-parallel only."
        },
    )
    remat_policy: str = field(
        default="none",
        metadata={
            "help": "jax.checkpoint policy for the UNet blocks: full = "
            "per-block remat (recompute everything; fits batch 16), "
            "conv-save = save only ResBlock conv outputs (recompute "
            "GN/SiLU/attention; the selective middle ground), "
            "dots_saveable = save dot_general outputs.",
            "choices": ["none", "full", "conv-save", "dots_saveable"],
        },
    )
    use_pallas_attention: bool = field(
        default=True,
        metadata={"help": "Use the Pallas flash-attention kernel on TPU (XLA fallback elsewhere)."},
    )
