"""Config system and the model config dataclasses (port of stable_diffusion_pytorch_tpu/config.py).

Dataclasses -> argparse flags -> a nested ``ConfigNode``, with the JAX
package's flag names, defaults, choices and help strings (and its quirk that a
bool field defaulting to True becomes a ``store_false`` flag). ``BaseConfig``,
``ConfigNode``, ``add_dataclass_args`` and ``dataclasses_to_confignode`` are
copies of the JAX package's stdlib-only helpers; the JAX ``load_config``
imports its flax modules to collect the dataclasses, so the port declares its
own copies of those too. Tests pin each field (name, default, help, choices)
equal to the JAX dataclass.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import re
import sys
from dataclasses import MISSING, dataclass, field, fields
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple, Type

__all__ = [
    "AutoencoderConfig",
    "BaseConfig",
    "ClipConfig",
    "ConfigNode",
    "DDPMConfig",
    "UnetConfig",
    "add_dataclass_args",
    "load_config",
]


@dataclass
class BaseConfig:
    """Base dataclass with the introspection helpers the converter uses.

    Mirrors the helper surface of the reference ``BaseDataclass``
    (the reference's stable_diffusion/dataclass.py:25-68).
    """

    def _get_all_attributes(self) -> List[str]:
        return list(self.__dataclass_fields__.keys())

    def _get_meta(self, name: str, meta: str, default: Optional[Any] = None) -> Any:
        return self.__dataclass_fields__[name].metadata.get(meta, default)

    def _get_name(self, name: str) -> str:
        return self.__dataclass_fields__[name].name

    def _get_default(self, name: str) -> Any:
        f = self.__dataclass_fields__[name]
        if not isinstance(f.default_factory, dataclasses._MISSING_TYPE):
            return f.default_factory()
        return f.default

    def _get_type(self, name: str) -> Any:
        return self.__dataclass_fields__[name].type

    def _get_help(self, name: str) -> Any:
        return self._get_meta(name, "help")

    def _get_choices(self, name: str) -> Any:
        return self._get_meta(name, "choices")


class ConfigNode:
    """A mutable nested attribute container (minimal DictConfig stand-in)."""

    def __init__(self, **kwargs: Any) -> None:
        for k, v in kwargs.items():
            setattr(self, k, v)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.__dict__.items():
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else v
        return out

    def __repr__(self) -> str:
        return f"ConfigNode({self.__dict__!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, ConfigNode):
            return self.__dict__ == other.__dict__
        return NotImplemented


def _eval_str_list(x: Any, x_type: type = float) -> Optional[list]:
    """Parse "1,2" / "[1, 2]" / scalar into a typed list (parse_args.py:71-81)."""
    if x is None:
        return None
    if isinstance(x, str):
        if len(x) == 0:
            return []
        try:
            x = ast.literal_eval(x)
        except (ValueError, SyntaxError):
            x = [p for p in x.split(",") if p != ""]
    try:
        return list(map(x_type, x))
    except TypeError:
        return [x_type(x)]


def _interpret_type(field_type: Any) -> Any:
    """Unwrap Optional[T] / Union[T, None] to T (parse_args.py:83-95)."""
    if field_type is Any:
        return str
    typestring = str(field_type)
    if (
        re.match(r"(typing\.|^)Union\[(.*), NoneType\]$", typestring)
        or typestring.startswith("typing.Optional")
        or typestring.endswith("| None")
    ):
        return field_type.__args__[0]
    return field_type


def add_dataclass_args(
    parser: argparse.ArgumentParser, data_class: Type[BaseConfig]
) -> None:
    """Add one dataclass's fields to the parser as a named argument group.

    Field-name-to-flag mapping and bool/list/enum handling follow
    the reference's utils/parse_args.py:97-256.
    """
    group_name = data_class.__name__.lower().replace("config", "")
    group = parser.add_argument_group(group_name)
    instance = data_class()
    # resolve PEP 563 stringified annotations to real types
    import typing

    hints = typing.get_type_hints(data_class)

    for k in instance._get_all_attributes():
        if k == "_name":
            continue
        flag = "--" + k.replace("_", "-")
        field_type = hints.get(k, instance._get_type(k))
        inter_type = _interpret_type(field_type)
        default = instance._get_default(k)
        helpstr = instance._get_help(k)
        choices = instance._get_choices(k)

        kwargs: Dict[str, Any] = {"help": helpstr}
        if choices is not None:
            kwargs["choices"] = choices

        type_str = str(inter_type)
        is_list = (
            isinstance(inter_type, type)
            and issubclass(inter_type, (list, tuple))
        ) or ("List" in type_str or "Tuple" in type_str or "list[" in type_str)

        if is_list:
            if "int" in type_str:
                kwargs["type"] = lambda x: _eval_str_list(x, int)
            elif "float" in type_str:
                kwargs["type"] = lambda x: _eval_str_list(x, float)
            elif "str" in type_str:
                kwargs["type"] = lambda x: _eval_str_list(x, str)
            else:
                raise NotImplementedError(f"cannot parse list type {inter_type}")
            if default is not MISSING:
                kwargs["default"] = list(default) if default is not None else None
        elif (isinstance(inter_type, type) and issubclass(inter_type, Enum)) or (
            "Enum" in type_str
        ):
            kwargs["type"] = str
            if default is not MISSING:
                kwargs["default"] = (
                    default.value if isinstance(default, Enum) else default
                )
        elif inter_type is bool:
            # reference behavior: default True => store_false (parse_args.py:188-192)
            kwargs["action"] = "store_false" if default is True else "store_true"
            kwargs["default"] = default
            kwargs.pop("choices", None)
        else:
            kwargs["type"] = inter_type
            if default is MISSING:
                kwargs["required"] = True
            else:
                kwargs["default"] = default

        try:
            group.add_argument(flag, **kwargs)
        except argparse.ArgumentError:
            # duplicate flag across groups: first one wins (parse_args.py:249-256)
            pass


def dataclasses_to_confignode(
    data_classes: List[Type[BaseConfig]], args: argparse.Namespace
) -> ConfigNode:
    """Build {groupname: ConfigNode(fields...)} from parsed args
    (parse_args.py:292-302)."""
    cfg = ConfigNode()
    for data_class in data_classes:
        group_name = data_class.__name__.lower().replace("config", "")
        node = ConfigNode()
        for field_info in fields(data_class):
            name = field_info.name
            if hasattr(args, name):
                setattr(node, name, getattr(args, name))
        setattr(cfg, group_name, node)
    return cfg




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


def _train_data_classes() -> List[Type[BaseConfig]]:
    from stable_diffusion_pytorch_tpu_torch.trainers.args import (
        CheckpointConfig,
        LogConfig,
        OptimConfig,
        TrainConfig,
    )
    from stable_diffusion_pytorch_tpu_torch.utils.data import DatasetConfig

    return [LogConfig, TrainConfig, OptimConfig, DatasetConfig, CheckpointConfig]


def _extra_data_classes() -> List[Type[BaseConfig]]:
    from stable_diffusion_pytorch_tpu_torch.parallel.args import ParallelConfig
    from stable_diffusion_pytorch_tpu_torch.utils.compat import CompatConfig

    return [CompatConfig, ParallelConfig]


def load_config(
    argv: Optional[List[str]] = None,
    extra_data_classes: Optional[List[Type[BaseConfig]]] = None,
    parser_hook=None,
) -> Tuple[argparse.Namespace, ConfigNode]:
    """Parse CLI flags into (args, cfg) with the JAX package's flags and nested
    layout: ``cfg.{log,train,optim,dataset,checkpoint,compat,parallel}`` and
    ``cfg.model.{unet,autoencoder,clip,ddpm}``; ``extra_data_classes`` add an
    entry point's own groups (the server's ``cfg.serve``), as in the JAX package.

    ``--config-file preset.json`` loads a JSON dict of {field_name: value}
    defaults applied below explicit CLI flags (a path; the JAX package's preset
    directory is not searched). ``parser_hook(parser)`` may add entry-point
    flags (the port's ``--device``)."""
    base_dcs, extra_dcs = _train_data_classes(), _extra_data_classes() + list(extra_data_classes or [])
    model_dcs = [UnetConfig, AutoencoderConfig, ClipConfig, DDPMConfig]
    parser = argparse.ArgumentParser(description="stable_diffusion_pytorch_tpu_torch: stable diffusion in PyTorch")
    parser.add_argument("--config-file", type=str, default=None,
                        help="JSON file of flag defaults (CLI flags still win)")
    # the JAX package's order: a flag two groups share goes to the first
    for dc in base_dcs + model_dcs + extra_dcs:
        add_dataclass_args(parser, dc)
    if parser_hook is not None:
        parser_hook(parser)
    peek_argv = list(argv) if argv is not None else sys.argv[1:]
    if "--config-file" in peek_argv:
        path = peek_argv[peek_argv.index("--config-file") + 1]
        with open(path) as f:
            preset = json.load(f)
        values = {k: v for k, v in preset.items() if not k.startswith("_")}
        unknown = sorted(set(values) - {a.dest for a in parser._actions})
        if unknown:
            parser.error(f"unknown preset field(s) {unknown} in {path}")
        parser.set_defaults(**values)
    args = parser.parse_args(argv)
    cfg = dataclasses_to_confignode(base_dcs + extra_dcs, args)
    cfg.model = dataclasses_to_confignode(model_dcs, args)
    return args, cfg


def compat_from_cfg(cfg: ConfigNode):
    """The CompatConfig of a parsed config tree, with reference_compat fanned out."""
    from stable_diffusion_pytorch_tpu_torch.utils.compat import CompatConfig

    return CompatConfig(**cfg.compat.to_dict()).resolved()
