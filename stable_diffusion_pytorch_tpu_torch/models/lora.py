"""LoRA merge for sampling and for training (port of stable_diffusion_pytorch_tpu/models/lora.py).

A LoRA holds rank-r factors for some of the UNet's linear weights; sampling
merges them into the base weights once, ``W_eff = W + scale * (A @ B)^T``,
and the UNet runs unchanged. The port's layout, keyed by the UNet's state-dict
names: ``{"<module>.lora_a": [in, r], "<module>.lora_b": [r, out]}`` for the
``nn.Linear`` ``<module>`` whose ``weight`` is ``[out, in]`` (the JAX
package's ``lora_a``/``lora_b`` orientation, so ``utils/convert.py:
lora_state_dict`` only renames). A LoRA checkpoint is a ``train_state.pt``
(``utils/checkpoint.py``) whose ``params`` (or ``ema_params``) is that dict.

The merge runs in float32 on float32 weights, before any cast to the
inference dtype, as the JAX package merges into its f32 parameters and rounds
once, at compute. The target sets are the JAX package's: ``attn`` (to_q,
to_k, to_v and out of every self- and cross-attention) and ``attn_mlp``
(also the GEGLU projection and the feed-forward output).

Training (the JAX package's ``merge_lora`` as the train step's
``param_transform``): :func:`lora_weights` forms the factored weights
``W + scale * (A @ B)^T`` from the frozen f32 base and the trainable factors,
differentiable in the factors, in float32 with autocast off, so that autocast
rounds once, at the layer's matmul; :func:`substituted` runs the UNet with
them in place of its parameters, through the forward and the backward (a
per-block remat recomputes inside the backward and must see them too).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch

_ATTN_MODULES = ("self_attn", "cross_attn")
_ATTN_LEAVES = ("to_q", "to_k", "to_v", "out.0")
_MLP_SUFFIXES = ("ffn.net.0.proj", "ffn.net.2")

TARGET_SETS = ("attn", "attn_mlp")


def is_lora_target(name: str, param: torch.Tensor, targets: str) -> bool:
    """True if the UNet parameter ``name`` takes a LoRA factor: a 2-D
    ``weight`` of an attention projection (``attn``), or also of the
    feed-forward (``attn_mlp``)."""
    if targets not in TARGET_SETS:
        raise ValueError(f"unknown lora targets {targets!r}; use one of {TARGET_SETS}")
    if not name.endswith(".weight") or param.dim() != 2:
        return False
    module = name[: -len(".weight")]
    if any(module.endswith(f".{parent}.{leaf}") for parent in _ATTN_MODULES for leaf in _ATTN_LEAVES):
        return True
    return targets == "attn_mlp" and module.endswith(_MLP_SUFFIXES)


def init_lora(state_dict: Dict[str, torch.Tensor], rank: int, targets: str = "attn",
              generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """A fresh LoRA for the UNet weights ``state_dict``: at every target,
    ``lora_a`` [in, r] ~ N(0, 1/r) and ``lora_b`` [r, out] = 0 (Hu et al. 2021
    §4.1: step 0 is the base model), in float32 on the weight's device."""
    if rank <= 0:
        raise ValueError(f"lora rank must be positive, got {rank}")
    lora = {}
    for name, w in state_dict.items():
        if is_lora_target(name, w, targets):
            module = name[: -len(".weight")]
            d_out, d_in = w.shape
            a = torch.randn((d_in, rank), generator=generator, dtype=torch.float32, device=w.device)
            lora[f"{module}.lora_a"] = a / rank ** 0.5
            lora[f"{module}.lora_b"] = torch.zeros((rank, d_out), dtype=torch.float32, device=w.device)
    if not lora:
        raise ValueError(f"no LoRA targets matched in the state dict (targets={targets!r})")
    return lora


@torch.no_grad()
def merge_lora(state_dict: Dict[str, torch.Tensor], lora: Dict[str, torch.Tensor],
               scale: float) -> Dict[str, torch.Tensor]:
    """A new state dict with ``W + scale * (A @ B)^T`` at every factored
    weight, computed in float32 and stored in the weight's dtype; every other
    tensor is the same object. A factor naming no weight, or of the wrong
    shape, raises before anything is merged."""
    modules = sorted({k.rsplit(".", 1)[0] for k in lora})
    for module in modules:
        a, b, w = lora.get(f"{module}.lora_a"), lora.get(f"{module}.lora_b"), state_dict.get(f"{module}.weight")
        if a is None or b is None or w is None:
            raise ValueError(f"LoRA factor {module!r} has no lora_a/lora_b pair or no UNet weight")
        if (a.shape[0], b.shape[1]) != (w.shape[1], w.shape[0]) or a.shape[1] != b.shape[0]:
            raise ValueError(f"LoRA factor {module!r}: {tuple(a.shape)} @ {tuple(b.shape)} does not fit "
                             f"the weight {tuple(w.shape)}")
    out = dict(state_dict)
    for module in modules:
        w = state_dict[f"{module}.weight"]
        a, b = (lora[f"{module}.lora_{s}"].to(device=w.device, dtype=torch.float32) for s in "ab")
        out[f"{module}.weight"] = (w.float() + scale * (a @ b).T).to(w.dtype)
    return out


def lora_param_count(lora: Dict[str, torch.Tensor]) -> int:
    return sum(int(t.numel()) for t in lora.values())


def lora_weights(base: Dict[str, torch.Tensor], lora: Dict[str, torch.Tensor], scale: float) -> Dict[str, torch.Tensor]:
    """The factored weights only, ``{"<module>.weight": W + scale * (A @ B)^T}``,
    from the float32 base weights ``base`` (by the UNet's names), computed in
    float32 with autocast off and differentiable in the factors."""
    out = {}
    with torch.autocast("cuda", enabled=False), torch.autocast("cpu", enabled=False):
        for module in sorted({k.rsplit(".", 1)[0] for k in lora}):
            w = base[f"{module}.weight"]
            a, b = lora[f"{module}.lora_a"], lora[f"{module}.lora_b"]
            out[f"{module}.weight"] = w.float() + scale * (a.float() @ b.float()).t()
    return out


@contextlib.contextmanager
def substituted(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> Iterator[None]:
    """Run ``module`` with ``tensors`` (by parameter name) in place of those
    parameters until the block exits. Each tensor goes into its owner's
    instance dict, which attribute lookup reads before ``nn.Module`` looks
    in ``_parameters``: the parameters themselves stay registered, in order."""
    owners = []
    try:
        for name, t in tensors.items():
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            if leaf not in owner._parameters:
                raise KeyError(f"{name!r} is not a parameter of the module")
            owner.__dict__[leaf] = t
            owners.append((owner, leaf))
        yield
    finally:
        for owner, leaf in owners:
            del owner.__dict__[leaf]
