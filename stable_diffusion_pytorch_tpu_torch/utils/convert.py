"""JAX parameter trees -> the port's state dicts (no jax needed).

Input: the JAX package's parameter trees as nested dicts of numpy arrays (a
``{"params": ...}`` wrapper is accepted). Output: ``{name: np.ndarray}`` that
the port's modules load with ``load_state_dict(..., strict=True)`` after
``torch.from_numpy``.

- UNet and VAE: reference torch names. This re-implements
  ``stable_diffusion_pytorch_tpu/utils/torch_port.py:export_reference_unet``
  and ``export_reference_autoencoder`` over the port's own block plans; a test
  holds the two equal on the same tree.
- CLIP: HF ``CLIPTextModel`` names, the inverse of the JAX package's
  ``models/clip.py:convert_text_tower``.
- ControlNet (:func:`controlnet_state_dict`): the port's ``models/controlnet.py``
  names (the UNet's for the encoder copy).
- LoRA (:func:`lora_state_dict`): a JAX LoRA tree (``{"lora_a", "lora_b"}``
  at each factored kernel) -> ``{"<module>.lora_a", "<module>.lora_b"}`` by
  the UNet's names, through the same attention and feed-forward name tables
  as the weights; the factors keep their orientation.

Layouts: conv kernel [kh, kw, I, O] -> weight [O, I, kh, kw]; dense kernel
[I, O] -> weight [O, I]; norm scale -> weight.

Optimizer state (:func:`unet_optimizer_state`): the JAX package's
``FusedAccumState`` around ``FusedAdamWState`` or around the 8-bit chain's
``ScaleByAdam8bitState`` -> the port's optimizer ``state_dict``. Each leaf's
moments, accumulator, int8 codes and scales take the same transpose as its
weight; a scale ``[..., nb, 1]`` or ``[..., 1]`` is first read as the weight's
rank with ``nb`` in the minor place, so it lands as ``[nb, *shape[1:]]``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from stable_diffusion_pytorch_tpu_torch.models.unet import plan_input_blocks, plan_output_blocks

StateDict = Dict[str, np.ndarray]


def _params(tree: Dict) -> Dict:
    return tree["params"] if "params" in tree else tree


def _conv(p: Dict, sd: StateDict, prefix: str) -> None:
    sd[f"{prefix}.weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _dense(p: Dict, sd: StateDict, prefix: str) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _norm(p: Dict, sd: StateDict, prefix: str) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def resblock(p: Dict, sd: StateDict, prefix: str) -> None:
    _norm(p["in_norm"], sd, f"{prefix}.in_layers.0")
    _conv(p["in_conv"], sd, f"{prefix}.in_layers.2")
    _norm(p["out_norm"], sd, f"{prefix}.out_layers.0")
    _conv(p["out_conv"], sd, f"{prefix}.out_layers.3")
    if "time_proj" in p:
        _dense(p["time_proj"], sd, f"{prefix}.time_embedding.1")
    if "skip" in p:
        _conv(p["skip"], sd, f"{prefix}.skip_connection")


# (JAX path inside a transformer block, the port's module name)
_ATTN_LINEARS = ((("to_q",), "to_q"), (("to_k",), "to_k"), (("to_v",), "to_v"), (("out",), "out.0"))
_FFN_LINEARS = ((("ffn", "geglu", "proj"), "ffn.net.0.proj"), (("ffn", "out"), "ffn.net.2"))


def _get(p: Dict, path):
    for key in path:
        if not isinstance(p, dict) or key not in p:
            return None
        p = p[key]
    return p


def cross_attention(p: Dict, sd: StateDict, prefix: str) -> None:
    for path, name in _ATTN_LINEARS:
        _dense(_get(p, path), sd, f"{prefix}.{name}")


def _transformer_linears(p: Dict, prefix: str, n_layers: int):
    """(JAX subtree, port module) of every linear layer of a transformer's
    blocks that ``p`` holds."""
    for i in range(n_layers):
        ref = f"{prefix}.transformer_blocks.{i}"
        for attn in ("self_attn", "cross_attn"):
            for path, name in _ATTN_LINEARS:
                if (leaf := _get(p, (f"block_{i}", attn, *path))) is not None:
                    yield leaf, f"{ref}.{attn}.{name}"
        for path, name in _FFN_LINEARS:
            if (leaf := _get(p, (f"block_{i}", *path))) is not None:
                yield leaf, f"{ref}.{name}"


def spatial_transformer(p: Dict, sd: StateDict, prefix: str, n_layers: int) -> None:
    _norm(p["norm"], sd, f"{prefix}.norm")
    _conv(p["proj_in"], sd, f"{prefix}.proj_in")
    _conv(p["proj_out"], sd, f"{prefix}.proj_out")
    for leaf, name in _transformer_linears(p, prefix, n_layers):
        _dense(leaf, sd, name)
    for i in range(n_layers):
        for n in ("norm1", "norm2", "norm3"):
            _norm(p[f"block_{i}"][n], sd, f"{prefix}.transformer_blocks.{i}.{n}")


def _unet_transformers(unet_cfg):
    """(JAX name, port prefix) of every SpatialTransformer of the UNet."""
    in_plan, skips, mid_ch, _, attn_mult = plan_input_blocks(
        unet_cfg.channels_list[0], unet_cfg.channels_list, unet_cfg.num_res_blocks, unet_cfg.attention_resolutions)
    out_plan, _ = plan_output_blocks(unet_cfg.channels_list, unet_cfg.num_res_blocks,
                                     unet_cfg.attention_resolutions, skips, mid_ch, attn_mult)
    yield "mid_attn", "middle_block.1"
    for i, block in enumerate(in_plan):
        if block[0] == "res" and block[3]:
            yield f"in_{i}_attn", f"input_blocks.{i}.1"
    for i, entry in enumerate(out_plan):
        if entry[3]:
            yield f"out_{i}_attn", f"output_blocks.{i}.1"


def lora_state_dict(tree: Dict, unet_cfg) -> StateDict:
    """JAX LoRA tree (``models/lora.py:init_lora``) -> the port's LoRA dict
    (``models/lora.py``): ``lora_a`` [in, r] and ``lora_b`` [r, out] as they are."""
    p = _params(tree)
    sd: StateDict = {}
    for jax_name, prefix in _unet_transformers(unet_cfg):
        if jax_name in p:
            for leaf, name in _transformer_linears(p[jax_name], prefix, unet_cfg.n_layers):
                sd[f"{name}.lora_a"] = np.asarray(leaf["kernel"]["lora_a"])
                sd[f"{name}.lora_b"] = np.asarray(leaf["kernel"]["lora_b"])
    known = {j for j, _ in _unet_transformers(unet_cfg)}
    if set(p) - known:
        raise ValueError(f"LoRA factors outside the UNet's transformers: {sorted(set(p) - known)}")
    return sd


def unet_state_dict(tree: Dict, unet_cfg) -> StateDict:
    """JAX UNetModel params -> the port's UNetModel state dict."""
    p = _params(tree)
    sd: StateDict = {}
    _dense(p["time_fc1"], sd, "time_embedding.0")
    _dense(p["time_fc2"], sd, "time_embedding.2")
    _conv(p["conv_in"], sd, "conv_in")
    _norm(p["out_norm"], sd, "out.0")
    _conv(p["conv_out"], sd, "out.2")
    resblock(p["mid_res1"], sd, "middle_block.0")
    spatial_transformer(p["mid_attn"], sd, "middle_block.1", unet_cfg.n_layers)
    resblock(p["mid_res2"], sd, "middle_block.2")

    in_plan, skips, mid_ch, _, attn_mult = plan_input_blocks(
        unet_cfg.channels_list[0], unet_cfg.channels_list,
        unet_cfg.num_res_blocks, unet_cfg.attention_resolutions,
    )
    for i, block in enumerate(in_plan):
        ref = f"input_blocks.{i}"
        if block[0] == "res":
            resblock(p[f"in_{i}_res"], sd, f"{ref}.0")
            if block[3]:
                spatial_transformer(p[f"in_{i}_attn"], sd, f"{ref}.1", unet_cfg.n_layers)
        else:
            _conv(p[f"in_{i}_down"]["conv"], sd, f"{ref}.0.conv")

    out_plan, _ = plan_output_blocks(
        unet_cfg.channels_list, unet_cfg.num_res_blocks, unet_cfg.attention_resolutions,
        skips, mid_ch, attn_mult,
    )
    for i, (_, _, _, attn, upsample) in enumerate(out_plan):
        ref = f"output_blocks.{i}"
        resblock(p[f"out_{i}_res"], sd, f"{ref}.0")
        idx = 1
        if attn:
            spatial_transformer(p[f"out_{i}_attn"], sd, f"{ref}.{idx}", unet_cfg.n_layers)
            idx += 1
        if upsample:
            _conv(p[f"out_{i}_up"]["conv"], sd, f"{ref}.{idx}.0.conv")
    return sd


def controlnet_state_dict(tree: Dict, unet_cfg) -> StateDict:
    """JAX ControlNet params -> the port's ControlNet state dict."""
    p = _params(tree)
    sd: StateDict = {}
    _dense(p["time_fc1"], sd, "time_embedding.0")
    _dense(p["time_fc2"], sd, "time_embedding.2")
    _conv(p["conv_in"], sd, "conv_in")
    hint = p["hint_embedding"]
    _conv(hint["conv_in"], sd, "input_hint_block.0")
    i = 0
    while f"conv_pre_{i}" in hint:
        _conv(hint[f"conv_pre_{i}"], sd, f"input_hint_block.{2 + 4 * i}")
        _conv(hint[f"conv_down_{i}"], sd, f"input_hint_block.{4 + 4 * i}")
        i += 1
    _conv(hint["conv_out"], sd, f"input_hint_block.{2 + 4 * i}")
    in_plan, _, _, _, _ = plan_input_blocks(
        unet_cfg.channels_list[0], unet_cfg.channels_list, unet_cfg.num_res_blocks, unet_cfg.attention_resolutions)
    _conv(p["zero_conv_0"], sd, "zero_convs.0")
    for i, block in enumerate(in_plan):
        ref = f"input_blocks.{i}"
        if block[0] == "res":
            resblock(p[f"in_{i}_res"], sd, f"{ref}.0")
            if block[3]:
                spatial_transformer(p[f"in_{i}_attn"], sd, f"{ref}.1", unet_cfg.n_layers)
        else:
            _conv(p[f"in_{i}_down"]["conv"], sd, f"{ref}.0.conv")
        _conv(p[f"zero_conv_{i + 1}"], sd, f"zero_convs.{i + 1}")
    resblock(p["mid_res1"], sd, "middle_block.0")
    spatial_transformer(p["mid_attn"], sd, "middle_block.1", unet_cfg.n_layers)
    resblock(p["mid_res2"], sd, "middle_block.2")
    _conv(p["zero_conv_mid"], sd, "middle_block_out")
    return sd


def _vae_bottleneck(p: Dict, sd: StateDict, prefix: str) -> None:
    resblock(p["res1"], sd, f"{prefix}.0")
    cross_attention(p["attn"], sd, f"{prefix}.1")
    resblock(p["res2"], sd, f"{prefix}.2")


def autoencoder_state_dict(tree: Dict, vae_cfg) -> StateDict:
    """JAX AutoEncoderKL params -> the port's AutoEncoderKL state dict."""
    p = _params(tree)
    channels = vae_cfg.autoencoder_channels_list
    nres = vae_cfg.autoencoder_num_res_blocks
    sd: StateDict = {}

    enc = p["encoder"]
    _conv(enc["conv_in"], sd, "encoder.conv_in")
    _vae_bottleneck(enc["bottleneck"], sd, "encoder.bottleneck")
    _norm(enc["out_norm"], sd, "encoder.out.0")
    _conv(enc["out_conv"], sd, "encoder.out.2")
    in_plan, _, _, _, _ = plan_input_blocks(channels[0], channels, nres, None)
    for i, block in enumerate(in_plan):
        ref = f"encoder.down.{i}"
        if block[0] == "res":
            resblock(enc[f"down_{i}_res"], sd, f"{ref}.0")
        else:
            _conv(enc[f"down_{i}"]["conv"], sd, f"{ref}.0.conv")

    dec = p["decoder"]
    _conv(dec["conv_in"], sd, "decoder.conv_in")
    _vae_bottleneck(dec["bottleneck"], sd, "decoder.bottleneck")
    _norm(dec["out_norm"], sd, "decoder.out.0")
    _conv(dec["out_conv"], sd, "decoder.out.2")
    out_plan, _ = plan_output_blocks(channels, nres, None, [], channels[0], 0)
    for i, (_, _, _, _, upsample) in enumerate(out_plan):
        ref = f"decoder.up.{i}"
        resblock(dec[f"up_{i}_res"], sd, f"{ref}.0")
        if upsample:
            _conv(dec[f"up_{i}"]["conv"], sd, f"{ref}.1.0.conv")

    _conv(p["quant_conv"], sd, "quant_conv")
    _conv(p["post_quant_conv"], sd, "post_quant_conv")
    return sd


def clip_state_dict(tree: Dict) -> StateDict:
    """JAX CLIPTextTransformer params -> HF CLIPTextModel names."""
    p = _params(tree)
    pre = "text_model."
    sd: StateDict = {
        f"{pre}embeddings.token_embedding.weight": np.asarray(p["token_embedding"]["embedding"]),
        f"{pre}embeddings.position_embedding.weight": np.asarray(p["position_embedding"]),
    }
    i = 0
    while f"layer_{i}" in p:
        lp = p[f"layer_{i}"]
        ref = f"{pre}encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(lp[name], sd, f"{ref}.self_attn.{name}")
        _dense(lp["fc1"], sd, f"{ref}.mlp.fc1")
        _dense(lp["fc2"], sd, f"{ref}.mlp.fc2")
        _norm(lp["layer_norm1"], sd, f"{ref}.layer_norm1")
        _norm(lp["layer_norm2"], sd, f"{ref}.layer_norm2")
        i += 1
    _norm(p["final_layer_norm"], sd, f"{pre}final_layer_norm")
    return sd


def to_torch(sd: StateDict) -> Dict[str, torch.Tensor]:
    """numpy state dict -> float32 tensors for ``load_state_dict``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in sd.items()}


def _as_weight_rank(scale, param) -> np.ndarray:
    """A JAX int8 scale ([..., nb, 1] or [..., 1]) in its parameter's rank,
    nb in the minor place, so the weight's transpose applies to it."""
    scale, lead = np.asarray(scale), tuple(np.shape(param))[:-1]
    return scale.reshape(lead + (scale.size // max(int(np.prod(lead)), 1),))


def _dtype_name(a) -> str:
    return {"float32": "f32", "bfloat16": "bf16"}[str(np.asarray(a).dtype)]


def unet_optimizer_state(state, params: Dict, unet_cfg, names: List[str]) -> Dict:
    """JAX UNet optimizer state (numpy leaves) -> the port's optimizer
    ``state_dict`` over the parameters ``names`` (the port's order).

    ``state``: a ``FusedAccumState`` (``mini_step``, ``acc``, ``inner``), or
    its inner state alone. The inner state is a ``FusedAdamWState``
    (``count``, ``mu``, ``nu``) or the 8-bit chain's tuple, which holds a
    ``ScaleByAdam8bitState`` whose ``mu``/``nu`` leaves carry ``q`` and
    ``scale``. ``params`` is the JAX parameter tree (for the leaves' ranks).
    Arrays keep their dtypes (bf16 as numpy's extension type, which a
    caller widens to f32 before ``torch.from_numpy``; the copy into a bf16
    tensor is then exact)."""
    params = _params(params)

    def port(tree) -> List[np.ndarray]:
        sd = unet_state_dict(tree, unet_cfg)
        return [np.ascontiguousarray(sd[n]) for n in names]

    inner = getattr(state, "inner", state)
    acc = getattr(state, "acc", None)
    out = {"count": None, "mini_step": int(getattr(state, "mini_step", 0)),
           "acc": None if acc is None else port(_params(acc))}
    layout = {"gradient_accumulation": acc is not None,
              "accum_dtype": None if acc is None else _dtype_name(out["acc"][0])}
    adam = _find_adam(inner)
    if adam is None:
        raise ValueError("no Adam state (FusedAdamWState or ScaleByAdam8bitState) in the optimizer state")
    out["count"] = int(np.asarray(adam.count))
    mu, nu = _params(adam.mu), _params(adam.nu)
    first = mu
    while isinstance(first, dict):
        first = next(iter(first.values()))
    if not hasattr(first, "q"):
        out.update(mu=port(mu), nu=port(nu))
        out["layout"] = {**layout, "use_8bit_adam": False, "adam_mu_dtype": _dtype_name(out["mu"][0]),
                         "adam_nu_dtype": _dtype_name(out["nu"][0])}
        return out
    out["layout"] = {**layout, "use_8bit_adam": True}
    for name, tree in (("mu", mu), ("nu", nu)):
        out[f"{name}_q"] = port(_map_with(tree, params, lambda qt, p: np.asarray(qt.q)))
        out[f"{name}_scale"] = port(_map_with(tree, params, lambda qt, p: _as_weight_rank(qt.scale, p)))
    return out


def _find_adam(state):
    """The first state in (nested chain tuples of) ``state`` that holds ``mu``."""
    if hasattr(state, "mu"):
        return state
    if isinstance(state, tuple):
        return next((found for s in state if (found := _find_adam(s)) is not None), None)
    return None


def _map_with(tree, other, fn):
    if isinstance(tree, dict):
        return {k: _map_with(v, other[k], fn) for k, v in tree.items()}
    return fn(tree, other)
