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

Layouts: conv kernel [kh, kw, I, O] -> weight [O, I, kh, kw]; dense kernel
[I, O] -> weight [O, I]; norm scale -> weight.
"""

from __future__ import annotations

from typing import Dict

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


def cross_attention(p: Dict, sd: StateDict, prefix: str) -> None:
    for name in ("to_q", "to_k", "to_v"):
        _dense(p[name], sd, f"{prefix}.{name}")
    _dense(p["out"], sd, f"{prefix}.out.0")


def spatial_transformer(p: Dict, sd: StateDict, prefix: str, n_layers: int) -> None:
    _norm(p["norm"], sd, f"{prefix}.norm")
    _conv(p["proj_in"], sd, f"{prefix}.proj_in")
    _conv(p["proj_out"], sd, f"{prefix}.proj_out")
    for i in range(n_layers):
        b = p[f"block_{i}"]
        ref = f"{prefix}.transformer_blocks.{i}"
        cross_attention(b["self_attn"], sd, f"{ref}.self_attn")
        cross_attention(b["cross_attn"], sd, f"{ref}.cross_attn")
        for n in ("norm1", "norm2", "norm3"):
            _norm(b[n], sd, f"{ref}.{n}")
        _dense(b["ffn"]["geglu"]["proj"], sd, f"{ref}.ffn.net.0.proj")
        _dense(b["ffn"]["out"], sd, f"{ref}.ffn.net.2")


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
