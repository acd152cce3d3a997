"""InceptionV3 up to the pool3 feature, for FID (port of stable_diffusion_pytorch_tpu/models/inception.py).

torchvision's ``inception_v3`` (the IMAGENET1K_V1 layout) without its
classifier, with the JAX package's parameter structure: each
``BasicConv2d`` is a conv without bias (``<block>.conv.weight``, torch's
[O, I, kh, kw]), then the inference-mode BatchNorm folded into a
per-channel ``bn_scale`` and ``bn_bias``, then ReLU. So the ``.npz`` that
``tools/convert_inception.py`` writes (the JAX tree: ``<block>/conv/kernel``
[kh, kw, I, O], ``<block>/bn_scale``, ``<block>/bn_bias``) loads with a
transpose, and a torchvision state dict loads through
:func:`convert_torchvision_inception` (BatchNorm eps 1e-3 folded in float64).

Conventions (torchvision's, which the JAX package's tests hold): symmetric
padding and floor semantics at stride 2; the branch average pools 3x3,
stride 1, pad 1, counting the padding; max pools 3x3 stride 2; the feature
the mean of ``Mixed_7c`` over space, [B, 2048]. ``transform_input``
remaps [-1, 1] inputs to ImageNet normalization, as torchvision's ``inception_v3``
forces for pretrained weights.

Input [B, H, W, 3] channel-last in [-1, 1], as the JAX module takes it; the
tower runs channel-first inside. Its convs, affines and pools are cuDNN and
elementwise calls: the JAX package lowered them through XLA, with no Pallas
kernel, so the port has none for them either.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import read_weights

_BN_EPS = 1e-3  # torchvision BasicConv2d: BatchNorm2d(eps=0.001)


class BasicConv2d(nn.Module):
    """Conv (no bias) + folded-BN affine + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride=stride, padding=padding, bias=False)
        self.bn_scale = nn.Parameter(torch.ones(out_channels))
        self.bn_bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv(x) * self.bn_scale[:, None, None] + self.bn_bias[:, None, None])


def _avg3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max3s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, _max3s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg3(x))], dim=1)


class InceptionV3Pool3(nn.Module):
    """[B, H, W, 3] in [-1, 1] (299x299 for FID; 75x75 at the least) ->
    pool3 features [B, 2048] float32."""

    def __init__(self, transform_input: bool = False):
        super().__init__()
        self.transform_input = transform_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        # transform_input's ImageNet statistics, on the module's device (a
        # forward makes no host copy, so a CUDA graph can capture it)
        self.register_buffer("input_std", torch.tensor([0.229, 0.224, 0.225], dtype=torch.float64), persistent=False)
        self.register_buffer("input_mean", torch.tensor([0.485, 0.456, 0.406], dtype=torch.float64), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.Conv2d_1a_3x3.conv.weight.dtype
        x = x.to(dtype)
        if self.transform_input:
            scale = self.input_std.to(dtype) / 0.5
            shift = (self.input_mean.to(dtype) - 0.5) / 0.5
            x = x * scale + shift
        x = x.permute(0, 3, 1, 2)
        for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            x = getattr(self, name)(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max3s2(x)))
        x = _max3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
                     "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3)).float()


def _fold_bn(state: dict, prefix: str):
    """Inference-mode BatchNorm (eps 1e-3) as a per-channel (scale, bias),
    folded in float64, returned float32."""
    gamma, beta, mean, var = (torch.as_tensor(np.asarray(state[prefix + "bn." + k]), dtype=torch.float64)
                              for k in ("weight", "bias", "running_mean", "running_var"))
    scale = gamma / torch.sqrt(var + _BN_EPS)
    return scale.float(), (beta - mean * scale).float()


def convert_torchvision_inception(state: dict) -> Dict[str, torch.Tensor]:
    """A torchvision ``inception_v3`` state dict (torch or numpy values) ->
    :class:`InceptionV3Pool3`'s state dict; ``fc`` and ``AuxLogits`` are left out."""
    out = {}
    for key in state:
        if key.endswith(".bn.running_var") and not key.startswith("AuxLogits"):
            prefix = key[: -len("bn.running_var")]
            out[prefix + "conv.weight"] = torch.as_tensor(np.asarray(state[prefix + "conv.weight"]), dtype=torch.float32)
            out[prefix + "bn_scale"], out[prefix + "bn_bias"] = _fold_bn(state, prefix)
    return out


def inception_state_from_tree(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX package's params, flattened with ``/`` as the ``.npz`` of
    ``tools/convert_inception.py`` holds them (a leading ``params/`` is
    dropped) -> :class:`InceptionV3Pool3`'s state dict (conv kernels
    [kh, kw, I, O] transposed to [O, I, kh, kw])."""
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        value = torch.from_numpy(np.ascontiguousarray(value))
        if parts[-1] == "kernel":
            out[".".join(parts[:-1]) + ".weight"] = value.permute(3, 2, 0, 1).contiguous()
        else:
            out[".".join(parts)] = value
    return out


def inception_tree(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """:class:`InceptionV3Pool3`'s state dict -> the JAX package's parameter
    tree flattened with ``/``, as ``tools/convert_inception.py`` writes it
    (the inverse of :func:`inception_state_from_tree`): for each
    ``BasicConv2d`` in the tower's order, ``<block>/conv/kernel`` [kh, kw, I,
    O], ``<block>/bn_scale``, ``<block>/bn_bias``, float32."""
    with torch.device("meta"):
        names = [n for n, m in InceptionV3Pool3().named_modules() if isinstance(m, BasicConv2d)]
    flat = {}
    for name in names:
        path = name.replace(".", "/")
        value = lambda key: state[f"{name}.{key}"].detach().cpu().numpy().astype(np.float32)  # noqa: E731
        flat[f"{path}/conv/kernel"] = np.ascontiguousarray(value("conv.weight").transpose(2, 3, 1, 0))
        flat[f"{path}/bn_scale"], flat[f"{path}/bn_bias"] = value("bn_scale"), value("bn_bias")
    return flat


def load_inception_state(model_dir: Optional[str] = "data/pretrained") -> Optional[Dict[str, torch.Tensor]]:
    """Staged Inception weights under ``{model_dir}/inception/``, in the JAX
    package's order: ``inception_v3.npz`` (the JAX tree), then
    ``inception_v3.safetensors``, then ``inception_v3.pth`` (torchvision state
    dicts) -> :class:`InceptionV3Pool3`'s state dict, or None."""
    if not model_dir:
        return None
    root = os.path.join(model_dir, "inception")
    npz = os.path.join(root, "inception_v3.npz")
    if os.path.exists(npz):
        with np.load(npz) as f:
            return inception_state_from_tree({k: f[k] for k in f.files})
    for name in ("inception_v3.safetensors", "inception_v3.pth"):
        path = os.path.join(root, name)
        if os.path.exists(path):
            return convert_torchvision_inception(read_weights(path))
    return None
