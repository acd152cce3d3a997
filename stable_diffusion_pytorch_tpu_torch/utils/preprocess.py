"""On-device image preprocessing (port of utils/preprocess.py).

With ``--device-preprocess`` the host only decodes each image to one fixed
[H0, W0, 3] uint8 buffer (short side at least the resolution); the resize,
crop, flip and normalize run on the batch's device inside the train step.

The resize is ``F.interpolate(mode="bilinear", antialias=True)``, the
counterpart of ``jax.image.resize(..., "bilinear")``, which also widens its
triangle filter when it shrinks; the two agree to within f32 rounding
(``tests/test_torch_port_data_options.py`` states the bar). The random crop
and the flip take their draws from the caller's generator, or as given.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def resized_size(h0: int, w0: int, resolution: int) -> Tuple[int, int]:
    """(new_h, new_w): the short side at ``resolution``, the long side scaled and rounded."""
    if h0 < w0:
        return resolution, max(resolution, round(w0 * resolution / h0))
    return max(resolution, round(h0 * resolution / w0)), resolution


def device_preprocess(
    images: torch.Tensor,
    resolution: int,
    center_crop: bool = True,
    random_flip: bool = False,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
    crop: Optional[Tuple[int, int]] = None,
    flip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, H0, W0, 3] uint8 -> [B, res, res, 3] in [-1, 1], on the images' device.

    Resize (bilinear, short side = ``resolution``), crop (the center, or
    with ``center_crop=False`` a window whose corner is ``crop`` = (top,
    left) or drawn from ``generator``, one for the batch), flip each row
    whose ``flip`` [B] bool is set (drawn from ``generator``, p = 0.5, when
    ``random_flip`` and not given), normalize. With neither a draw nor a
    generator the crop is the center and nothing flips, as in the JAX
    package without a key."""
    b, h0, w0, c = images.shape
    new_h, new_w = resized_size(h0, w0, resolution)
    x = images.float().permute(0, 3, 1, 2)
    if (new_h, new_w) != (h0, w0):
        x = F.interpolate(x, size=(new_h, new_w), mode="bilinear", antialias=True, align_corners=False)
    x = x.permute(0, 2, 3, 1)
    random = not center_crop and (crop is not None or generator is not None)
    if random and crop is None:
        top = int(torch.randint(0, new_h - resolution + 1, (), generator=generator, device=generator.device))
        left = int(torch.randint(0, new_w - resolution + 1, (), generator=generator, device=generator.device))
    elif random:
        top, left = (int(v) for v in crop)
    else:
        top, left = (new_h - resolution) // 2, (new_w - resolution) // 2
    x = x[:, top:top + resolution, left:left + resolution, :]
    if random_flip and flip is None and generator is not None:
        flip = torch.rand((b,), generator=generator, device=generator.device) < 0.5
    if random_flip and flip is not None:
        x = torch.where(flip.to(x.device).reshape(b, 1, 1, 1), x.flip(2), x)
    x = x / 255.0
    return ((x - 0.5) / 0.5).to(dtype)


def make_preprocess_fn(resolution: int, center_crop: bool, random_flip: bool, dtype: torch.dtype = torch.float32):
    """``fn(images, generator=None)`` with the configuration bound."""

    def fn(images, generator=None):
        return device_preprocess(images, resolution, center_crop, random_flip, generator, dtype)

    return fn
