"""Image output without PIL: [-1, 1] -> uint8, and a stdlib PNG writer.

Port of ``detransform``/``to_img`` from stable_diffusion_pytorch_tpu/utils/data.py.
The PNG is written with ``zlib`` and ``struct`` only (8-bit grayscale, RGB or
RGBA, filter type 0 on every row). Unlike the JAX package's ``to_img``, a name
that already ends in ``.png`` is not given a second suffix.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type


def detransform(image) -> np.ndarray:
    """[B?, H, W, C] in [-1, 1] -> HWC uint8; drops a leading batch dim of 1."""
    arr = np.asarray(image, dtype=np.float32)
    if arr.ndim == 4 and arr.shape[0] == 1:
        arr = arr[0]
    arr = np.clip((arr + 1.0) / 2.0, 0.0, 1.0)
    return (arr * 255.0).astype(np.uint8)


def encode_png(pixels: np.ndarray) -> bytes:
    """HW, HW1, HW3 or HW4 uint8 -> PNG file bytes."""
    arr = np.asarray(pixels)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in _COLOR_TYPES:
        raise ValueError(f"expected uint8 HW/HWC with 1, 3 or 4 channels, got {arr.dtype} {arr.shape}")
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
        )

    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


def to_img(digit_img: np.ndarray, output_path: str = "", name: str = "sample") -> str:
    """Save HWC uint8 to ``{output_path}/{name}`` with a ``.png`` suffix added
    only when ``name`` lacks one. Returns the path written."""
    if output_path:
        os.makedirs(output_path, exist_ok=True)
    filename = name if name.lower().endswith(".png") else f"{name}.png"
    path = os.path.join(output_path, filename)
    with open(path, "wb") as f:
        f.write(encode_png(digit_img))
    return path
