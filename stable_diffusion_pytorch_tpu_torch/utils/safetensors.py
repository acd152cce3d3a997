"""The safetensors file format, read and written with the standard library and torch.

The JAX package reads staged Hugging Face and diffusers weights with
``safetensors.numpy.load_file`` (``models/clip.py``, ``models/diffusers_vae.py``,
``models/inception.py``, ``models/clip_vision.py``); the port reads them here,
so it needs no ``safetensors`` package.

The format: an unsigned 64-bit little-endian header length, a UTF-8 JSON
header, then the raw little-endian bytes of every tensor (read and written as they lie
in memory: the hosts the port runs on are little-endian). The header maps each
name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the
bytes after the header) and may hold a ``"__metadata__"`` map of strings,
which the reader skips and the writer leaves out.

:func:`save_file` writes what the ``safetensors`` package writes, byte for
byte: the tensors sorted by dtype (widest first, in that package's order) and
then by name, the header compact JSON padded with spaces to a multiple of 8
bytes. The tests hold both functions against ``safetensors.numpy``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}
# the safetensors package's dtype order, ascending; its writer sorts descending
_ORDER = ("BOOL", "U8", "I8", "I16", "U16", "F16", "BF16", "I32", "U32", "F32", "F64", "I64", "U64")


def _header(path: str, f) -> tuple:
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError(f"{path}: not a safetensors file (no header length)")
    (n,) = struct.unpack("<Q", raw)
    header = json.loads(f.read(n).decode("utf-8"))
    return 8 + n, header


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a safetensors file, in the file's dtypes. The
    tensors are views of one buffer holding the file's data."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        start, header = _header(path, f)
        buf = bytearray(size - start)
        if f.readinto(memoryview(buf)) != len(buf):
            raise ValueError(f"{path}: truncated")
    data = torch.frombuffer(buf, dtype=torch.uint8) if buf else torch.empty(0, dtype=torch.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which this reader does not take")
        dtype, shape = DTYPES[info["dtype"]], [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for s in shape:
            numel *= s
        if not 0 <= begin <= end <= len(buf) or end - begin != numel * itemsize:
            raise ValueError(f"{path}: {name} has offsets {begin}..{end} for {numel} x {itemsize} bytes")
        raw = data[begin:end]
        if begin % itemsize:  # the reference writer aligns every tensor; others may not
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device; contiguous copies are taken on the CPU)
    as a safetensors file, byte for byte as the safetensors package writes it."""
    items = []
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name here")
        items.append((name, _NAMES[t.dtype], t.detach().to("cpu").contiguous()))
    items.sort(key=lambda item: item[0])
    items.sort(key=lambda item: _ORDER.index(item[1]), reverse=True)  # stable: names stay sorted within a dtype
    header: dict = {}
    offset = 0
    for name, code, t in items:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": code, "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, _, t in items:
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
