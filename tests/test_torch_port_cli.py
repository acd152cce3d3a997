"""The port without jax: the txt2img CLI end to end on the CPU, and the PNG writer."""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from stable_diffusion_pytorch_tpu_torch.utils.data import detransform, encode_png, to_img  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = (
    "--prompt a-red-cube --negative-prompt blurry --image-size 32 --sampling-steps 3 "
    "--channels-list 32,64 --n-heads 4 --time-emb-dim 64 --n-layers 1 "
    "--autoencoder-channels-list 16,32 --groups 8 --noise-steps 50 --device cpu"
).split()

# Blocks jax and flax, imports every module of the port (the Triton kernel
# module needs triton, which only the CUDA path imports), runs the CLI.
_NO_JAX = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import torch
torch.set_num_threads(2)
import stable_diffusion_pytorch_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if not info.name.endswith("groupnorm_triton"):
        importlib.import_module(info.name)
from stable_diffusion_pytorch_tpu_torch.scripts.txt2img import main
main(sys.argv[1:])
assert not any(m == "jax" or m.startswith(("jax.", "flax")) for m in sys.modules if sys.modules[m] is not None)
"""


def _read_png(path):
    """Minimal PNG reader for filter-0 rows (what encode_png writes)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        assert struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0] == zlib.crc32(kind + body)
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color = header[:4]
    channels = {0: 1, 2: 3, 6: 4}[color]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    assert depth == 8 and not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, channels)


def test_txt2img_cli_runs_without_jax(tmp_path):
    out = tmp_path / "imgs"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, *TINY, "--output-dir", str(out), "--output-name", "cube.png"],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(os.listdir(out)) == ["cube.png"]
    img = _read_png(out / "cube.png")
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_roundtrip(tmp_path, channels):
    pixels = np.random.default_rng(channels).integers(0, 256, (5, 7, channels), dtype=np.uint8)
    path = to_img(pixels, str(tmp_path), "x.png")
    assert path == str(tmp_path / "x.png") and os.listdir(tmp_path) == ["x.png"]
    np.testing.assert_array_equal(_read_png(path), pixels)
    PIL = pytest.importorskip("PIL.Image")
    decoded = np.asarray(PIL.open(path))
    np.testing.assert_array_equal(decoded.reshape(pixels.shape), pixels)


def test_to_img_adds_suffix_once_and_detransform():
    img = detransform(np.array([[[[-1.0, 0.0, 1.0]]]], np.float32))
    np.testing.assert_array_equal(img, [[[0, 127, 255]]])
    with pytest.raises(ValueError):
        encode_png(np.zeros((2, 2, 2), np.uint8))


def test_to_img_name_without_suffix(tmp_path):
    assert to_img(np.zeros((2, 3, 3), np.uint8), str(tmp_path), "plain") == str(tmp_path / "plain.png")
