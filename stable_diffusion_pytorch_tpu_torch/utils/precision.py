"""Full float32 arithmetic for the evaluation models.

PyTorch lets cuDNN run float32 convolutions on TF32 tensor cores by default
(``torch.backends.cudnn.allow_tf32``), about 1e-3 relative, and cuBLAS may be
allowed the same (``torch.backends.cuda.matmul.allow_tf32``). Features that a
FID or a CLIP score compares across runs and machines must not depend on
those process-wide switches, so the extractors (``utils/fid.py``) and the
CLIP scorer (``models/clip_vision.py``) compute inside :func:`full_float32`,
which turns both off for the call and restores them after.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
