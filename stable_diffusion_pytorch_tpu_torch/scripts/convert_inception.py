"""Convert a torchvision ``inception_v3`` checkpoint to the staged ``.npz`` (counterpart of tools/convert_inception.py).

    python -m stable_diffusion_pytorch_tpu_torch.scripts.convert_inception inception_v3.pth \\
        [data/pretrained/inception/inception_v3.npz]

Reads a ``.pth`` (``torch.load``, weights only) or a ``.safetensors`` (the
port's reader, ``utils/safetensors.py``), folds each BatchNorm into its conv
(``models/inception.py:convert_torchvision_inception``) and writes the JAX
package's parameter tree flattened with ``/`` (``<block>/conv/kernel`` [kh,
kw, I, O], ``<block>/bn_scale``, ``<block>/bn_bias``), the file both
packages load first (``models/inception.py:load_inception_state``). Prints
one JSON line: ``{"output", "arrays", "params"}``. Pure file conversion on
the CPU: no ``--device``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from stable_diffusion_pytorch_tpu_torch.models.inception import convert_torchvision_inception, inception_tree
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import read_weights

DEFAULT_OUT = "data/pretrained/inception/inception_v3.npz"


def main(argv=None) -> dict:
    """Convert and print the JSON line -> its dict."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print(__doc__)
        raise SystemExit(2)
    src, dst = argv[0], (argv[1] if len(argv) > 1 else DEFAULT_OUT)
    flat = inception_tree(convert_torchvision_inception(read_weights(src)))
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    np.savez(dst, **flat)
    out = {"output": dst, "arrays": len(flat), "params": int(sum(v.size for v in flat.values()))}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
