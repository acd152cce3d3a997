"""CLIP-score CLI of the PyTorch port (counterpart of tools/clip_score.py).

    python -m stable_diffusion_pytorch_tpu_torch.scripts.clip_score --images-dir output/ --prompt "a cat"
    python -m stable_diffusion_pytorch_tpu_torch.scripts.clip_score --images-dir output/ --prompts-file prompts.txt

Scores every image of ``--images-dir`` (sorted by name; read through
``utils/data.py:read_image``) against ``--prompt``, or against the lines of
``--prompts-file`` in order, with the full CLIP staged at
``{--model-dir}/clip_full/model.safetensors`` (random weights with a loud
warning when none is staged) and the tokenizer staged under ``--model-dir``
(``models/clip.py:resolve_tokenizer``). Prints one JSON line:
``{"metric": "clip_score", "value", "unit", "num_images", "pretrained"}``.
``--device`` (default ``cuda``; without a card the run stops unless given
``--device cpu``) is the port's own.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from stable_diffusion_pytorch_tpu_torch.config import ClipConfig
from stable_diffusion_pytorch_tpu_torch.models.build import require_device
from stable_diffusion_pytorch_tpu_torch.models.clip import resolve_tokenizer
from stable_diffusion_pytorch_tpu_torch.models.clip_vision import CLIPScorer
from stable_diffusion_pytorch_tpu_torch.utils.data import read_image

EXTENSIONS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def main(argv=None) -> dict:
    """Score and print the JSON line -> its dict."""
    parser = argparse.ArgumentParser(description="CLIP score of generated images (PyTorch port)")
    parser.add_argument("--images-dir", required=True)
    parser.add_argument("--prompt", default=None, help="one prompt for all images")
    parser.add_argument("--prompts-file", default=None, help="one prompt per line, matched to sorted image filenames")
    parser.add_argument("--model-dir", default="data/pretrained")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda; the CPU only when asked: --device cpu)")
    ns = parser.parse_args(argv)
    try:
        require_device(ns.device)
    except RuntimeError as exc:
        raise SystemExit(f"clip_score: {exc}") from None

    files = sorted(f for f in os.listdir(ns.images_dir) if f.lower().endswith(EXTENSIONS))
    if not files:
        raise SystemExit(f"clip_score: no images under {ns.images_dir!r}")
    images = np.stack([read_image(os.path.join(ns.images_dir, f)) for f in files])
    if ns.prompts_file:
        with open(ns.prompts_file) as f:
            prompts = [line.rstrip("\n") for line in f if line.strip()]
        if len(prompts) < len(files):
            raise SystemExit(f"clip_score: {len(prompts)} prompts for {len(files)} images")
        prompts = prompts[: len(files)]
    elif ns.prompt:
        prompts = [ns.prompt] * len(files)
    else:
        raise SystemExit("clip_score: pass --prompt or --prompts-file")

    scorer = CLIPScorer(resolve_tokenizer(ClipConfig(model_dir=ns.model_dir)), model_dir=ns.model_dir,
                        device=ns.device)
    out = {"metric": "clip_score", "value": round(scorer.score(images, prompts), 4), "unit": "clip-score (0-100)",
           "num_images": len(files), "pretrained": scorer.pretrained}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
