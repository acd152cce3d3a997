"""The port's three personalization entry points on the CPU, in one interpreter
without jax, at a tiny size (``--device cpu``; flags as in
``test_torch_port_train_cli.py``):

- ``train_dreambooth`` with ``--lora-rank 4 --with-prior-preservation
  --use-8bit-adam``: the class images it lacks are sampled and written as
  PNGs (a second run finds them and samples none), instance and class rows
  interleave (UNet batch 2 for ``--train-batch-size 1``), and the
  checkpoint's ``params`` are the LoRA factors by the UNet's names;
- ``train_textual_inversion`` (two vectors from ``--initializer-token``)
  writes ``textual_inversion.json`` beside its checkpoints of
  ``{"ti": [2, 768]}``;
- ``train_controlnet`` checkpoints the ControlNet's state dict.

Each runs 2 optimizer steps with EMA, saving every step; a second run with
only ``checkpoint-1`` present resumes from ``latest`` and ends in the
unbroken run's state, bit for bit. Then the three results load into the
sampling path with no conversion, in one txt2img run (``--lora-checkpoint``,
``--textual-inversion``, ``--controlnet-checkpoint --control-image``) that
writes its image; the loaded tensors are the checkpoints' EMA ones.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

_SCRIPT = r'''
import json, os, shutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["optax"] = None
import numpy as np
import torch
torch.set_num_threads(2)
from stable_diffusion_pytorch_tpu_torch.scripts import (
    train_controlnet, train_dreambooth, train_textual_inversion, txt2img)
from stable_diffusion_pytorch_tpu_torch.models.lora import merge_lora
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import load_checkpoint, load_params_for_inference
from stable_diffusion_pytorch_tpu_torch.utils.data import read_image, to_img

TINY = ("--channels-list 32,64 --n-heads 4 --time-emb-dim 64 --n-layers 1 "
        "--autoencoder-channels-list 16,32 --groups 8 --noise-steps 50").split()
TRAIN = ("--device cpu --resolution 32 --max-train-steps 2 --train-batch-size 1 --eval-batch-size 2 "
         "--gradient-accumulation-steps 1 --log-interval 2 --checkpointing-steps 1 --lr-warmup-steps 1 "
         "--learning-rate 1e-3 --ema-decay 0.9 --dataloader-num-workers 0").split() + TINY
SYNTHETIC = ["--dataset", "synthetic", "--max-train-samples", "3", "--max-val-samples", "2"]
rng = np.random.default_rng(0)
for i in range(2):
    to_img((rng.random((32, 40, 3)) * 255).astype(np.uint8), "inst", f"img_{i}.png")
RUNS = {
    "dreambooth": (train_dreambooth, ["--instance-data-dir", "inst", "--instance-prompt", "a photo of sks blob",
                                      "--with-prior-preservation", "--class-data-dir", "cls",
                                      "--class-prompt", "a photo of a blob", "--num-class-images", "3",
                                      "--class-sampling-steps", "2", "--lora-rank", "4", "--use-8bit-adam"]),
    "textual_inversion": (train_textual_inversion, [*SYNTHETIC, "--placeholder-token", "<c>", "--num-vectors", "2",
                                                    "--initializer-token", "toy"]),
    "controlnet": (train_controlnet, SYNTHETIC),
}


def equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


out = {}
for name, (script, flags) in RUNS.items():
    argv = [*TRAIN, *flags, "--ckpt-dir", f"{name}_ckpt", "--logging-dir", f"{name}_logs"]
    trainer = script.main(argv)
    rec = {"ckpts": sorted(d for d in os.listdir(f"{name}_ckpt")), "micro_steps": trainer.state.step,
           "unet_batch": None}
    if name == "dreambooth":
        db_trainer = trainer
        rec["class_images"] = sorted(os.listdir("cls"))
        batch = next(iter(trainer.train_loader))
        rec["unet_batch"] = list(batch["pixel_values"].shape)
        rec["trainables"] = trainer.state.trainables is not None
        base = {k: t.detach().clone() for k, t in trainer.model.unet.state_dict().items()}  # frozen, same seed
    unbroken = load_checkpoint(f"{name}_ckpt/checkpoint-2")
    shutil.rmtree(f"{name}_ckpt/checkpoint-2")
    script.main([*argv, "--resume-from-checkpoint", "latest"])
    resumed = load_checkpoint(f"{name}_ckpt/checkpoint-2")
    rec["resumed_equal"] = equal(unbroken, resumed)
    rec["param_names"] = sorted(unbroken["params"])[:3]
    rec["param_shapes"] = sorted({tuple(t.shape) for t in unbroken["params"].values()})
    rec["ema"] = load_params_for_inference(f"{name}_ckpt/checkpoint-2")
    out[name] = rec

# the generated class images are found again: nothing is sampled
mtimes = {f: os.path.getmtime(os.path.join("cls", f)) for f in os.listdir("cls")}
made = train_dreambooth.ensure_class_images(db_trainer.model, db_trainer.cfg.train, 32, db_trainer.logger)
out["dreambooth"]["class_images_kept"] = made == 0 and mtimes == {
    f: os.path.getmtime(os.path.join("cls", f)) for f in os.listdir("cls")}

# all three results loaded by one txt2img run, as the sampling flags read them
to_img((rng.random((32, 32, 3)) * 255).astype(np.uint8), ".", "hint.png")
model = txt2img.main(["--device", "cpu", "--image-size", "32", "--sampling-steps", "2", "--output-dir", "samples",
                      *TINY, "--prompt", "a photo of a <c>", "--output-name", "all.png",
                      "--lora-checkpoint", "dreambooth_ckpt", "--lora-scale", "1.0",
                      "--textual-inversion", "textual_inversion_ckpt",
                      "--controlnet-checkpoint", "controlnet_ckpt", "--control-image", "hint.png"])
image = list(read_image(os.path.join("samples", "all.png")).shape)
ema = {name: out[name].pop("ema") for name in RUNS}
out["dreambooth"]["loaded_equal"] = equal(model.unet.state_dict(), merge_lora(base, ema["dreambooth"], 1.0))
out["textual_inversion"]["loaded_equal"] = (np.array_equal(model.text_encoder._ti[2], ema["textual_inversion"]["ti"].numpy())
                                           and model.text_encoder._ti[0] == "<c>")
out["textual_inversion"]["sidecar"] = json.load(open("textual_inversion_ckpt/textual_inversion.json"))
out["controlnet"]["loaded_equal"] = equal(model.controlnet[0].state_dict(), ema["controlnet"])
for name in RUNS:
    out[name]["image"] = image
print("RESULT " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("personalize_cli")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True, text=True, timeout=600, env=env,
                          cwd=cwd)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("name", ["dreambooth", "textual_inversion", "controlnet"])
def test_trainer_checkpoints_resumes_latest_and_samples(results, name):
    rec = results[name]
    assert rec["ckpts"][:2] == ["checkpoint-1", "checkpoint-2"]
    assert rec["micro_steps"] == 2
    assert rec["resumed_equal"], f"{name}: the resumed run did not end in the unbroken run's state"
    assert rec["loaded_equal"], f"{name}: sampling did not load the checkpoint's tensors"
    assert rec["image"] == [32, 32, 3]


def test_dreambooth_layout_and_class_images(results):
    rec = results["dreambooth"]
    assert rec["trainables"] and rec["unet_batch"] == [2, 32, 32, 3]
    assert rec["class_images"] == ["class_00000.png", "class_00001.png", "class_00002.png"]
    assert rec["class_images_kept"]
    assert all(n.endswith((".lora_a", ".lora_b")) for n in rec["param_names"])
    assert {s[0] for s in rec["param_shapes"]} >= {4} and {s[1] for s in rec["param_shapes"]} >= {4}


def test_textual_inversion_layout(results):
    rec = results["textual_inversion"]
    assert rec["param_names"] == ["ti"] and rec["param_shapes"] == [[2, 768]]
    assert rec["sidecar"] == {"placeholder_token": "<c>", "num_vectors": 2}


@pytest.mark.parametrize("script", ["train_dreambooth", "train_textual_inversion", "train_controlnet"])
def test_entry_point_stops_without_a_card(monkeypatch, script):
    """``--device cuda`` is the default: without a card the run stops, naming ``--device cpu``."""
    import importlib

    import torch

    module = importlib.import_module(f"stable_diffusion_pytorch_tpu_torch.scripts.{script}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        module.main(["--dataset", "synthetic", "--instance-data-dir", "inst"])
