"""The memory-lean training path through the port's CLI, on the CPU.

``--use-8bit-adam --accum-dtype bf16 --remat-policy conv-save`` at a tiny
width with ``--device cpu`` and jax blocked: 2 optimizer steps (accumulation
2) save ``checkpoint-1`` and ``checkpoint-2`` holding the int8 codes, f32
scales, ``count`` and the bf16 accumulator. A second run resumed from
``latest`` with only ``checkpoint-1`` present (in the same process, after
the first) ends in exactly the unbroken run's ``checkpoint-2`` (same draws,
same batches: bitwise equal on the CPU).
Resuming that checkpoint with the f32 optimizer's flags is refused with a
message naming the flags that differ.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from stable_diffusion_pytorch_tpu_torch.trainers import args as port_args  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.optim import build_optimizer  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAN = ["--use-8bit-adam", "--accum-dtype", "bf16", "--remat-policy", "conv-save"]
TRAIN = (
    "--device cpu --dataset synthetic --resolution 32 --max-train-steps 2 --train-batch-size 2 "
    "--eval-batch-size 2 --gradient-accumulation-steps 2 --max-train-samples 8 --max-val-samples 2 "
    "--log-interval 2 --checkpointing-steps 1 --lr-warmup-steps 0 --ema-decay 0.9 --dataloader-num-workers 0 "
    "--channels-list 32,64 --n-heads 4 --time-emb-dim 64 --n-layers 1 --autoencoder-channels-list 16,32 "
    "--groups 8 --noise-steps 50"
).split() + LEAN
# one process, jax blocked: the unbroken run in ./unbroken, then a run in
# ./resumed that holds only the first run's checkpoint-1 and resumes `latest`
_NO_JAX = """
import os, shutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["optax"] = None
import torch
torch.set_num_threads(2)
from stable_diffusion_pytorch_tpu_torch.scripts.train_unet import main
os.makedirs("unbroken")
os.chdir("unbroken")
main(sys.argv[1:])
os.makedirs("../resumed/ckpt")
shutil.copytree("ckpt/checkpoint-1", "../resumed/ckpt/checkpoint-1")
os.chdir("../resumed")
print("RESUMED RUN", file=sys.stderr, flush=True)
main(sys.argv[1:] + ["--resume-from-checkpoint", "latest"])
"""
OPT_STATE = ("mu_q", "mu_scale", "nu_q", "nu_scale", "acc")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("lean")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, *TRAIN, "--ckpt-dir", "ckpt"],
                          capture_output=True, text=True, timeout=300, env=env, cwd=cwd)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return cwd / "unbroken", cwd / "resumed", proc.stderr.split("RESUMED RUN")[-1]


def test_lean_cli_saves_int8_state_and_resumes_to_the_unbroken_state(runs):
    unbroken, resumed, resumed_log = runs
    want = load_checkpoint(str(unbroken / "ckpt" / "checkpoint-2"))
    opt = want["opt_state"]
    assert opt["count"] == 2 and opt["layout"] == {"gradient_accumulation": True, "accum_dtype": "bf16",
                                                   "use_8bit_adam": True}
    assert {t.dtype for t in opt["mu_q"] + opt["nu_q"]} == {torch.int8}
    assert {t.dtype for t in opt["mu_scale"] + opt["nu_scale"]} == {torch.float32}
    assert {t.dtype for t in opt["acc"]} == {torch.bfloat16}
    assert any(q.any() for q in opt["mu_q"])

    assert "Resuming from checkpoint at global step 1" in resumed_log
    got = load_checkpoint(str(resumed / "ckpt" / "checkpoint-2"))
    assert got["step"] == want["step"] == 4 and got["opt_state"]["count"] == 2
    for part in ("params", "ema_params"):
        for name, t in want[part].items():
            assert torch.equal(got[part][name], t), (part, name)
    for name in OPT_STATE:
        assert all(torch.equal(a, b) for a, b in zip(got["opt_state"][name], want["opt_state"][name])), name


def test_a_checkpoint_of_another_optimizer_layout_is_refused(runs):
    saved = load_checkpoint(str(runs[0] / "ckpt" / "checkpoint-2"))
    params = [torch.zeros_like(t) for t in saved["params"].values()]
    f32 = build_optimizer(params, port_args.OptimConfig(), 2, gradient_accumulation_steps=2)
    with pytest.raises(ValueError, match="--accum-dtype .*--use-8bit-adam"):
        f32.load_state_dict(saved["opt_state"])
    lean = build_optimizer(params, port_args.OptimConfig(use_8bit_adam=True, accum_dtype="bf16"), 2,
                           gradient_accumulation_steps=2)
    lean.load_state_dict(saved["opt_state"])
    with pytest.raises(ValueError, match="--gradient-accumulation-steps"):
        build_optimizer(params, port_args.OptimConfig(use_8bit_adam=True), 2).load_state_dict(saved["opt_state"])
