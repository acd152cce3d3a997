"""The port's training entry point and its plumbing, on the CPU.

- The training CLI with ``--device cpu`` and jax blocked, in one process: 3 optimizer steps
  (gradient accumulation 2, EMA on) save ``checkpoint-{1,2,3}``; a second run
  resumed from ``latest`` with only ``checkpoint-2`` present ends in exactly the
  unbroken run's state (same draws, same batches: bitwise equal on the CPU).
- The synthetic dataset's rows and the ``DataLoader``'s batches equal the JAX
  package's for the same seed and epoch (exactly: same numpy generators).
- Config: every training dataclass field equals the JAX field, and
  ``load_config`` builds the JAX package's tree from the same flags.
- The port imports nothing of jax, flax, optax or the JAX package (AST scan),
  and its copy of the BPE tokenizer tokenizes as the JAX package's does.
- Entry points run on the card unless asked for the CPU; ``--num-devices``
  other than the data axis raises naming both; chained dispatch
  (``--steps-per-dispatch 2``, and the ``perf.json`` preset's 8) trains.
"""

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from stable_diffusion_pytorch_tpu import config as jax_config  # noqa: E402
from stable_diffusion_pytorch_tpu.models.bpe import CLIPBPETokenizer as JaxBPE  # noqa: E402
from stable_diffusion_pytorch_tpu.parallel import args as jax_parallel  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import args as jax_args  # noqa: E402
from stable_diffusion_pytorch_tpu.utils import compat as jax_compat  # noqa: E402
from stable_diffusion_pytorch_tpu.utils import data as jax_data  # noqa: E402
from stable_diffusion_pytorch_tpu_torch import config as port_config  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import build as port_build  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import presets  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.bpe import CLIPBPETokenizer  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.parallel import args as port_parallel  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.scripts import serve, train_autoencoder, train_unet, txt2img  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers import args as port_args  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import compat as port_compat  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import data as port_data  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY_MODEL = (
    "--channels-list 32,64 --n-heads 4 --time-emb-dim 64 --n-layers 1 "
    "--autoencoder-channels-list 16,32 --groups 8 --noise-steps 50"
).split()
TRAIN = (
    "--device cpu --dataset synthetic --resolution 32 --max-train-steps 3 --train-batch-size 2 "
    "--eval-batch-size 2 --gradient-accumulation-steps 2 --max-train-samples 8 --max-val-samples 4 "
    "--log-interval 2 --checkpointing-steps 1 --lr-warmup-steps 1 --ema-decay 0.9 "
    "--dataloader-num-workers 0"
).split() + TINY_MODEL

# one process, jax blocked: the unbroken run in ./unbroken, then a run in
# ./resumed that holds only its checkpoint-2 and resumes `latest`
_NO_JAX = """
import os, shutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["optax"] = None
import torch
torch.set_num_threads(2)
from stable_diffusion_pytorch_tpu_torch.scripts.train_unet import main
argv = sys.argv[1:] + ["--ckpt-dir", "ckpt"]
os.makedirs("unbroken")
os.chdir("unbroken")
main(argv)
os.makedirs("../resumed/ckpt")
shutil.copytree("ckpt/checkpoint-2", "../resumed/ckpt/checkpoint-2")
os.chdir("../resumed")
print("RESUMED RUN", file=sys.stderr, flush=True)
main(argv + ["--resume-from-checkpoint", "latest"])
assert not any(m.split(".")[0] in ("jax", "flax", "optax") for m in sys.modules if sys.modules[m] is not None)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(unbroken dir, resumed dir, the resumed run's log)."""
    cwd = tmp_path_factory.mktemp("train_cli")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, *TRAIN], capture_output=True, text=True,
                          timeout=300, env=env, cwd=cwd)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return cwd / "unbroken", cwd / "resumed", proc.stderr.split("RESUMED RUN")[-1]


def test_train_cli_runs_without_jax_and_checkpoints(runs):
    unbroken = runs[0]
    assert sorted(os.listdir(unbroken / "ckpt")) == ["checkpoint-1", "checkpoint-2", "checkpoint-3"]
    state = load_checkpoint(str(unbroken / "ckpt" / "checkpoint-2"))
    assert state["step"] == 4 and state["opt_state"]["count"] == 2  # micro steps, optimizer updates
    lines = (unbroken / "logs" / "train_unet_metrics.jsonl").read_text().splitlines()
    assert [l for l in lines if "eval_loss" in l] and len([l for l in lines if "train_loss" in l]) == 3


def test_train_cli_resumes_latest_to_the_unbroken_state(runs):
    unbroken, resumed, resumed_log = runs
    assert "Resuming from checkpoint at global step 2" in resumed_log
    want = load_checkpoint(str(unbroken / "ckpt" / "checkpoint-3"))
    got = load_checkpoint(str(resumed / "ckpt" / "checkpoint-3"))
    assert got["step"] == want["step"] == 6
    for part in ("params", "ema_params"):
        for name, t in want[part].items():
            assert torch.equal(got[part][name], t), (part, name)
    for name in ("mu", "nu", "acc"):
        assert all(torch.equal(a, b) for a, b in zip(got["opt_state"][name], want["opt_state"][name])), name


def test_synthetic_rows_and_loader_batches_match_jax():
    kw = dict(dataset="synthetic", resolution=32, center_crop=False, random_flip=True, max_train_samples=12)
    jcfg, pcfg = jax_data.DatasetConfig(**kw), port_data.DatasetConfig(**kw)
    jds = jax_data.get_dataset(jcfg, "train", tokenizer=JaxBPE(max_seq_len=77))
    pds = port_data.get_dataset(pcfg, "train", tokenizer=CLIPBPETokenizer(max_seq_len=77))
    jl = jax_data.DataLoader(jds, batch_size=4, shuffle=True, seed=42)
    pl = port_data.DataLoader(pds, batch_size=4, shuffle=True, seed=42, num_workers=2)
    assert len(pl) == len(jl) == 3
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        for jb, pb in zip(jl, pl):
            assert sorted(pb) == ["input_ids", "pixel_values"]
            np.testing.assert_array_equal(pb["pixel_values"], jb["pixel_values"])
            np.testing.assert_array_equal(pb["input_ids"], jb["input_ids"])
    assert pds[5]["text"] == jds[5]["text"]


def test_bpe_copy_tokenizes_as_jax():
    prompts = ["a photograph of an astronaut riding a horse", "", "Hello, World!  it's 3:15pm #tpu"]
    ours, ref = CLIPBPETokenizer(max_seq_len=77), JaxBPE(max_seq_len=77)
    for p in prompts:
        assert ours.encode(p) == ref.encode(p)
    np.testing.assert_array_equal(
        np.asarray(ours(prompts, max_length=77, padding="max_length", truncation=True).input_ids),
        np.asarray(ref(prompts, max_length=77, padding="max_length", truncation=True).input_ids),
    )


@pytest.mark.parametrize(
    "port_cls,jax_cls",
    [
        (port_args.LogConfig, jax_args.LogConfig),
        (port_args.TrainConfig, jax_args.TrainConfig),
        (port_args.OptimConfig, jax_args.OptimConfig),
        (port_args.CheckpointConfig, jax_args.CheckpointConfig),
        (port_parallel.ParallelConfig, jax_parallel.ParallelConfig),
        (port_data.DatasetConfig, jax_data.DatasetConfig),
        (port_compat.CompatConfig, jax_compat.CompatConfig),
    ],
    ids=["log", "train", "optim", "checkpoint", "parallel", "dataset", "compat"],
)
def test_train_config_dataclasses_equal_jax(port_cls, jax_cls):
    def table(cls):
        return [(f.name, f.default if f.default_factory is dataclasses.MISSING else f.default_factory(),
                 dict(f.metadata)) for f in dataclasses.fields(cls)]

    assert table(port_cls) == table(jax_cls)


def test_load_config_builds_the_jax_tree(tmp_path):
    preset = tmp_path / "preset.json"
    preset.write_text('{"lr_warmup_steps": 7, "learning_rate": 0.5}')
    argv = ["--dataset", "synthetic", "--reference-compat", "--learning-rate", "1e-3", "--channels-list", "32,64",
            "--config-file", str(preset)]
    _, ours = port_config.load_config(argv)
    _, ref = jax_config.load_config(argv)
    assert (ours.optim.lr_warmup_steps, ours.optim.learning_rate) == (7, 1e-3)  # the flag beats the file
    assert ours.to_dict() == {k: v for k, v in ref.to_dict().items() if k in ours.to_dict()}
    compat = port_config.compat_from_cfg(ours)
    assert compat.train_with_cfg and compat.cfg_formula and compat == port_compat.CompatConfig(
        **dataclasses.asdict(jax_config.compat_from_cfg(ref)))


PRESETS = ("base.json", "zero2.json", "fsdp.json", "perf.json")


@pytest.mark.parametrize("name", PRESETS)
def test_load_config_builds_the_jax_tree_from_a_preset_name(name):
    """``--config-file NAME`` finds the port's preset as the JAX package finds
    its own: the same fields, the same tree; the port's comment quotes no TPU
    figure."""
    jax_dir = pathlib.Path(jax_config.__file__).parent / "config_presets"
    ours_file, jax_file = pathlib.Path(port_config.PRESET_DIR) / name, jax_dir / name
    ours_preset, jax_preset = (json.loads(f.read_text()) for f in (ours_file, jax_file))
    fields = lambda preset: {k: v for k, v in preset.items() if not k.startswith("_")}  # noqa: E731
    assert fields(ours_preset) == fields(jax_preset)
    assert not any(word in ours_preset["_comment"] for word in ("v5e", "TPU", "NamedSharding", " ms "))
    argv = ["--dataset", "synthetic", "--config-file", name]
    _, ours = port_config.load_config(argv)
    _, ref = jax_config.load_config(argv)
    assert ours.to_dict() == {k: v for k, v in ref.to_dict().items() if k in ours.to_dict()}
    assert ours.parallel.mixed_precision == "bf16"


def test_preset_by_name_yields_to_flags_and_rejects_unknown_fields(tmp_path):
    _, cfg = port_config.load_config(["--config-file", "zero2.json", "--gradient-accumulation-steps", "2"])
    assert (cfg.train.gradient_accumulation_steps, cfg.optim.max_grad_norm) == (2, 1.0)
    assert cfg.parallel.shard_optimizer_state
    bad = tmp_path / "bad.json"
    bad.write_text('{"steps_per_dispatch": 2, "no_such_field": 1}')
    with pytest.raises(SystemExit):
        port_config.load_config(["--config-file", str(bad)])
    with pytest.raises(FileNotFoundError):
        port_config.load_config(["--config-file", "no_such_preset.json"])


@pytest.mark.parametrize("flags", [[], ["--steps-per-dispatch", "1"]], ids=["preset", "one_step_per_dispatch"])
def test_perf_preset_trainer_raises_naming_item_20_until_given_one_step(tmp_path, monkeypatch, flags):
    """The ``perf.json`` preset builds and trains: 8 optimizer steps a
    dispatch (one chunk here, ``--log-interval 0`` and no checkpoint inside
    it), bf16 moments; ``--steps-per-dispatch 1`` yields to the preset."""
    monkeypatch.chdir(tmp_path)
    argv = [*TRAIN, "--ckpt-dir", "ckpt", "--config-file", "perf.json", "--max-train-steps", "8",
            "--gradient-accumulation-steps", "1", "--checkpointing-steps", "8", "--log-interval", "0",
            "--max-train-samples", "16", "--resolution", "16", *flags]
    trainer = train_unet.build_trainer(argv)
    assert trainer.cfg.train.steps_per_dispatch == (1 if flags else 8)
    assert {m.dtype for m in (*trainer.state.optimizer.mu, *trainer.state.optimizer.nu)} == {torch.bfloat16}
    if flags:
        return
    chunks = []
    inner = trainer._dispatch
    trainer._dispatch = lambda window, micro0, steps: chunks.append(steps) or inner(window, micro0, steps)
    trainer.train()
    assert chunks == [8] and trainer.state.optimizer.count == 8


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "stable_diffusion_pytorch_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    tools = {"stage_check", "full_scale_parity", "fid_eval", "fid_samplers", "export_torch", "convert_inception"}
    assert {f"{name}.py" for name in tools} <= {p.name for p in files if p.parent.name == "scripts"}
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "orbax", "stable_diffusion_pytorch_tpu"), (
                f"{path.relative_to(REPO)} imports {name}"
            )


def test_entry_points_run_on_cuda_unless_given_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        txt2img.main(["--prompt", "x", *TINY_MODEL])
    with pytest.raises(SystemExit, match="--device cpu"):
        train_unet.main(["--dataset", "synthetic", *TINY_MODEL])
    with pytest.raises(SystemExit, match="--device cpu"):
        train_autoencoder.main(["--dataset", "synthetic", *TINY_MODEL])
    with pytest.raises(SystemExit, match="--device cpu"):
        serve.main(["--port", "0", *TINY_MODEL])
    cfgs = (presets.reference_unet_config(), port_config.AutoencoderConfig(), port_config.ClipConfig(model_dir=None),
            port_config.DDPMConfig())
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_build.build_models(*cfgs)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_build.build_autoencoder(port_config.AutoencoderConfig())
    assert port_build.require_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize(
    "flags,error,match",
    [(["--steps-per-dispatch", "2"], None, None),
     (["--num-devices", "4"], ValueError, "--num-devices 4 does not match the data axis of 1 process")],
    ids=["steps_per_dispatch", "multi_device"],
)
def test_unported_training_options_raise(tmp_path, monkeypatch, flags, error, match):
    """Chained dispatch is ported: the entry point trains with it (a
    checkpoint every step leaves no room for a chunk, so each of 2 steps is
    dispatched alone, its checkpoint written). ``--num-devices`` must equal the data size,
    one process per device (the JAX package takes the first N devices
    instead), so 4 asked of one process raises, naming both numbers."""
    monkeypatch.chdir(tmp_path)
    argv = [*TRAIN, "--ckpt-dir", "ckpt", "--dataset", "synthetic", *flags]
    if error is None:
        trainer = train_unet.main([*argv, "--max-train-steps", "2", "--log-interval", "0"])
        assert trainer.state.optimizer.count == 2 and trainer._route == "eager"
        assert sorted(os.listdir("ckpt")) == ["checkpoint-1", "checkpoint-2"]
        return
    with pytest.raises(error, match=match):
        train_unet.main(argv)
