"""Checkpoints with the JAX package's directory and resume semantics (port of
utils/checkpoint.py; Orbax becomes ``torch.save``).

- a checkpoint is the directory ``{ckpt_dir}/checkpoint-{global_step}`` (or
  ``epoch_{n}`` for per-epoch saves) holding ``train_state.pt``: the step, the
  UNet's parameters, the optimizer state, the EMA parameters and the epoch;
- ``resume_from_checkpoint="latest"`` restores the ``checkpoint-*`` entry with
  the largest step; any other value is a path (or a name under ``ckpt_dir``);
- ``keep_last_only`` removes the previous checkpoint after a save;
- :func:`resume_train_state_math` is the reference's step/epoch replay
  arithmetic (the reference's train_unet.py:284-312).
"""

from __future__ import annotations

import math
import os
import shutil
from typing import Any, Optional, Tuple

import torch

STATE_FILE = "train_state.pt"


def checkpoint_path(ckpt_dir: str, global_step: int) -> str:
    return os.path.join(ckpt_dir, f"checkpoint-{global_step}")


def find_latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``checkpoint-N`` directory with the largest N, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    dirs = [d for d in os.listdir(ckpt_dir) if d.startswith("checkpoint")]
    dirs = sorted(dirs, key=lambda x: int(x.split("-")[1]))
    return os.path.join(ckpt_dir, dirs[-1]) if dirs else None


def save_checkpoint(path: str, state: dict) -> None:
    """Write ``state`` (tensors are saved as they lie, device included) to
    ``path/train_state.pt``, replacing an existing checkpoint there."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location: Any = "cpu") -> dict:
    return torch.load(os.path.join(path, STATE_FILE), map_location=map_location, weights_only=True)


class CheckpointManager:
    """Save and resume with keep_last_only pruning (the reference's train_unet.py:390-407)."""

    def __init__(self, ckpt_cfg):
        self.ckpt_dir = ckpt_cfg.ckpt_dir
        self.keep_last_only = ckpt_cfg.keep_last_only
        self.resume_from = ckpt_cfg.resume_from_checkpoint
        self.last_ckpt: Optional[str] = None

    def save(self, global_step: int, state, epoch: Optional[int] = None) -> str:
        """Save ``state.state_dict()`` (a ``TrainState``) plus the epoch."""
        if epoch is not None:
            path = os.path.join(self.ckpt_dir, f"epoch_{epoch}")
        else:
            path = checkpoint_path(self.ckpt_dir, global_step)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        prune = self.last_ckpt if (self.keep_last_only and self.last_ckpt) else None
        save_checkpoint(path, {**state.state_dict(), "epoch": epoch})
        if prune and os.path.exists(prune) and os.path.abspath(prune) != os.path.abspath(path):
            shutil.rmtree(prune)
        self.last_ckpt = path
        return path

    def resolve_resume_path(self) -> Optional[str]:
        """The explicit path, the 'latest' scan, or None."""
        if not self.resume_from:
            return None
        if self.resume_from == "latest":
            return find_latest_checkpoint(self.ckpt_dir)
        path = self.resume_from
        if not os.path.isabs(path) and not os.path.exists(path):
            candidate = os.path.join(self.ckpt_dir, os.path.basename(path))
            if os.path.exists(candidate):
                path = candidate
        return path if os.path.exists(path) else None

    def restore(self, state) -> Tuple[bool, int]:
        """Load the resume checkpoint into ``state`` in place ->
        (restored, resumed_global_step)."""
        path = self.resolve_resume_path()
        if path is None:
            return False, 0
        device = state.params[0].device if state.params else "cpu"
        state.load_state_dict(load_checkpoint(path, map_location=device))
        base = os.path.basename(path.rstrip("/"))
        try:
            step = int(base.split("-")[1])
        except (IndexError, ValueError):
            step = 0
        return True, step


def resume_train_state_math(
    num_batches_per_epoch: int,
    gradient_accumulation_steps: int,
    max_train_steps: Optional[int],
    max_train_epochs: int,
    resumed_global_step: int,
) -> dict:
    """{max_train_steps, max_train_epochs, global_step, start_epoch,
    resume_step, num_update_steps_per_epoch}; ``resume_step`` counts the micro
    batches to skip inside the start epoch."""
    num_update_steps_per_epoch = math.ceil(num_batches_per_epoch / gradient_accumulation_steps)
    if max_train_steps is None:
        max_train_steps = max_train_epochs * num_update_steps_per_epoch
    else:
        max_train_epochs = math.ceil(max_train_steps / num_update_steps_per_epoch)
    global_step = resumed_global_step
    start_epoch = global_step // num_update_steps_per_epoch if global_step else 0
    resume_step = (
        global_step % num_update_steps_per_epoch * gradient_accumulation_steps if global_step else 0
    )
    return {
        "max_train_steps": max_train_steps,
        "max_train_epochs": max_train_epochs,
        "global_step": global_step,
        "start_epoch": start_epoch,
        "resume_step": resume_step,
        "num_update_steps_per_epoch": num_update_steps_per_epoch,
    }
