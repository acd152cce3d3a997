"""Experiment tracking: std logging, a JSONL metrics file and the optional
wandb sink (port of utils/tracking.py).

The tracker always writes ``{logging_dir}/{run_name}_metrics.jsonl``; fields
set with ``set_persistent`` (``synthetic_fallback``) are stamped on every
record. ``--with-tracking`` adds a wandb run (``--report-to wandb``, the only
platform the JAX package knows: any other raises ``NotImplementedError``),
and raises ``ImportError`` where wandb is not installed. Images
(``log_images``) go to wandb only.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional


def get_logger(name: str) -> logging.Logger:
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        level=logging.INFO,
        force=True,
    )
    return logging.getLogger(name)


class Tracker:
    """Metrics sink: one JSON line per ``log`` call; wandb under ``with_tracking``.
    ``enabled=False`` (every rank but rank 0 of a multi-device run) makes a
    sink that writes nothing."""

    def __init__(self, log_cfg, run_name: str, config: Optional[Dict] = None, enabled: bool = True):
        self.wandb = None
        self._persistent: Dict[str, Any] = {}
        self.jsonl_path = os.path.join(log_cfg.logging_dir, f"{run_name}_metrics.jsonl")
        self._jsonl = None
        if not enabled:
            return
        if log_cfg.with_tracking:
            if log_cfg.report_to != "wandb":
                raise NotImplementedError("Currently only support wandb; add an init for your platform")
            try:
                import wandb
            except ImportError as e:
                raise ImportError(
                    "You passed with_tracking and report_to `wandb`; wandb is not "
                    "installed in this environment (`pip install wandb`)"
                ) from e
            wandb.init(project="stable_diffusion_pytorch_tpu", name=f"run_{time.strftime('%Y-%m-%d_%H:%M:%S')}",
                       group=run_name, resume=log_cfg.resume, config=config or {})
            self.wandb = wandb
        os.makedirs(log_cfg.logging_dir, exist_ok=True)
        self._jsonl = open(self.jsonl_path, "a")

    def set_persistent(self, **fields) -> None:
        """Fields stamped on every later record (``synthetic_fallback=True``)."""
        self._persistent.update(fields)

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        if self._jsonl is None:
            return
        record = {"step": step, "time": time.time(), **self._persistent, **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def log_images(self, images: Dict[str, Any], step: int) -> None:
        """``images``: name -> HWC uint8 array, or a list of them (wandb only)."""
        if self.wandb is not None:
            self.wandb.log({k: [self.wandb.Image(img) for img in (v if isinstance(v, list) else [v])]
                            for k, v in images.items()}, step=step)

    def finish(self) -> None:
        if self._jsonl is None:
            return
        self._jsonl.close()
        if self.wandb is not None:
            self.wandb.finish()
