"""Experiment tracking: std logging and a JSONL metrics file (port of
utils/tracking.py). The tracker writes ``{logging_dir}/{run_name}_metrics.jsonl``;
the JAX package's optional wandb sink (``--with-tracking``) is not ported and
the trainer refuses that flag.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict


def get_logger(name: str) -> logging.Logger:
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        level=logging.INFO,
        force=True,
    )
    return logging.getLogger(name)


class Tracker:
    """Metrics sink: one JSON line per ``log`` call."""

    def __init__(self, log_cfg, run_name: str):
        os.makedirs(log_cfg.logging_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_cfg.logging_dir, f"{run_name}_metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        record = {"step": step, "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def finish(self) -> None:
        self._jsonl.close()
