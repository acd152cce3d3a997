"""Chained dispatch (``--steps-per-dispatch N``): N optimizer steps a chunk,
their metrics pulled to the host once (port of the JAX trainer's
``_build_chain``, ``_train_chunk`` and the chunk rule of ``_micro_steps``,
``trainers/trainer.py:260-440``).

JAX scans N optimizer steps inside one XLA program. On a CUDA device, with
one process and the moments on the card, the counterpart is one CUDA graph
per optimizer step (its accumulation micro steps and the update), captured
once and replayed N times a chunk with no host sync between the replays
(:class:`StepGraph`, on the mechanism the sampling loop shares,
``utils/graphs.py``); so is each optimizer step at N = 1, the JAX package's
per-step ``_jit_step``. Each step's draws are made outside the graph with the
per-step path's generators and copied, with the batches, into the graph's
static inputs; the optimizer's scalars are a chunk's rows uploaded at once,
row i copied into the optimizer's buffer before step i
(``trainers/optim.py``); the metrics, one row per micro step, stay on the
device until the chunk's end. Without a graph (the CPU, or a process group,
whose collectives are not captured) the same chunks run the steps one after
the other, with the same one pull a chunk.

:func:`chunk_safe` is the JAX rule: a chunk starts on an optimizer-step
boundary, holds N optimizer steps, does not run past ``max_train_steps``, and
no checkpoint or evaluation step falls strictly inside it.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from stable_diffusion_pytorch_tpu_torch.utils.graphs import CapturedGraph


def chunk_safe(micro: int, steps: int, accum: int, max_train_steps: int, ckpt_steps, log_interval: int,
               eval_offset: int = 0) -> bool:
    """Whether a chunk of ``steps`` optimizer steps may start at micro step
    ``micro``: on an optimizer-step boundary, within ``max_train_steps``, and
    no checkpoint (``ckpt_steps``, an int or not) nor evaluation step
    (``(G + eval_offset) % log_interval == 0``) strictly inside it (JAX
    ``_micro_steps.chunk_safe``)."""
    if micro % accum:
        return False
    g = micro // accum  # optimizer steps completed
    if g + steps > max_train_steps:
        return False
    for step in range(g + 1, g + steps):
        if isinstance(ckpt_steps, int) and ckpt_steps > 0 and step % ckpt_steps == 0:
            return False
        if log_interval and log_interval > 0 and (step + eval_offset) % log_interval == 0:
            return False
    return True


class StepGraph(CapturedGraph):
    """One optimizer step as a CUDA graph (``utils/graphs.py:CapturedGraph``):
    ``body(inputs) -> metrics`` (f32 ``[micro steps, K]``) over static
    ``inputs`` (a tree of the step's batches and draws), in the trainer's
    pool (``pool``, ``stream``: its :class:`~stable_diffusion_pytorch_tpu_torch.utils.graphs.GraphPool`'s).

    Made with the first step's inputs: that step runs eagerly on a side
    stream (the warm-up, a real step: it makes what a step makes once, the
    GroupNorm backward's slice counters, library handles and workspaces for
    the stream), its metrics in ``first``; then the same body is captured.
    The host's counters the step moves (``save_counters``) are put back after
    the capture, and ``pinned`` (the parameters, the optimizer state, the
    EMA) must not move between replays. A failed capture raises: nothing
    falls back to the eager step."""

    def __init__(self, body: Callable[[Any], torch.Tensor], inputs, save_counters: Callable[[], Callable[[], None]],
                 pinned: Callable[[], List[torch.Tensor]], **kwargs):
        kwargs.setdefault("capture_error_mode", "global")
        super().__init__(body, inputs, what="the optimizer step", save_counters=save_counters, pinned=pinned,
                         advice="build the trainer with capture=False for the eager step", **kwargs)


def route(spd: int, device: torch.device, offload: bool, group, capture: bool = True) -> Optional[str]:
    """How the optimizer steps run at ``--steps-per-dispatch spd``:
    ``"graph"`` (a CUDA device, one process, the trainer built with
    ``capture``: each optimizer step replayed as one CUDA graph, at spd 1
    too, as the JAX package runs each step as one jitted program), None (one
    micro step at a time: the optimizer offloaded, as in JAX, or spd 1 off
    the graph route: the CPU, a process group, ``capture=False``) or
    ``"eager"`` (spd above 1 off the graph route: chunks of steps run one
    after the other, one pull of the metrics a chunk)."""
    if offload:
        return None
    if device.type == "cuda" and group is None and capture:
        return "graph"
    return "eager" if spd > 1 else None
