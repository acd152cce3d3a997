"""Chained dispatch (``--steps-per-dispatch N``): N optimizer steps a chunk,
their metrics pulled to the host once (port of the JAX trainer's
``_build_chain``, ``_train_chunk`` and the chunk rule of ``_micro_steps``,
``trainers/trainer.py:260-440``).

JAX scans N optimizer steps inside one XLA program. On a CUDA device, with
one process and the moments on the card, the counterpart is one CUDA graph
per optimizer step (its accumulation micro steps and the update), captured
once and replayed N times a chunk with no host sync between the replays
(:class:`StepGraph`). Each step's draws are made outside the graph with the
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

import time
from typing import Any, Callable, List, Optional

import torch

from stable_diffusion_pytorch_tpu_torch.ops import native


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


def tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in order (None skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors(x)]
    if tree is None:
        return []
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    return tree


def _signature(tree) -> list:
    return [(tuple(t.shape), t.dtype, t.device) for t in tensors(tree)]


class StepGraph:
    """One optimizer step as a CUDA graph: ``body(inputs) -> metrics`` (f32
    ``[micro steps, K]``) over static ``inputs`` (a tree of the step's
    batches and draws).

    Made with the first step's inputs: that step runs eagerly on a side
    stream (the warm-up, a real step: it makes what a step makes once, the
    GroupNorm backward's slice counters, library handles and workspaces for
    the stream), its metrics in ``first``; then the same body is captured
    into a graph with a private memory pool, which holds the step's
    activations for the graph's life. Capture runs the body's host code once
    and the device work not at all, so the host's counters the body moves
    (``save_counters`` -> a restore function) are put back after it. The
    kernel launches recorded under capture (``native.end_capture``) are added
    to the launch counters at each replay. A failed capture raises: nothing
    falls back to the eager step.

    :meth:`replay` copies the next step's inputs into the static ones and
    replays the graph on the current stream; the returned metrics are the
    graph's own buffer, rewritten by the next replay. ``warmup_s`` and
    ``capture_s``: the host's seconds of the warm-up step (waited for) and of
    the capture."""

    def __init__(self, body: Callable[[Any], torch.Tensor], inputs, save_counters: Callable[[], Callable[[], None]],
                 pinned: Callable[[], List[torch.Tensor]]):
        device = tensors(inputs)[0].device
        self.static = _map(lambda t: t.clone(), inputs)
        self._signature = _signature(inputs)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            self.first = body(self.static)
        torch.cuda.current_stream(device).wait_stream(side)
        side.synchronize()
        self.warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restore = save_counters()
        graph = torch.cuda.CUDAGraph()
        native.begin_capture()
        try:
            with torch.cuda.graph(graph, stream=side):
                self.out = body(self.static)
        except Exception as exc:
            native.end_capture(ok=False)
            raise RuntimeError(f"chained dispatch: capturing the optimizer step as a CUDA graph failed ({exc}); "
                               "run with --steps-per-dispatch 1 for the per-step path") from exc
        finally:
            restore()
        self.tally = native.end_capture()
        self.capture_s = time.perf_counter() - t0
        self.graph = graph
        self._pinned = pinned
        self._pointers = [t.data_ptr() for t in pinned()]

    def replay(self, inputs) -> torch.Tensor:
        if _signature(inputs) != self._signature:
            raise RuntimeError(f"chained dispatch: the step's inputs {_signature(inputs)} differ from the captured "
                               f"graph's {self._signature}")
        if [t.data_ptr() for t in self._pinned()] != self._pointers:
            raise RuntimeError("chained dispatch: a parameter or an optimizer state tensor moved since the step "
                               "was captured")
        for dst, src in zip(tensors(self.static), tensors(inputs)):
            dst.copy_(src)
        self.graph.replay()
        native.add_replays(self.tally)
        return self.out


def route(spd: int, device: torch.device, offload: bool, group) -> Optional[str]:
    """How ``--steps-per-dispatch spd`` runs: None (one step at a time: spd 1,
    or the optimizer offloaded, as in JAX), ``"graph"`` (a CUDA device, one
    process: each optimizer step replayed as a CUDA graph) or ``"eager"``
    (the CPU, or a process group: chunks of steps run one after the other)."""
    if spd <= 1 or offload:
        return None
    if device.type == "cuda" and group is None:
        return "graph"
    return "eager"
