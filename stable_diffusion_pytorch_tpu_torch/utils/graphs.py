"""One body over static inputs captured once as a CUDA graph and replayed.

The JAX package compiles what it runs once per signature (``jax.jit``) and
reruns the program: the trainers' optimizer step and its chunks
(``--steps-per-dispatch``), their evaluation step, the sampling loop's
``lax.scan`` (``LatentDiffusion._jit_cache``), the text encoder. On a CUDA
device the port's counterpart is :class:`CapturedGraph`: the trainers
capture one optimizer step (``trainers/chain.py``) and their evaluation
step, the sampling loop one whole reverse loop
(``models/latent_diffusion.py``), the text encoder its tower
(``models/clip.py``). Each owner keeps its graphs in one :class:`GraphPool`:
one memory pool and one side stream for all of them.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional

import torch

from stable_diffusion_pytorch_tpu_torch.ops import native


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


def map_tensors(fn, tree):
    """``tree`` with each tensor replaced by ``fn(tensor)``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, x) for x in tree)
    return tree


def signature(tree) -> list:
    """(shape, dtype, device) of each tensor of ``tree``, in order."""
    return [(tuple(t.shape), t.dtype, t.device) for t in tensors(tree)]


def _no_restore():
    return lambda: None


def _after_failed_capture(pool, current: torch.cuda.Stream, side: torch.cuda.Stream) -> None:
    """Undo what a capture into ``pool`` that failed on ``side`` leaves behind.

    ``torch.cuda.graph`` leaves its stream context only once the capture has
    ended, so ``current`` is made the current stream again. The caching
    allocator still routes to the pool (its filter outliving the graph); the
    routing is ended (nothing is done where the capture ended it). The pool
    itself takes no further capture (torch 2.11 keeps it marked as
    recording; a new pool on the same stream captures): the caller must
    capture into another. The CUDA generators a capture registers stay
    marked as capturing until a capture ends, and a random draw on the card
    raises meanwhile: one capture of a no-op is made on ``side`` and ends."""
    torch.cuda.set_stream(current)
    try:
        torch._C._cuda_endAllocateToPool(current.device.index, pool)
    except RuntimeError:  # the capture's own end had ended it
        pass
    scratch = torch.zeros(1, device=current.device)
    no_op = torch.cuda.CUDAGraph()
    with torch.cuda.graph(no_op, stream=side):
        scratch.add_(1)
    del no_op


class CapturedGraph:
    """``body(inputs)`` as a CUDA graph over static ``inputs`` (a tree of
    tensors on one CUDA device), made from the first call's inputs.

    That call runs the body eagerly on a side stream (the warm-up: a real
    call, whose result is :attr:`first`; it makes what a body makes once,
    such as library handles and workspaces for the stream, and fills the
    caller's lazy device tables outside the graph's pool). Then the same body
    is captured on the side stream into the memory pool ``pool`` (None: a
    private one; a ``torch.cuda.graph_pool_handle()`` shared by graphs whose
    replays never overlap and whose callers keep inputs and outputs outside it).
    The side stream is ``stream``, or a new one when None. Graphs that share a
    pool must share the stream too: the caching allocator hands a freed block
    only to an allocation on the stream that freed it, so a capture on
    another stream reuses none of the temporaries the pool already holds.
    Capture runs the body's host code once and the device work not at all,
    so the host's counters the body moves (``save_counters`` -> a restore
    function) are put back after it. The kernel launches recorded under
    capture (``native.end_capture``) are added to the launch counters at
    each replay. A failed capture raises, naming ``what`` (and ``advice``):
    nothing falls back to the eager body. Before it raises it undoes what
    the failed capture left behind (:func:`_after_failed_capture`), so the
    process goes on drawing, initializing and capturing on the card, into
    any pool but ``pool``.
    ``capture_error_mode`` is ``torch.cuda.graph``'s: ``"global"`` refuses
    unsafe CUDA calls from any thread during the capture, ``"thread_local"``
    only from the capturing one.

    :meth:`replay` checks the inputs' signature and the ``pinned`` tensors'
    pointers (what the graph reads in place: parameters, optimizer state)
    against the capture's, copies the inputs into the static ones and
    replays on the current stream; the result is the graph's own output,
    rewritten by the next replay of any graph in its pool. ``warmup_s`` and
    ``capture_s``: the host's seconds of the warm-up (waited for) and of the
    capture."""

    def __init__(self, body: Callable[[Any], Any], inputs, *, what: str,
                 save_counters: Optional[Callable[[], Callable[[], None]]] = None,
                 pinned: Callable[[], List[torch.Tensor]] = list, pool=None,
                 stream: Optional[torch.cuda.Stream] = None, capture_error_mode: str = "global",
                 advice: str = ""):
        self.what = what
        device = tensors(inputs)[0].device
        current = torch.cuda.current_stream(device)
        with torch.inference_mode(False):  # copied into by replays in any mode
            self.static = map_tensors(lambda t: t.clone(), inputs)
        self._signature = signature(inputs)
        side = stream if stream is not None else torch.cuda.Stream(device)
        side.wait_stream(current)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            self.first = body(self.static)
        current.wait_stream(side)
        side.synchronize()
        for t in tensors(self.first):  # made on the side stream, read on the caller's
            t.record_stream(current)
        self.warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restore = (save_counters or _no_restore)()
        graph = torch.cuda.CUDAGraph()
        if pool is None:  # a private pool, by an id known if the capture fails
            pool = torch.cuda.graph_pool_handle()
        native.begin_capture()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=side, capture_error_mode=capture_error_mode):
                self.out = body(self.static)
        except Exception as exc:
            native.end_capture(ok=False)
            _after_failed_capture(pool, current, side)
            raise RuntimeError(f"capturing {what} as a CUDA graph failed ({exc})"
                               + (f"; {advice}" if advice else "")) from exc
        finally:
            restore()
        self.tally = native.end_capture()
        self.capture_s = time.perf_counter() - t0
        self.graph = graph
        self._pinned = pinned
        self._pointers = [t.data_ptr() for t in pinned()]

    def takes(self, inputs) -> bool:
        """Whether ``inputs`` have the captured inputs' signature."""
        return signature(inputs) == self._signature

    def replay(self, inputs):
        got = signature(inputs)
        if got != self._signature:
            raise RuntimeError(f"{self.what}: the inputs {got} differ from the captured graph's {self._signature}")
        if [t.data_ptr() for t in self._pinned()] != self._pointers:
            raise RuntimeError(f"{self.what}: a tensor the graph reads in place (a parameter or an optimizer "
                               "state) moved since the graph was captured")
        for dst, src in zip(tensors(self.static), tensors(inputs)):
            dst.copy_(src)
        self.graph.replay()
        native.add_replays(self.tally)
        return self.out


class GraphPool:
    """The CUDA graphs of one owner (a trainer, a model, a tower): one memory
    pool and one side stream that all of them share, made at the first
    capture, and one graph per key (:meth:`run`).

    The graphs of a pool must never replay at once and their callers keep
    inputs and outputs outside it (:meth:`run` clones each output out): then
    a capture reuses the temporaries of the captures before it, and the pool
    grows to the largest body's temporaries plus one output per graph. A
    failed capture raises and retires the pool (it takes no further capture,
    :func:`_after_failed_capture`): the next capture starts a new one, the
    graphs already captured keep theirs. The pool is released when its
    graphs are (:meth:`clear`, or the owner going)."""

    def __init__(self, capture_error_mode: str = "thread_local"):
        self.capture_error_mode = capture_error_mode
        self.pool = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.graphs: dict = {}

    def capture(self, body: Callable[[Any], Any], inputs, graph_cls=None, **kwargs) -> CapturedGraph:
        """A :class:`CapturedGraph` (or ``graph_cls``, a subclass) of ``body``
        in this pool, on its stream (``kwargs``: the graph's own, ``what``
        among them)."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        if self.stream is None:
            self.stream = torch.cuda.Stream(tensors(inputs)[0].device)
        kwargs.setdefault("capture_error_mode", self.capture_error_mode)
        try:
            return (graph_cls or CapturedGraph)(body, inputs, pool=self.pool, stream=self.stream, **kwargs)
        except Exception:
            self.pool = None  # it takes no further capture: the next starts a new pool
            raise

    def run(self, key, body: Callable[[Any], Any], inputs, **kwargs):
        """``body(inputs)`` through the graph of ``key``: its first call is the
        warm-up (whose result it returns) and the capture, later calls replay
        and clone the output out."""
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = self.capture(body, inputs, **kwargs)
            first, graph.first = graph.first, None
            return first
        return map_tensors(torch.clone, graph.replay(inputs))

    def clear(self) -> None:
        """Drop every graph (and with the last of them the pool's memory); the
        next capture starts a new pool."""
        self.graphs.clear()
        self.pool = None


def replayed(graphs: GraphPool, body: Callable[[Any], Any], inputs, *, what: str, pinned=list, key=None,
             capture: bool = True):
    """``body(inputs)``: on a CUDA device through the graph of ``graphs``
    keyed by ``key`` (the inputs' signature by default), its output cloned
    out; eagerly on the CPU, with ``capture`` False, or inside another
    capture (which then records the body itself)."""
    if (tensors(inputs)[0].device.type != "cuda" or not capture
            or torch.cuda.is_current_stream_capturing()):
        return body(inputs)
    key = tuple(signature(inputs)) if key is None else key
    return graphs.run(key, body, inputs, what=what, pinned=pinned)


def module_tensors(*modules) -> Callable[[], List[torch.Tensor]]:
    """-> a function listing the parameters and buffers of ``modules``
    (what a captured body reads in place)."""
    return lambda: [t for m in modules for t in (*m.parameters(), *m.buffers())]
