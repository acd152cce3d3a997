"""The int8 Adam optimizer step (K9): its plain version, the quantization rules,
the work plan and the wrappers around the CUDA kernel.

Replaces the Pallas TPU kernel ``stable_diffusion_pytorch_tpu/ops/adam8bit_update.py``
``_kernel`` and the XLA leaf path of ``trainers/adam8bit.py`` beside it (the
JAX package states the two are numerically the same), and fuses in the
gradient clip before it and the parameter apply after it. Per leaf: clip the
gradient by the global norm, dequantize the stored moments, run the f32 Adam
recurrence with the bias corrections passed in, form
``update = (mu / bc1) / (sqrt(nu / bc2) + eps)``, take the blockwise absmax of
the new moments and requantize them (``nu`` in the sqrt domain), and apply
``p += -lr * (wd * p + update)``. The CUDA C++ kernel is
``csrc/adam8bit_update.cu``, built by ``ops/native.py``: one launch per
optimizer step over every leaf (:class:`Adam8bitStep`), codes, scales and
parameters updated in place; :func:`adam8bit_update` is its one-leaf case,
which returns the update and new state instead.

The code (the JAX package's ``_quantize``/``_dequantize``)::

    q  = clip(round(127 * sign(x) * sqrt(|x| / absmax_block)), -127, 127)   int8
    x~ = sign(q) * (q/127)^2 * absmax_block

Layout. JAX blocks along each parameter's minor axis, its output channel:
conv ``[kh, kw, I, O]``, dense ``[I, O]``, 1-D ``[C]``. The port stores convs
as ``[O, I, kh, kw]`` and linears as ``[O, I]`` (``utils/convert.py``), so the
same blocks run along torch dim 0 (:data:`BLOCK_DIM`; a test derives it from
the converter's map). A leaf is viewed as ``[O, R]`` with ``R = numel / O``;
along dim 0 the blocks are ``block_size`` rows for each column ``r`` when
``O % block_size == 0 and O > block_size``, else one block of ``O`` rows
(``_blocked_view``'s rule). Codes keep the parameter's shape; scales are f32
``[nb, *shape[1:]]``, the JAX scale under the weight's own transpose.
In memory, the kernel needs dim 0 outermost and the columns of codes,
scales, gradient and parameter in one order: all contiguous, or (4-D conv
weights, which the port keeps ``channels_last``) all ``channels_last``
(:func:`zeros_state` makes the state in its parameter's format).

The JAX size gate, VMEM budget and row tiling are TPU mechanisms and are not
ported: on a CUDA tensor every leaf goes to the kernel, 1-D leaves included.
"""

from __future__ import annotations

import functools
import weakref
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from stable_diffusion_pytorch_tpu_torch.ops import native

LAUNCHES = native.counter("adam8bit_update")
BLOCK_DIM = 0  # the torch dim that holds JAX's minor (output-channel) axis
_G_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The kernel's work decomposition (csrc/adam8bit_update.cu)
THREADS = 512          # threads of a CTA, which takes one work item
ITEM_ELEMS = 8192      # the most elements of a one-pass item: its two f32 moments, 64 KB of shared memory
MIN_COLS = 8           # the fewest columns of a one-pass item on the column mapping (32-byte f32 rows)
ROW_MAPPING_R = 32     # leaves narrower than a warp take the row mapping
RECOMPUTE = 1 << 30    # item flag: the moments are recomputed for the requantize
COLS = RECOMPUTE - 1   # the item's columns, below the flag
# one leaf of the device table: 10 pointers and two integers (the C struct Leaf)
LEAF_FIELDS = ("mu_q", "mu_s", "nu_q", "nu_s", "mu_q_out", "mu_s_out", "nu_q_out", "nu_s_out", "p", "upd",
               "R", "block")

QState = Tuple[torch.Tensor, torch.Tensor]  # (int8 codes, f32 scales)


def blocked_layout(shape, block_size: int) -> Tuple[int, int, int, int]:
    """-> (O, R, block, nb): rows along dim 0, columns, rows per block, blocks."""
    o = int(shape[0]) if len(shape) else 1
    numel = 1
    for d in shape:
        numel *= int(d)
    r = numel // o if o else 0
    block = block_size if (o % block_size == 0 and o > block_size) else o
    return o, r, block, (o // block if block else 0)


def scale_shape(shape, block_size: int) -> Tuple[int, ...]:
    """The f32 scales' shape of a leaf: ``[nb, *shape[1:]]``."""
    nb = blocked_layout(shape, block_size)[3]
    return (nb, *tuple(shape)[1:]) if len(shape) else (1,)


def memory_format(t: torch.Tensor) -> torch.memory_format:
    """``channels_last`` for a 4-D tensor laid out so (and not contiguous), else contiguous."""
    if t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def zeros_state(p: torch.Tensor, block_size: int) -> QState:
    """All-zero (codes, scales) for parameter ``p``, in ``p``'s memory format."""
    fmt = memory_format(p)
    return (torch.zeros_like(p, dtype=torch.int8, memory_format=fmt),
            torch.zeros(scale_shape(p.shape, block_size), dtype=torch.float32, device=p.device)
            .contiguous(memory_format=fmt))


def quantize(x: torch.Tensor, block_size: int) -> QState:
    """f32 values -> (int8 codes in x's shape, f32 scales [nb, *shape[1:]])."""
    o, r, block, nb = blocked_layout(x.shape, block_size)
    xb = x.float().reshape(nb, block, r)
    absmax = xb.abs().amax(dim=1, keepdim=True)
    safe = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    y = xb / safe
    q = torch.clamp(torch.round(127.0 * torch.sign(y) * torch.sqrt(torch.abs(y))), -127, 127)
    return q.to(torch.int8).reshape(x.shape), absmax.reshape(scale_shape(x.shape, block_size))


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(codes, scales) -> f32 values in the codes' shape."""
    nb = scale.shape[0]
    o, r = (q.shape[0], q.numel() // q.shape[0]) if q.dim() else (1, 1)
    qf = q.float().reshape(nb, o // nb, r) * (1.0 / 127.0)
    x = torch.sign(qf) * qf * qf * scale.reshape(nb, 1, r)
    return x.reshape(q.shape)


def adam8bit_update_plain(
    g: torch.Tensor, mu: QState, nu: QState, bc1, bc2,
    b1: float, b2: float, eps: float, block_size: int,
) -> Tuple[torch.Tensor, QState, QState]:
    """-> (update in g's dtype, new mu codes and scales, new nu codes and
    scales); the op order of the JAX package's XLA leaf path. The bias
    corrections (floats or 0-d f32 tensors) divide as 0-d tensors on g's
    device: PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, which is not IEEE division (JAX's and the kernel's)."""
    g32 = g.float()
    bc1, bc2 = (torch.as_tensor(b, dtype=torch.float32, device=g.device) for b in (bc1, bc2))
    m = b1 * dequantize(*mu) + (1.0 - b1) * g32
    v = b2 * dequantize(*nu) ** 2 + (1.0 - b2) * g32 * g32
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    return upd.to(g.dtype), quantize(m, block_size), quantize(torch.sqrt(v), block_size)


def adam8bit_step_plain(
    params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], mu: Sequence[QState], nu: Sequence[QState],
    norm: Optional[torch.Tensor], bc1, bc2, lr, b1: float, b2: float, eps: float,
    weight_decay: float, max_grad_norm: Optional[float], block_size: int,
) -> None:
    """The whole step in place, leaf by leaf, in the JAX chain's order: the
    clip (``optax.clip_by_global_norm``: ``g`` when ``norm < c``, else
    ``(g / norm) * c`` in the gradient's dtype), :func:`adam8bit_update_plain`,
    and ``p += -lr * (p * wd + update)`` in f32 (``add_decayed_weights``,
    ``scale_by_learning_rate``, ``apply_updates``); the new codes and scales
    are copied into the state's tensors. ``bc1``, ``bc2``, ``lr``: floats or
    0-d f32 tensors, the same bits either way."""
    if max_grad_norm is not None:
        c = torch.full((), max_grad_norm, dtype=torch.float32, device=norm.device)
        keep = norm < c
    for p, g, m, n in zip(params, grads, mu, nu):
        if max_grad_norm is not None:
            g = torch.where(keep, g, (g / norm.to(g.dtype)) * c.to(g.dtype))
        upd, new_mu, new_nu = adam8bit_update_plain(g, m, n, bc1, bc2, b1, b2, eps, block_size)
        t = p * weight_decay
        t.add_(upd)
        t.mul_(-lr)
        p.add_(t)
        for state, new in ((m, new_mu), (n, new_nu)):
            state[0].copy_(new[0])
            state[1].copy_(new[1])


# --------------------------------------------------------------------------- #
# the work plan
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class LeafPlan:
    """One leaf of :func:`adam8bit_plan`: its ``[O, R]`` view and blocks, the
    mapping of its items (``row``: R < 32, the whole width in one item, a
    block's rows across the lanes; ``column``: ``cols`` neighbouring columns
    an item, a warp's lanes on neighbouring columns), whether its items keep
    the moments on chip (``one_pass``) or recompute them, and its items."""

    o: int
    r: int
    block: int
    nb: int
    mapping: str
    cols: int
    one_pass: bool
    first_item: int
    n_items: int


@dataclass(frozen=True, eq=False)
class Adam8bitPlan:
    leaves: Tuple[LeafPlan, ...]
    items: np.ndarray  # int32 [n_items, 4]: leaf, block j, first column, columns | RECOMPUTE
    smem_elems: int    # the largest one-pass item's elements (its moments in shared memory)


def _floor_pow2(x: int) -> int:
    return 1 << (x.bit_length() - 1) if x > 0 else 0


def _leaf_mapping(r: int, block: int, item_elems: int) -> Tuple[str, int, bool]:
    """(mapping, columns per item, one pass) of a leaf's items."""
    if r < ROW_MAPPING_R:
        return "row", r, block * r <= item_elems
    fit = _floor_pow2(min(THREADS, item_elems // max(block, 1)))
    if fit >= MIN_COLS:
        return "column", min(fit, r), True
    return "column", ROW_MAPPING_R, False


@functools.lru_cache(maxsize=64)
def _plan(shapes: Tuple[Tuple[int, ...], ...], block_size: int, item_elems: int) -> Adam8bitPlan:
    leaves, items, first, smem = [], [], 0, 0
    for i, shape in enumerate(shapes):
        o, r, block, nb = blocked_layout(shape, block_size)
        mapping, cols, one_pass = _leaf_mapping(r, block, item_elems)
        n = 0
        if o and r:
            c0 = np.arange(0, r, cols, dtype=np.int64)
            n = nb * len(c0)
            width = np.minimum(cols, r - c0) | (0 if one_pass else RECOMPUTE)
            items.append(np.stack([np.full(n, i), np.repeat(np.arange(nb), len(c0)), np.tile(c0, nb),
                                   np.tile(width, nb)], axis=1))
            if one_pass:
                smem = max(smem, block * cols)
        leaves.append(LeafPlan(o, r, block, nb, mapping, cols, one_pass, first, n))
        first += n
    table = np.concatenate(items).astype(np.int32) if items else np.zeros((0, 4), np.int32)
    table.setflags(write=False)
    return Adam8bitPlan(tuple(leaves), table, smem)


def adam8bit_plan(shapes, block_size: int = 256, item_elems: int = ITEM_ELEMS) -> Adam8bitPlan:
    """The work plan of one launch over leaves of ``shapes``: a pure function
    of the shapes, which the tests check over the SD-1.5 UNet's leaves.

    Each quantization block (block ``j`` of a leaf, all its rows, one column)
    lies in exactly one work item ``(leaf, j, first column, columns)``, and
    one CTA of :data:`THREADS` threads takes an item: thread ``t`` the column
    ``t % cols`` and every ``THREADS // cols``-th row from ``t // cols``.
    Leaves narrower than a warp (R < 32: every 1-D leaf) take their whole
    width in an item (the row mapping); wider ones take runs of columns (the
    column mapping), as many as keep an item within ``item_elems`` elements,
    a power of two of at most :data:`THREADS`. An item keeps its moments in
    shared memory between the absmax and the requantize (one pass) when it
    holds at most ``item_elems`` elements with at least :data:`MIN_COLS`
    columns; a taller block takes 32 columns and recomputes them (flag
    :data:`RECOMPUTE`)."""
    return _plan(tuple(tuple(int(d) for d in s) for s in shapes), int(block_size), int(item_elems))


# --------------------------------------------------------------------------- #
# the launch
# --------------------------------------------------------------------------- #


def _f32(x: float) -> float:
    return float(np.float32(x))


def _scalar_words(bc1: float, bc2: float, lr: float) -> np.ndarray:
    """The step's f32 scalars {bc1, bc2, lr} as two int64 words of a table."""
    return np.array([bc1, bc2, lr, 0.0], dtype=np.float32).view(np.int64)


def _table(plan: Adam8bitPlan, rows) -> np.ndarray:
    """The device table: the leaves' rows (:data:`LEAF_FIELDS`), then the items."""
    leaves = np.asarray(rows, dtype=np.int64).reshape(-1, len(LEAF_FIELDS))
    return np.concatenate([leaves.ravel(), np.ascontiguousarray(plan.items).view(np.int64).ravel()])


def _upload(host: np.ndarray, device) -> torch.Tensor:
    """One host-to-device copy of an int64 array, from pinned memory, queued on
    the current stream (the caching host allocator keeps the staging buffer
    until the copy has run)."""
    staged = torch.from_numpy(host).pin_memory()
    return torch.empty(host.shape, dtype=torch.int64, device=device).copy_(staged, non_blocking=True)


def _launch(dtype, device, table: torch.Tensor, plan: Adam8bitPlan, grad_words: int, scalars: int, norm,
            max_grad_norm: Optional[float], b1: float, b2: float, eps: float, wd: float) -> None:
    """One launch over ``plan``'s items; ``grad_words``: the device address of
    one gradient pointer per leaf, ``scalars``: of the f32 {bc1, bc2, lr}."""
    leaves = table.data_ptr()
    items = leaves + 8 * len(LEAF_FIELDS) * len(plan.leaves)
    lib = native.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.sd_adam8bit_step(
            _G_CODES[dtype], leaves, items, len(plan.items), grad_words, scalars,
            None if max_grad_norm is None else norm.data_ptr(), _f32(max_grad_norm or 0.0), _f32(b1),
            _f32(1.0 - b1), _f32(b2), _f32(1.0 - b2), _f32(eps), _f32(wd), plan.smem_elems, stream,
        )
    if rc != 0:
        raise RuntimeError(f"adam8bit kernel launch failed: CUDA error {rc}")


def _check_leaf(i, p, g, mu, nu, block_size, device) -> None:
    """Raise unless leaf ``i`` is laid out as the kernel reads it: codes int8
    in the parameter's shape, scales f32 ``[nb, *shape[1:]]``, all on
    ``device``, all in the codes' memory format; ``p`` f32 (or None)."""
    want_scale = scale_shape(g.shape, block_size)
    if g.dtype not in _G_CODES:
        raise TypeError(f"adam8bit: leaf {i}: float32 or bfloat16 gradients only (got {g.dtype})")
    if p is not None and (p.dtype != torch.float32 or p.shape != g.shape):
        raise ValueError(f"adam8bit: leaf {i}: the parameter must be float32 {tuple(g.shape)} "
                         f"(got {p.dtype} {tuple(p.shape)})")
    for name, (q, s) in (("mu", mu), ("nu", nu)):
        if q.dtype != torch.int8 or q.shape != g.shape or s.dtype != torch.float32 or tuple(s.shape) != want_scale:
            raise ValueError(
                f"adam8bit: leaf {i}: {name} must be int8 codes {tuple(g.shape)} and f32 scales {want_scale} "
                f"(got {q.dtype} {tuple(q.shape)}, {s.dtype} {tuple(s.shape)})")
    fmt = memory_format(mu[0])
    for t in (g, *mu, *nu, *(() if p is None else (p,))):
        if t.device != device or not t.is_contiguous(memory_format=fmt):
            raise ValueError(
                f"adam8bit: leaf {i}: gradient, parameter, codes and scales must lie on {device}, all contiguous "
                "or all channels_last")


def adam8bit_update(
    g: torch.Tensor, mu: QState, nu: QState, bc1: float, bc2: float,
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, block_size: int = 256,
) -> Tuple[torch.Tensor, QState, QState]:
    """One leaf's int8 Adam update (no clip, no apply): the kernel on a CUDA
    tensor (one launch, the one-leaf case of the step's table), the plain
    version on a CPU tensor. Returns new tensors; the inputs are not changed."""
    if not g.is_cuda:
        return adam8bit_update_plain(g, mu, nu, bc1, bc2, b1, b2, eps, block_size)
    g = g.contiguous(memory_format=memory_format(mu[0]))  # the state's layout
    plan = adam8bit_plan([g.shape], block_size)
    _check_leaf(0, None, g, mu, nu, block_size, g.device)
    upd = torch.empty_like(g)
    new_mu = (torch.empty_like(mu[0]), torch.empty_like(mu[1]))
    new_nu = (torch.empty_like(nu[0]), torch.empty_like(nu[1]))
    if not len(plan.items):
        return upd, new_mu, new_nu
    leaf = plan.leaves[0]
    row = [t.data_ptr() for t in (*mu, *nu, *new_mu, *new_nu)] + [0, upd.data_ptr(), leaf.r, leaf.block]
    host = np.concatenate([_scalar_words(bc1, bc2, 0.0), [g.data_ptr()], _table(plan, [row])])
    buf = _upload(host, g.device)
    _launch(g.dtype, g.device, buf[3:], plan, buf.data_ptr() + 16, buf.data_ptr(), None, None, b1, b2, eps, 0.0)
    LAUNCHES.hit((leaf.o, leaf.r, leaf.block, str(g.dtype)))
    return upd, new_mu, new_nu


def _buffer_address(bc1, bc2, lr, device) -> Optional[int]:
    """The device address of the step's scalars when ``bc1``, ``bc2``, ``lr``
    are 0-d f32 tensors on ``device`` in one buffer, one after the other (the
    optimizer's ``scalars``); None when they are Python floats."""
    if not isinstance(bc1, torch.Tensor):
        return None
    ok = all(isinstance(x, torch.Tensor) and x.dtype == torch.float32 and x.numel() == 1 and x.device == device
             for x in (bc1, bc2, lr))
    if not ok or bc2.data_ptr() != bc1.data_ptr() + 4 or lr.data_ptr() != bc1.data_ptr() + 8:
        raise ValueError(f"adam8bit step: bc1, bc2 and lr must be three f32 values in a row of one buffer on {device} "
                         "(the optimizer's scalars), or Python floats")
    return bc1.data_ptr()


class Adam8bitStep:
    """The int8 Adam step over one optimizer's leaves, in place: ``params``
    (f32) and the ``mu``, ``nu`` (codes, scales) lists are held by reference.

    On CUDA tensors, one kernel launch per call over every leaf. The table of
    leaves (state and parameter pointers, ``[O, R]`` views) and work items
    (:func:`adam8bit_plan`) is built and uploaded once, when the step is made
    on CUDA parameters, and again only when a pointer of the parameters or the
    state changes. The gradients are kept out of that table: their pointers go
    to the device in one host-to-device copy when the gradient tensors change,
    out of one pinned buffer that every call reuses (the gradient list may
    hold other tensors each step; a bf16 accumulator holds the same ones,
    checked once). The step's bias corrections and learning rate are read on
    the device from the optimizer's ``scalars`` buffer (``bc1``, ``bc2``, ``lr``
    its 0-d views), or, given as Python floats, staged with the pointers. The
    global norm is read on the device. Any CUDA tensor the table does not
    describe raises; nothing falls back.

    Under CUDA graph capture (chained dispatch) the launch must be replayable:
    the host sync on the staging buffer and its copy, which a replay would
    repeat with whatever the buffer then held, are left out. The scalars must
    come from the device buffer and the table must be current (else it
    raises); the gradients' pointers, the graph's own tensors, go into a
    device buffer of their own that ``native.end_capture`` fills once the
    capture has ended and that stays as it is for the graph's life. That
    buffer is made by an eager call, outside the graph's memory pool: made
    under capture, it could share memory with a temporary of the graph's
    earlier work (its global norm), which each replay writes before the
    launch reads the pointers.

    On CPU tensors, :func:`adam8bit_step_plain`."""

    def __init__(self, params: List[torch.Tensor], mu: List[QState], nu: List[QState], block_size: int = 256):
        self.params, self.mu, self.nu = params, mu, nu
        self.block_size = block_size
        self.plan = adam8bit_plan([p.shape for p in params], block_size)
        self._table: Optional[torch.Tensor] = None
        self._param_ptrs: List[int] = []
        self._state_held: List[torch.Tensor] = []
        self._grad_refs: List[weakref.ref] = []
        self._grad_words = np.zeros(len(params), np.int64)
        self._grad_dtype: Optional[torch.dtype] = None
        self._words: Optional[torch.Tensor] = None       # on the device: two words of scalars, then the gradient pointers
        self._host_words: Optional[torch.Tensor] = None  # their pinned staging buffer
        self._copied: Optional[torch.cuda.Event] = None  # the last copy out of it
        self._graph_words: List[torch.Tensor] = []       # the gradient pointers of each captured launch
        self._spare_words: Optional[torch.Tensor] = None  # the next capture's, made outside capture
        if params and params[0].is_cuda:
            self._refresh_table()

    def _state(self):
        return [(p, *m, *n) for p, m, n in zip(self.params, self.mu, self.nu)]

    def _refresh_table(self, capturing: bool = False) -> None:
        """Build and upload the leaf table if a parameter's pointer changed or
        the state lists hold other tensors (the table holds the ones it was
        built from, so an identity test suffices; the state is only ever
        updated in place). Under capture a table that is not current raises:
        its upload would not be part of the graph."""
        state = [t for m, n in zip(self.mu, self.nu) for t in (*m, *n)]
        ptrs = [p.data_ptr() for p in self.params]
        if (ptrs == self._param_ptrs and len(state) == len(self._state_held)
                and all(a is b for a, b in zip(state, self._state_held))):
            return
        if capturing:
            raise RuntimeError("adam8bit step: a parameter or a state tensor moved since the leaf table was built; "
                               "run the step once outside CUDA graph capture first")
        device = self.params[0].device
        if device.type != "cuda":
            raise ValueError(f"adam8bit step: the parameters lie on {device}, not on a CUDA device")
        rows = []
        for i, ((p, mq, ms, nq, ns), leaf) in enumerate(zip(self._state(), self.plan.leaves)):
            _check_leaf(i, p, p.detach(), (mq, ms), (nq, ns), self.block_size, device)
            codes_and_scales = [mq.data_ptr(), ms.data_ptr(), nq.data_ptr(), ns.data_ptr()]
            rows.append(codes_and_scales * 2 + [p.data_ptr(), 0, leaf.r, leaf.block])
        self._table = _upload(_table(self.plan, rows), device)
        self._words = torch.empty(2 + len(self.params), dtype=torch.int64, device=device)
        self._host_words = torch.empty(2 + len(self.params), dtype=torch.int64, pin_memory=True)
        self._copied = None
        self._param_ptrs, self._state_held = ptrs, state
        self._grad_refs = []  # checked again against the new table

    def _check_grads(self, grads: Sequence[torch.Tensor]) -> torch.dtype:
        """Check the gradients against the table -> their dtype."""
        if len(grads) != len(self.params):
            raise ValueError(f"adam8bit step: {len(grads)} gradients for {len(self.params)} parameters")
        dtype = grads[0].dtype
        device = self.params[0].device
        for i, (g, p, m, n) in enumerate(zip(grads, self.params, self.mu, self.nu)):
            if g.dtype != dtype:
                raise TypeError(f"adam8bit step: gradients of one dtype only (leaf 0 {dtype}, leaf {i} {g.dtype})")
            _check_leaf(i, p, g, m, n, self.block_size, device)
        return dtype

    def _stage(self, scalars: Optional[np.ndarray]) -> None:
        """Copy the gradient pointers (and the float scalars, if given) to
        ``_words`` through the one pinned staging buffer, after waiting for its
        last copy (queued a step ago) so that no step allocates pinned memory."""
        if self._copied is not None:
            self._copied.synchronize()
        host = self._host_words.numpy()
        if scalars is not None:
            host[:2] = scalars
        host[2:] = self._grad_words
        device = self.params[0].device
        with torch.cuda.device(device):
            self._words.copy_(self._host_words, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()

    def _captured_words(self, grads: Sequence[torch.Tensor]) -> int:
        """Under capture: the spare device buffer for these gradients' pointers,
        filled when the capture ends -> its address."""
        words, self._spare_words = self._spare_words, None
        if words is None:
            raise RuntimeError("adam8bit step: no pointer buffer made outside CUDA graph capture; run the step "
                               "once outside capture first")
        ptrs = np.array([g.data_ptr() for g in grads], dtype=np.int64)
        self._graph_words.append(words)
        native.after_capture(lambda: words.copy_(torch.from_numpy(ptrs)))
        return words.data_ptr()

    def __call__(
        self, grads: Sequence[torch.Tensor], norm: Optional[torch.Tensor], bc1, bc2, lr,
        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
        max_grad_norm: Optional[float] = None,
    ) -> None:
        """Clip ``grads`` by ``norm`` (when ``max_grad_norm`` is set), update the
        moments and apply to the parameters, in place. ``bc1``, ``bc2``, ``lr``:
        Python floats, or the optimizer's scalars buffer as three 0-d views."""
        if not self.params:
            return
        if not grads[0].is_cuda:
            adam8bit_step_plain(self.params, grads, self.mu, self.nu, norm, bc1, bc2, lr, b1, b2, eps,
                                weight_decay, max_grad_norm, self.block_size)
            return
        capturing = torch.cuda.is_current_stream_capturing()
        self._refresh_table(capturing)
        device = self.params[0].device
        if max_grad_norm is not None and (norm.dtype != torch.float32 or norm.numel() != 1
                                          or norm.device != device):
            raise ValueError(f"adam8bit step: the global norm must be one f32 value on {device} "
                             f"(got {norm.dtype} {tuple(norm.shape)} on {norm.device})")
        scalars = _buffer_address(bc1, bc2, lr, device)
        same = len(self._grad_refs) == len(grads) and all(r() is g for r, g in zip(self._grad_refs, grads))
        dtype = self._grad_dtype if same else self._check_grads(grads)
        if capturing:
            if scalars is None:
                raise RuntimeError("adam8bit step: under CUDA graph capture the step's scalars must come from a "
                                   "device buffer (the optimizer's scalars), not Python floats")
            grad_words = self._captured_words(grads)
        else:
            if self._spare_words is None:
                self._spare_words = torch.empty(len(self.params), dtype=torch.int64, device=device)
            if not same:
                self._grad_words = np.array([g.data_ptr() for g in grads], dtype=np.int64)
                self._grad_refs = [weakref.ref(g) for g in grads]
                self._grad_dtype = dtype
            if scalars is None:
                self._stage(_scalar_words(bc1, bc2, lr))
                scalars = self._words.data_ptr()
            elif not same:
                self._stage(None)
            grad_words = self._words.data_ptr() + 16
        _launch(dtype, device, self._table, self.plan, grad_words, scalars, norm, max_grad_norm, b1, b2, eps,
                weight_decay)
        LAUNCHES.hit(("step", len(self.params), len(self.plan.items), str(dtype)))
