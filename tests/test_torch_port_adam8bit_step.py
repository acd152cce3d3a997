"""The int8 Adam step of the port (K9 with the clip and the apply fused in;
``ops/adam8bit_update.py``, ``csrc/adam8bit_update.cu``) on the CPU, f32 math.

- The work plan (``adam8bit_plan``) over the SD-1.5 UNet's 686 leaves, taken
  from a UNet built on the ``meta`` device: every element lies in exactly one
  work item and is walked by exactly one thread, each quantization block is
  owned by one item, every 1-D leaf takes the row mapping, every leaf one
  pass within 64 KB of shared memory; the same over the SD-1.5 VAE's 240.
- ``adam8bit_step_plain`` against the per-leaf loop ``AdamW8bit._update`` ran
  before the step was fused (clip, one-leaf update, apply, the state
  replaced), f32 and bf16 gradients, the clip active and not: parameters,
  codes and scales equal bit for bit. (``tests/test_torch_port_lean_optim.py``
  holds ``AdamW8bit`` on this path against the JAX chain.)
- A model of the kernel's work decomposition: it walks the plan item by
  item in the kernel's order, updating parameters, codes and scales in place
  (the parameter in the first pass, codes and scales after the absmax; a
  recomputing item reads the codes again before it writes them), each
  column's absmax taken per thread over its rows and then across the row
  lanes. It must give the plain version's bits, on plans that take both
  mappings and both passes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stable_diffusion_pytorch_tpu_torch.models import presets  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.autoencoder import AutoEncoderKL  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.ops import adam8bit_update as k9  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.adam8bit import AdamW8bit  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.optim import build_lr_schedule, global_norm  # noqa: E402

torch.set_num_threads(2)
B1, B2, EPS, WD = 0.9, 0.999, 1e-8, 0.1
BC1, BC2 = (float(torch.tensor(1.0) - torch.tensor(b) ** torch.tensor(3.0)) for b in (B1, B2))  # step 3
LR = float(np.float32(1e-3))
# small leaves that take every kind of item at blocks of 16 and items of 256
# elements: sub-blocked 1-D (48,), one tall 1-D block (200,) in one pass, a
# narrow 2-D leaf on the row mapping (48, 5), column runs of 16 and 8 with
# partial last runs (64, 40) and (24, 33), a block too tall to hold (100, 64),
# and a channels_last conv whose 27 columns (40 rows) recompute
SMALL = [(48,), (200,), (48, 5), (64, 40), (24, 33), (100, 64), (40, 3, 3, 3)]
SMALL_BLOCK, SMALL_ITEM = 16, 256


def _sd15_shapes():
    with torch.device("meta"):
        unet = UNetModel(4, 4, presets.sd15_unet_config())
    return [tuple(p.shape) for p in unet.parameters()]


def _coverage(plan, leaf_index):
    """How often each (block j, column) of a leaf lies in an item."""
    leaf = plan.leaves[leaf_index]
    items = plan.items[leaf.first_item:leaf.first_item + leaf.n_items]
    assert (items[:, 0] == leaf_index).all()
    diff = np.zeros((leaf.nb, leaf.r + 1), np.int64)
    width = items[:, 3] & k9.COLS
    np.add.at(diff, (items[:, 1], items[:, 2]), 1)
    np.add.at(diff, (items[:, 1], items[:, 2] + width), -1)
    return np.cumsum(diff, axis=1)[:, :-1]


def _thread_rows(block, cols):
    """The rows each column of an item is walked at, by the kernel's thread
    rule (thread t: column t % cols, rows t // cols, + THREADS // cols, ...)."""
    lanes = k9.THREADS // cols
    seen = {c: [] for c in range(cols)}
    for t in range(lanes * cols):
        seen[t % cols] += list(range(t // cols, block, lanes))
    return seen


def test_plan_covers_the_sd15_leaves_once():
    shapes = _sd15_shapes()
    plan = k9.adam8bit_plan(shapes, 256)
    assert len(shapes) == len(plan.leaves) == 686
    assert sum(int(np.prod(s)) for s in shapes) == 859_520_964
    kinds = set()
    for i, (shape, leaf) in enumerate(zip(shapes, plan.leaves)):
        assert (leaf.o, leaf.r, leaf.block, leaf.nb) == k9.blocked_layout(shape, 256)
        assert (_coverage(plan, i) == 1).all(), shape  # each quantization block in one item, once
        assert leaf.one_pass and leaf.block * leaf.cols <= plan.smem_elems, shape
        if len(shape) == 1:
            assert leaf.mapping == "row" and leaf.cols == 1, shape
        else:
            assert leaf.mapping == "column" and leaf.r >= 32 and k9.MIN_COLS <= leaf.cols <= k9.THREADS, shape
        kinds.add((leaf.block, leaf.cols))
    assert plan.smem_elems == 256 * 32 and 2 * 4 * plan.smem_elems <= 64 * 1024
    assert not (plan.items[:, 3] & k9.RECOMPUTE).any()
    assert {cols for block, cols in kinds if block == 256} == {1, 32}  # 1-D and column runs of 256-row blocks
    assert {(b, c) for b, c in kinds if b in (320, 640) and c > 1} == {(320, 16), (640, 8)}
    assert (4, k9.THREADS) in kinds  # the 4-row output conv: a column per thread
    for block, cols in kinds:  # every row of every column walked by exactly one thread
        for rows in _thread_rows(block, cols).values():
            assert sorted(rows) == list(range(block)), (block, cols)


def test_plan_covers_the_sd15_vae_leaves_once():
    """``--use-8bit-adam`` in the autoencoder trainer: the plan over the
    SD-1.5 VAE's 240 leaves (its 3- and 8-row output convs, the 1x1 quant
    convs, 128- and 256-row blocks) covers each quantization block once in
    one pass, and every column-mapped item's rows are walked once."""
    with torch.device("meta"):
        vae = AutoEncoderKL(presets.sd15_autoencoder_config())
    shapes = [tuple(p.shape) for p in vae.parameters()]
    plan = k9.adam8bit_plan(shapes, 256)
    assert len(shapes) == len(plan.leaves) == 240
    assert sum(int(np.prod(s)) for s in shapes) == 72_094_951
    for i, (shape, leaf) in enumerate(zip(shapes, plan.leaves)):
        assert (leaf.o, leaf.r, leaf.block, leaf.nb) == k9.blocked_layout(shape, 256)
        assert (_coverage(plan, i) == 1).all(), shape
        assert leaf.one_pass and leaf.block * leaf.cols <= plan.smem_elems, shape
        if len(shape) == 1:
            assert leaf.mapping == "row" and leaf.cols == 1, shape
        if leaf.mapping == "column":
            for rows in _thread_rows(leaf.block, leaf.cols).values():
                assert sorted(rows) == list(range(leaf.block)), shape
    assert not (plan.items[:, 3] & k9.RECOMPUTE).any()


def test_plan_recomputes_blocks_too_tall_to_hold():
    plan = k9.adam8bit_plan(SMALL, SMALL_BLOCK, SMALL_ITEM)
    got = {s: (leaf.mapping, leaf.cols, leaf.one_pass) for s, leaf in zip(SMALL, plan.leaves)}
    assert got == {(48,): ("row", 1, True), (200,): ("row", 1, True), (48, 5): ("row", 5, True),
                   (64, 40): ("column", 16, True), (24, 33): ("column", 8, True),
                   (100, 64): ("column", 32, False), (40, 3, 3, 3): ("row", 27, False)}
    assert plan.smem_elems == 16 * 16
    for i, leaf in enumerate(plan.leaves):
        assert (_coverage(plan, i) == 1).all()
        flags = plan.items[leaf.first_item:leaf.first_item + leaf.n_items, 3] & k9.RECOMPUTE
        assert (flags != 0).all() == (not leaf.one_pass) and (flags != 0).any() == (not leaf.one_pass)
    # the SD-1.5 rule at full size: a block taller than 8192 rows, or than
    # 1024 with 32 columns or more, recomputes
    big = k9.adam8bit_plan([(9000,), (2000, 64), (1000, 64)], 256)
    assert [(leaf.cols, leaf.one_pass) for leaf in big.leaves] == [(1, False), (32, False), (8, True)]


def _layout(shape):
    return torch.channels_last if len(shape) == 4 else torch.contiguous_format


def _leaves(shapes, block_size, dtype, seed=0, grad_scale=0.05):
    """Seeded f32 parameters, non-zero int8 state, gradients in ``dtype``,
    each in its leaf's memory format."""
    rng = np.random.default_rng(seed)

    def tensor(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).contiguous(
            memory_format=_layout(shape))

    params = [tensor(s, 0.3) for s in shapes]
    grads = [tensor(s, grad_scale).to(dtype).contiguous(memory_format=_layout(s)) for s in shapes]
    mu, nu = [], []
    for s in shapes:
        for store, x in ((mu, tensor(s, 0.01)), (nu, tensor(s, 1e-4).abs().sqrt())):
            q, sc = k9.quantize(x, block_size)
            store.append((q.contiguous(memory_format=_layout(s)), sc.contiguous(memory_format=_layout(s))))
    return params, grads, mu, nu


def _clone(params, mu, nu):
    return ([p.clone() for p in params], [tuple(t.clone() for t in m) for m in mu],
            [tuple(t.clone() for t in n) for n in nu])


def _per_leaf_loop(params, grads, mu, nu, norm, max_norm, block_size):
    """``AdamW8bit._update`` as it ran per leaf before the step was fused."""
    if max_norm is not None:
        c = torch.tensor(max_norm, dtype=torch.float32, device=norm.device)
        keep = norm < c
    for i, (p, g) in enumerate(zip(params, grads)):
        if max_norm is not None:
            g = torch.where(keep, g, (g / norm.to(g.dtype)) * c.to(g.dtype))
        upd, mu[i], nu[i] = k9.adam8bit_update(g, mu[i], nu[i], BC1, BC2, B1, B2, EPS, block_size)
        t = p * WD
        t.add_(upd)
        t.mul_(-LR)
        p.add_(t)


def _assert_same(a, b):
    (pa, ma, na), (pb, mb, nb) = a, b
    for x, y in zip(pa, pb):
        assert torch.equal(x, y)
    for x, y in zip(ma + na, mb + nb):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])


def _max_norm(norm, clip):
    """A limit below the norm (the clip acts) or above it (it keeps g)."""
    return float(norm) * (0.5 if clip else 2.0)


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_plain_matches_the_per_leaf_loop(dtype, clip):
    params, grads, mu, nu = _leaves(SMALL, SMALL_BLOCK, dtype)
    norm = global_norm(grads)
    max_norm = _max_norm(norm, clip)
    old = _clone(params, mu, nu)
    _per_leaf_loop(*old[:1], grads, *old[1:], norm, max_norm, SMALL_BLOCK)
    new = _clone(params, mu, nu)
    state_ids = [id(t) for m in new[1] + new[2] for t in m]
    k9.adam8bit_step_plain(new[0], grads, new[1], new[2], norm, BC1, BC2, LR, B1, B2, EPS, WD, max_norm,
                           SMALL_BLOCK)
    assert [id(t) for m in new[1] + new[2] for t in m] == state_ids  # in place
    _assert_same(new, old)
    assert not torch.equal(new[0][0], params[0]) and not torch.equal(new[1][3][0], mu[3][0])


def _rows_view(t):
    """The [O, R] view of a leaf's tensor in memory order (a view, not a copy)."""
    if t.dim() == 4 and not t.is_contiguous():
        return t.permute(0, 2, 3, 1).view(t.shape[0], -1)
    return t.view(t.shape[0], -1)


def _dequant(q, scale):
    qf = q.float() * (1.0 / 127.0)
    return torch.sign(qf) * qf * qf * scale


def _quant(x, absmax):
    safe = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    y = x / safe
    return torch.clamp(torch.round(127.0 * torch.sign(y) * torch.sqrt(torch.abs(y))), -127, 127).to(torch.int8)


def _lane_max(x, lanes):
    """Each column's max |x|: per thread over its rows, then across the row lanes."""
    return torch.stack([x[r::lanes].abs().amax(0) for r in range(min(lanes, x.shape[0]))]).amax(0, keepdim=True)


def _model_step(plan, params, grads, mu, nu, norm, max_norm):
    """The kernel's work decomposition on the CPU, in place (see the module doc)."""
    owned = set()
    c = torch.tensor(max_norm if max_norm is not None else 0.0, dtype=torch.float32)
    keep = norm < c if max_norm is not None else None
    bc1, bc2 = torch.tensor(BC1, dtype=torch.float32), torch.tensor(BC2, dtype=torch.float32)
    for leaf_i, j, c0, word in plan.items.tolist():
        leaf = plan.leaves[leaf_i]
        width, recompute = word & k9.COLS, bool(word & k9.RECOMPUTE)
        rows, cols = slice(j * leaf.block, (j + 1) * leaf.block), slice(c0, c0 + width)
        p, g = (_rows_view(t)[rows, cols] for t in (params[leaf_i], grads[leaf_i]))
        (mq, ms), (nq, ns) = (((_rows_view(q)[rows, cols], _rows_view(s)[j:j + 1, cols]) for q, s in
                               (mu[leaf_i], nu[leaf_i])))
        for col in range(c0, c0 + width):
            assert (leaf_i, j, col) not in owned
            owned.add((leaf_i, j, col))

        def moments():  # from the gradient and the codes as they lie now
            gc = g if keep is None else torch.where(keep, g, (g / norm.to(g.dtype)) * c.to(g.dtype))
            g32 = gc.float()
            m = B1 * _dequant(mq, ms) + (1.0 - B1) * g32
            v = B2 * _dequant(nq, ns) ** 2 + (1.0 - B2) * g32 * g32
            return m, v

        m, v = moments()  # pass 1: the update and the apply, the parameter written
        upd = ((m / bc1) / (torch.sqrt(v / bc2) + EPS)).to(g.dtype)
        t = p * WD
        t.add_(upd)
        t.mul_(-LR)
        p.add_(t)
        lanes = k9.THREADS // width
        amax_m, amax_n = _lane_max(m, lanes), _lane_max(torch.sqrt(v), lanes)
        if recompute:  # pass 2 recomputes from the unchanged gradient and codes
            m, v = moments()
        mq.copy_(_quant(m, amax_m))
        nq.copy_(_quant(torch.sqrt(v), amax_n))
        ms.copy_(amax_m)
        ns.copy_(amax_n)
    want = {(i, j, col) for i, leaf in enumerate(plan.leaves) for j in range(leaf.nb) for col in range(leaf.r)}
    assert owned == want


@pytest.mark.parametrize("item_elems", [SMALL_ITEM, k9.ITEM_ELEMS])
@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_model_gives_the_plain_bits(dtype, clip, item_elems):
    params, grads, mu, nu = _leaves(SMALL, SMALL_BLOCK, dtype, seed=1)
    norm = global_norm(grads)
    max_norm = _max_norm(norm, clip)
    plan = k9.adam8bit_plan(SMALL, SMALL_BLOCK, item_elems)
    assert any(not leaf.one_pass for leaf in plan.leaves) == (item_elems == SMALL_ITEM)
    plain = _clone(params, mu, nu)
    k9.adam8bit_step_plain(plain[0], grads, plain[1], plain[2], norm, BC1, BC2, LR, B1, B2, EPS, WD, max_norm,
                           SMALL_BLOCK)
    model = _clone(params, mu, nu)
    _model_step(plan, *model[:1], grads, *model[1:], norm, max_norm)
    _assert_same(model, plain)


def test_adamw8bit_updates_its_state_in_place_on_the_cpu():
    shapes = [(32, 3, 3, 3), (32,), (300, 20)]
    params, grads, _, _ = _leaves(shapes, 16, torch.float32, seed=2)
    opt = AdamW8bit(params, build_lr_schedule("constant", 1e-3, 0, 10), block_size=16, weight_decay=WD,
                    max_grad_norm=1.0)
    state = [t for qs in opt.mu + opt.nu for t in qs]
    before = [t.clone() for t in state]
    ref = _clone(params, opt.mu, opt.nu)
    for _ in range(2):
        applied, norm = opt.step(grads)
        assert applied
        k9.adam8bit_step_plain(ref[0], [g.float() for g in grads], ref[1], ref[2], norm, *_bias(opt.count - 1),
                               float(np.float32(1e-3)), B1, B2, EPS, WD, 1.0, 16)
    assert [t for qs in opt.mu + opt.nu for t in qs] == state  # the same tensors
    assert all(not torch.equal(a, b) for a, b in zip(state, before))
    assert all(t.is_contiguous(memory_format=_layout(s)) for s, (q, sc) in zip(shapes, opt.mu) for t in (q, sc))
    _assert_same((params, opt.mu, opt.nu), ref)


def _bias(count):
    """The bias corrections of the update at optimizer step ``count`` (0-based)."""
    c = torch.tensor(float(count + 1))
    return tuple(float(torch.tensor(1.0) - torch.tensor(b) ** c) for b in (B1, B2))
