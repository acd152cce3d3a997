"""The memory-lean optimizers of the port against the JAX package, on the CPU (f32 math).

- K9's plain version (``ops/adam8bit_update.py``) against the JAX package's
  Pallas kernel in interpret mode and its XLA leaf path, at the JAX test's
  shapes moved to the torch layout (the minor axis first): updates at rtol
  1e-6 / atol 1e-7, codes equal, dequantized moments at rtol 1e-5 / atol 1e-8
  (``tests/test_adam8bit.py``'s bar). Quantize and dequantize on zeros and odd
  shapes, codes and scales equal.
- ``AdamW8bit`` against ``fused_accumulate(as_fused_apply(chain(
  clip_by_global_norm, adamw_8bit(block_size=16))), 2, acc_dtype)`` for an f32
  and a bf16 accumulator, on a tiny UNet's leaves (its input conv, time
  MLP, first bottleneck ResBlock and transformer, so that the jitted chain
  compiles quickly; blocks of 16, so both sub-blocked and one-block leaves
  occur), from a non-zero JAX state carried across by
  ``utils/convert.py:unet_optimizer_state`` mid-window, for 3 optimizer
  steps with the same gradients: parameters at rtol 1e-6 / atol
  1e-7 (a 1-ulp difference in the f32 bias corrections or learning rate moves
  a parameter by about 1e-9); dequantized moments at the bar above; the
  accumulators equal. The chains run jitted, and XLA on the CPU contracts
  multiply-adds into FMAs there, so a value within one f32 ulp of a rounding
  boundary of an int8 code or of the bf16 update may round the other way: at
  most ``FLIPS`` such elements in the tree, each one code apart and moving
  its parameter by at most ``FLIP_ATOL`` (one bf16 ulp of an update times the
  learning rate, with room); and at most ``MOMENT_OFF`` dequantized moments
  outside the bar, each within one code step of its leaf's largest scale (a
  flipped code at a block's absmax rescales that block).
- ``AdamW`` with bf16 moments (and a bf16 or f32 accumulator) against
  ``fused_accumulate(fused_adamw(mu_dtype, nu_dtype), 2, acc_dtype)`` over 3
  optimizer steps, run eagerly on the JAX side (op by op, no FMAs) on a small
  tree: parameters at rtol 1e-6 / atol 1e-7, bf16 moments and accumulator
  equal.
- The layout rule: for every parameter, the converter puts JAX's minor axis
  on torch dim 0 (``BLOCK_DIM``), and JAX's codes and scales, converted, equal
  the port's quantization of the converted values.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from stable_diffusion_pytorch_tpu.models import unet as jax_unet  # noqa: E402
from stable_diffusion_pytorch_tpu.ops import adam8bit_update as jax_kern  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import adam8bit as jax_a8  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import fused_adamw as jax_fused  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import optim as jax_optim  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.config import UnetConfig  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.ops import adam8bit_update as k9  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers import optim as port_optim  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.adam8bit import AdamW8bit  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import convert  # noqa: E402

torch.set_num_threads(2)

# one level, attention in the bottleneck only: every kind of UNet leaf
# (ResBlocks, 1x1 skip, a transformer) with few leaves, so the JAX chains
# trace and compile quickly
UNET_KW = dict(num_res_blocks=1, n_heads=2, attention_resolutions=[], channels_list=[16],
               time_emb_dim=32, dropout=0.0, n_layers=1, context_dim=16)
BLOCK = 16
# the clip is active (norms about 8) with an f32 accumulator. With a bf16
# accumulator it is not: there the JAX package sums the norm in bf16 in its
# tree order (trainers/optim.py:global_norm), which the port does not copy
MAX_NORM = {"int8_f32_acc": 0.5, "int8_bf16_acc": 1e3, "bf16_moments_f32_acc": 0.5, "bf16_moments_bf16_acc": 1e3}
LR = dict(kind="linear", lr=1e-2, warmup=1, total=10)
DEQ = dict(rtol=1e-5, atol=1e-8)
FLIPS = 10
FLIP_ATOL = 1e-4
MOMENT_OFF = 64  # a flip at a block's absmax rescales its whole block (16 values) a step later
CODE_STEP = 2 / 127  # the quadratic code's widest spacing, relative to the scale


def _minor_first(x):
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 0))


def _scale_minor_first(scale, shape):
    """A JAX scale ([..., nb, 1] or [..., 1]) in the torch layout [nb, ...]."""
    scale = np.asarray(scale)
    lead = tuple(shape[:-1])
    return _minor_first(scale.reshape(lead + (scale.size // max(int(np.prod(lead)), 1),)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _xla_leaf(g, mu_q, nu_q, bc1, bc2, block, b1=0.9, b2=0.999, eps=1e-8):
    """The JAX package's XLA leaf path (``scale_by_adam_8bit.leaf_update``)."""
    g32 = g.astype(jnp.float32)
    mu = b1 * jax_a8._dequantize(mu_q, g.shape) + (1.0 - b1) * g32
    nu = b2 * jax_a8._dequantize(nu_q, g.shape) ** 2 + (1.0 - b2) * g32 * g32
    upd = (mu / bc1) / (jnp.sqrt(nu / bc2) + eps)
    return upd.astype(g.dtype), jax_a8._quantize(mu, block), jax_a8._quantize(jnp.sqrt(nu), block)


@pytest.mark.parametrize("shape", [(64, 512), (4, 64, 320), (1024, 512)])
def test_k9_plain_matches_the_pallas_kernel_and_the_xla_path(shape):
    # the JAX test's inputs (tests/test_adam8bit.py::test_fused_kernel_matches_xla_leaf)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    g = jax.random.normal(k1, shape, jnp.float32) * 0.02
    mu_q = jax_a8._quantize(jax.random.normal(k2, shape, jnp.float32) * 0.01, 256)
    nu_q = jax_a8._quantize(jnp.sqrt(jnp.abs(jax.random.normal(k3, shape, jnp.float32)) * 1e-4), 256)
    bc1, bc2 = jnp.float32(1.0 - 0.9 ** 3), jnp.float32(1.0 - 0.999 ** 3)
    refs = {
        "xla": _xla_leaf(g, mu_q, nu_q, bc1, bc2, 256),
        "pallas": (lambda u, mq, ms, nq, ns: (u, jax_a8._QTensor(mq, ms), jax_a8._QTensor(nq, ns)))(
            *jax_kern.fused_adam8bit_update(g, mu_q.q, mu_q.scale, nu_q.q, nu_q.scale, bc1, bc2, b1=0.9, b2=0.999,
                                            eps=1e-8, block_size=256, interpret=True)),
    }
    port_q = lambda qt: (_t(_minor_first(qt.q)), _t(_scale_minor_first(qt.scale, shape)))  # noqa: E731
    upd, mu, nu = k9.adam8bit_update(_t(_minor_first(g)), port_q(mu_q), port_q(nu_q), float(bc1), float(bc2),
                                     block_size=256)
    assert mu[1].shape == nu[1].shape == k9.scale_shape(upd.shape, 256)
    for name, (r_upd, r_mu, r_nu) in refs.items():
        np.testing.assert_allclose(upd.numpy(), _minor_first(r_upd), rtol=1e-6, atol=1e-7, err_msg=name)
        for ours, ref in ((mu, r_mu), (nu, r_nu)):
            np.testing.assert_array_equal(ours[0].numpy(), _minor_first(ref.q), err_msg=name)
            np.testing.assert_allclose(k9.dequantize(*ours).numpy(),
                                       _minor_first(jax_a8._dequantize(ref, shape)), **DEQ, err_msg=name)


@pytest.mark.parametrize("shape,zeros", [((7, 13), False), ((3, 5, 2), False), ((512, 3), False), ((1024,), False),
                                         ((300, 2, 3, 3), False), ((7, 13), True), ((512, 3), True)])
def test_quantize_and_dequantize_match_jax(shape, zeros):
    rng = np.random.default_rng(len(shape))
    x = np.zeros(shape, np.float32) if zeros else rng.standard_normal(shape).astype(np.float32)
    jx = np.moveaxis(x, 0, -1)  # the JAX layout: dim 0 becomes the minor axis
    ref = jax_a8._quantize(jnp.asarray(jx), 256)
    q, s = k9.quantize(_t(x), 256)
    jshape = jx.shape
    np.testing.assert_array_equal(q.numpy(), _minor_first(ref.q))
    np.testing.assert_array_equal(s.numpy(), _scale_minor_first(ref.scale, jshape))
    np.testing.assert_array_equal(k9.dequantize(q, s).numpy(), _minor_first(jax_a8._dequantize(ref, jshape)))
    if zeros:
        assert not k9.dequantize(q, s).any()


# --------------------------------------------------------------------------- #
# the optimizers, over a tiny UNet's leaves
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def tiny_unet():
    cfg = jax_unet.UnetConfig(**UNET_KW)
    model = jax_unet.UNetModel.from_config(4, 4, cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, 77, 16)))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32), shapes)
    names = [n for n, _ in UNetModel(4, 4, UnetConfig(**UNET_KW)).named_parameters()]
    return cfg, params, names


# the optimizer tests' leaves: JAX top-level keys and the port's names for them
SUBSET = ("conv_in", "time_fc1", "time_fc2", "mid_res1", "mid_attn")
SUBSET_PORT = ("conv_in.", "time_embedding.", "middle_block.0.", "middle_block.1.")


def _subset(tree):
    return {"params": {k: tree["params"][k] for k in SUBSET}}


def _whole(sub, filler):
    """``sub`` (a subset tree) inside a whole UNet tree, ``filler`` elsewhere,
    so that the converter's map applies; only the subset's names are read."""
    return {"params": {**filler["params"], **sub["params"]}}


def _grads(seed):
    _, params, _ = tiny_unet()
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda p: (rng.standard_normal(p.shape) * 0.05).astype(np.float32),
                                  _subset(params))


def _to_port_list(tree, cfg, names):
    sd = convert.unet_state_dict(tree, cfg)
    return [_t(np.asarray(sd[n], np.float32)) for n in names]


def _jax_tx(kind):
    sched = jax_optim.build_lr_schedule(LR["kind"], LR["lr"], LR["warmup"], LR["total"])
    if kind.startswith("bf16_moments"):
        inner = jax_fused.fused_adamw(sched, weight_decay=0.1, max_grad_norm=MAX_NORM[kind], mu_dtype="bfloat16",
                                      nu_dtype="bfloat16")
        return jax_fused.fused_accumulate(inner, 2, acc_dtype=jnp.bfloat16 if kind.endswith("bf16_acc") else None)
    chain = optax.chain(optax.clip_by_global_norm(MAX_NORM[kind]),
                        jax_a8.adamw_8bit(sched, weight_decay=0.1, block_size=BLOCK))
    return jax_fused.fused_accumulate(jax_fused.as_fused_apply(chain), 2,
                                      acc_dtype=jnp.bfloat16 if kind == "int8_bf16_acc" else None)


def _port_opt(kind, params):
    sched = port_optim.build_lr_schedule(LR["kind"], LR["lr"], LR["warmup"], LR["total"])
    kw = dict(weight_decay=0.1, max_grad_norm=MAX_NORM[kind], accum_steps=2)
    acc = torch.bfloat16 if kind.endswith("bf16_acc") else torch.float32
    if kind.startswith("bf16_moments"):
        return port_optim.AdamW(params, sched, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16, acc_dtype=acc, **kw)
    return AdamW8bit(params, sched, block_size=BLOCK, acc_dtype=acc, **kw)


def _torch_state(state):
    """The converter's numpy state -> tensors (bf16 arrays through f32, exactly)."""
    def conv(a):
        a = np.asarray(a)
        return _t(a if a.dtype in (np.int8, np.float32) else a.astype(np.float32))

    return {k: ([conv(a) for a in v] if isinstance(v, list) else v) for k, v in state.items()}


def _off(got, want, rtol, atol):
    """Elements of ``got`` outside rtol/atol of ``want``."""
    return (got - want).abs() > atol + rtol * want.abs()


def _carried(state, params, cfg, names):
    """The converter on the subset's 8-bit chain state, inside whole trees."""
    adam = state.inner[1][0]
    zeros = jax.device_get(jax_a8.scale_by_adam_8bit(block_size=BLOCK).init(params))
    whole = jax_a8.ScaleByAdam8bitState(count=adam.count, mu=_whole(adam.mu, zeros.mu), nu=_whole(adam.nu, zeros.nu))
    fused = jax_fused.FusedAccumState(mini_step=state.mini_step, acc=_whole(state.acc, params), inner=whole)
    return convert.unet_optimizer_state(fused, params, cfg, names)


@pytest.mark.parametrize("kind", ["int8_f32_acc", "int8_bf16_acc"])
def test_adamw8bit_matches_the_jax_chain_from_a_carried_state(kind):
    cfg, params, all_names = tiny_unet()
    names = [n for n in all_names if n.startswith(SUBSET_PORT)]
    tx = _jax_tx(kind)
    apply = jax.jit(tx.apply)
    jp = jax.tree_util.tree_map(jnp.asarray, _subset(params))
    state = tx.init(jp)
    for i in range(5):  # 2 optimizer steps and half a window: count 2, mini_step 1
        jp, state = apply(_grads(100 + i), state, jp)

    port_list = lambda tree: _to_port_list(_whole(jax.device_get(tree), params), cfg, names)  # noqa: E731
    ours = port_list(jp)
    opt = _port_opt(kind, ours)
    carried = _carried(jax.device_get(state), params, cfg, names)
    assert carried["mini_step"] == 1 and carried["count"] == 2 and carried["layout"] == opt.layout()
    assert {s.shape[0] > 1 for s in carried["mu_scale"]} == {True, False}  # sub-blocked and one-block leaves
    opt.load_state_dict(_torch_state(carried))

    for i in range(6):  # 3 optimizer steps
        g = _grads(200 + i)
        jp, state = apply(g, state, jp)
        applied, _ = opt.step(port_list(g))
        assert applied == (i % 2 == 0)
    assert opt.count == 5

    flips = 0
    for name, got, ref in zip(names, ours, port_list(jp)):
        flips += int(_off(got, ref, 1e-6, 1e-7).sum())
        assert (got - ref).abs().max() <= FLIP_ATOL, name
    want = _torch_state(_carried(jax.device_get(state), params, cfg, names))
    for a, ref in zip(opt.acc, want["acc"]):
        assert torch.equal(a.float(), ref)
    moment_off = 0
    for m, moments in (("mu", opt.mu), ("nu", opt.nu)):
        for name, (q, s), rq, rs in zip(names, moments, want[f"{m}_q"], want[f"{m}_scale"]):
            flips += int((q != rq).sum())
            assert (q.int() - rq.int()).abs().max() <= 1, (m, name)
            got, ref = k9.dequantize(q, s), k9.dequantize(rq, rs)
            moment_off += int(_off(got, ref, **DEQ).sum())
            assert (got - ref).abs().max() <= CODE_STEP * rs.abs().max(), (m, name)
    assert flips <= FLIPS and moment_off <= MOMENT_OFF, (flips, moment_off)


@pytest.mark.parametrize("kind", ["bf16_moments_f32_acc", "bf16_moments_bf16_acc"])
def test_bf16_storage_matches_fused_adamw(kind):
    rng = np.random.default_rng(3)
    shapes = {"a": (40, 24), "b": (64,), "c": (3, 3, 8, 16)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 0.2).astype(np.float32) for k, s in shapes.items()} for _ in range(6)]
    tx = _jax_tx(kind)
    ours = [_t(params[k].copy()) for k in shapes]
    opt = _port_opt(kind, ours)
    with jax.disable_jit():
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        state = tx.init(jp)
        for g in grads:
            jp, state = tx.apply({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
            opt.step([_t(g[k]) for k in shapes])
    assert opt.count == 3
    for k, got in zip(shapes, ours):
        np.testing.assert_allclose(got.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    for name, mine in (("mu", opt.mu), ("nu", opt.nu)):
        for k, m in zip(shapes, mine):
            assert m.dtype == torch.bfloat16
            np.testing.assert_array_equal(m.float().numpy(), np.asarray(getattr(state.inner, name)[k], np.float32))
    for k, a in zip(shapes, opt.acc):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(state.acc[k], np.float32))


def test_layout_rule_blocks_along_the_converters_jax_minor_axis():
    cfg, params, names = tiny_unet()
    # each JAX leaf labelled by its index along the minor axis
    labelled = jax.tree_util.tree_map(
        lambda p: np.broadcast_to(np.arange(p.shape[-1], dtype=np.float32), p.shape), params)
    sd = convert.unet_state_dict(labelled, cfg)
    for name in names:
        t = sd[name]
        varying = [d for d in range(t.ndim) if np.ptp(t, axis=d).max() > 0]
        assert varying in ([k9.BLOCK_DIM], []), (name, t.shape, varying)
        if t.shape[0] > 1:
            assert varying == [k9.BLOCK_DIM]

    rng = np.random.default_rng(7)
    values = jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    quantized = jax.jit(lambda tree: jax.tree_util.tree_map(lambda v: jax_a8._quantize(v, BLOCK), tree))(values)
    state = jax_a8.ScaleByAdam8bitState(count=np.int32(0), mu=jax.device_get(quantized),
                                        nu=jax.device_get(quantized))
    carried = convert.unet_optimizer_state(state, params, cfg, names)
    port_values = convert.unet_state_dict(values, cfg)
    fused = jax_fused.fused_accumulate(jax_fused.fused_adamw(1e-3, mu_dtype="bfloat16"), 2).init(params)
    as_adamw = convert.unet_optimizer_state(jax.device_get(fused), params, cfg, names)
    assert as_adamw["layout"] == port_optim.AdamW([_t(port_values[n]) for n in names], None,
                                                  mu_dtype=torch.bfloat16, accum_steps=2).layout()
    assert [m.shape for m in as_adamw["mu"]] == [port_values[n].shape for n in names]
    sub_blocked = 0
    for name, q, s in zip(names, carried["mu_q"], carried["mu_scale"]):
        ours_q, ours_s = k9.quantize(_t(port_values[name]), BLOCK)
        assert s.shape == k9.scale_shape(ours_q.shape, BLOCK) == tuple(ours_s.shape), name
        np.testing.assert_array_equal(ours_q.numpy(), q, err_msg=name)
        np.testing.assert_array_equal(ours_s.numpy(), s, err_msg=name)
        sub_blocked += s.shape[0] > 1
    assert 0 < sub_blocked < len(names)  # both kinds of leaf occur
