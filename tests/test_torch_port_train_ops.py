"""The backward kernels' plain versions and the port's autograd Functions, f32 on the CPU.

- K3: ``flash_attention_bwd_plain`` against the JAX package's Pallas
  ``flash_attention_bwd_fused`` in interpret mode and its ``xla_attention_bwd``,
  ragged kv (77) and d_head 40 included. Tolerance 2e-5 absolute (+1e-5
  relative) on O(1) gradients: f32 sums over at most 96 kv rows in another
  order.
- K7: ``group_norm_bwd_plain`` against ``pallas_group_norm_bwd`` (C % 128 == 0,
  S % 8 == 0, as that function requires), with and without SiLU. 5e-5: two f32
  reductions over the map, var = E[x^2] - E[x]^2 on both sides.
- The K8 backward (two parts, joint statistics) against ``jax.vjp`` of
  ``xla_group_norm_cat`` with a group straddling the part boundary; 5e-5.
- The Functions on the CPU (plain forward and plain backward) against
  ``torch.autograd`` through the plain forwards; 2e-5.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu.ops import fused_groupnorm as jax_fgn  # noqa: E402
from stable_diffusion_pytorch_tpu.ops import groupnorm as jax_gn  # noqa: E402
from stable_diffusion_pytorch_tpu.ops.flash_attention import xla_attention_bwd  # noqa: E402
from stable_diffusion_pytorch_tpu.ops.flash_attention_bwd import flash_attention_bwd_fused  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.ops import native  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import (  # noqa: E402
    fused_group_norm,
    fused_group_norm_cat,
    group_norm_bwd_plain,
)
from stable_diffusion_pytorch_tpu_torch.ops.groupnorm import xla_group_norm, xla_group_norm_cat  # noqa: E402

torch.set_num_threads(2)
ATTN_TOL = dict(rtol=1e-5, atol=2e-5)
GN_TOL = dict(rtol=1e-5, atol=5e-5)


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize(
    "b,n,m,h,d",
    [(2, 64, 64, 2, 40), (1, 48, 77, 2, 80), (1, 40, 77, 1, 40)],
    ids=["self_d40", "cross_m77_d80", "cross_m77_d40"],
)
def test_attention_bwd_plain_matches_pallas_interpret_and_xla(b, n, m, h, d):
    q, k, v, do = _rand(0, (b, n, h, d), (b, m, h, d), (b, m, h, d), (b, n, h, d))
    scale = d ** -0.5
    jargs = [jnp.asarray(a) for a in (q, k, v, do)]
    pallas = jax.jit(lambda *a: flash_attention_bwd_fused(*a, scale, interpret=True))(*jargs)
    xla = jax.jit(lambda *a: xla_attention_bwd(*a, scale))(*jargs)
    ours = flash_attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, do)), scale)
    for got, p_ref, x_ref in zip(ours, pallas, xla):
        np.testing.assert_allclose(got.numpy(), np.asarray(p_ref), **ATTN_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(x_ref), **ATTN_TOL)


def _gn_inputs(seed, shape, c):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, dy


@pytest.mark.parametrize("silu", [False, True], ids=["gn", "gn_silu"])
def test_group_norm_bwd_plain_matches_pallas_kernel(silu):
    x, scale, bias, dy = _gn_inputs(1, (2, 8, 8, 256), 256)
    ref = jax_fgn.pallas_group_norm_bwd(*(jnp.asarray(a) for a in (x, dy, scale, bias)), 32, 1e-5, silu)
    (dx,), dscale, dbias = group_norm_bwd_plain(
        [torch.from_numpy(x)], torch.from_numpy(dy), torch.from_numpy(scale), torch.from_numpy(bias), 32, 1e-5, silu
    )
    for got, want in zip((dx, dscale, dbias), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(got.shape), **GN_TOL)


@pytest.mark.parametrize(
    "c1,c2,groups,silu",
    [(40, 24, 8, True), (128, 64, 32, False), (20, 10, 3, True)],
    ids=["straddle_silu", "1280_640_scaled", "cpg10_straddle"],
)
def test_group_norm_cat_bwd_matches_jax_vjp(c1, c2, groups, silu):
    x, scale, bias, _ = _gn_inputs(2, (2, 4, 6, c1), c1 + c2)
    s = _gn_inputs(3, (2, 4, 6, c2), c2)[0] * 3.0 - 1.0
    dy = _rand(4, (2, 4, 6, c1 + c2))[0]
    ref = jax.jit(lambda *a: jax.vjp(lambda *p: jax_gn.xla_group_norm_cat(*p, groups, 1e-5, silu), *a)[1](
        jnp.asarray(dy)))(*(jnp.asarray(a) for a in (x, s, scale, bias)))
    (dx, ds), dscale, dbias = group_norm_bwd_plain(
        [torch.from_numpy(x), torch.from_numpy(s)], torch.from_numpy(dy),
        torch.from_numpy(scale), torch.from_numpy(bias), groups, 1e-5, silu,
    )
    for got, want in zip((dx, ds, dscale, dbias), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GN_TOL)


def _grads(fn, *arrays):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*leaves)
    weight = torch.from_numpy(_rand(9, tuple(out.shape))[0])
    (out * weight).sum().backward()
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("m", [64, 77], ids=["self", "cross_m77"])
def test_flash_attention_function_on_cpu_matches_autograd(m):
    q, k, v = _rand(5, (2, 64, 2, 40), (2, m, 2, 40), (2, m, 2, 40))
    native.reset_counters()
    out, grads = _grads(flash_attention, q, k, v)
    ref_out, ref_grads = _grads(lambda *t: flash_attention_plain(*t, 40 ** -0.5), q, k, v)
    torch.testing.assert_close(out, ref_out, **ATTN_TOL)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got, want, **ATTN_TOL)
    assert native.COUNTERS["flash_attention"].count == 0
    assert native.COUNTERS["flash_attention_bwd"].count == 0


@pytest.mark.parametrize("silu", [False, True], ids=["gn", "gn_silu"])
def test_group_norm_functions_on_cpu_match_autograd(silu):
    x, scale, bias, _ = _gn_inputs(6, (2, 4, 4, 40), 64)
    s = _gn_inputs(7, (2, 4, 4, 24), 24)[0] - 1.0
    native.reset_counters()
    out, grads = _grads(lambda a, w, b: fused_group_norm(a, w, b, 8, 1e-5, silu), x, scale[:40], bias[:40])
    ref_out, ref_grads = _grads(lambda a, w, b: xla_group_norm(a, w, b, 8, 1e-5, silu), x, scale[:40], bias[:40])
    torch.testing.assert_close(out, ref_out, **ATTN_TOL)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got, want, **ATTN_TOL)
    out, grads = _grads(lambda a, b2, w, b: fused_group_norm_cat(a, b2, w, b, 8, 1e-5, silu), x, s, scale, bias)
    ref_out, ref_grads = _grads(lambda a, b2, w, b: xla_group_norm_cat(a, b2, w, b, 8, 1e-5, silu), x, s, scale, bias)
    torch.testing.assert_close(out, ref_out, **ATTN_TOL)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got, want, **ATTN_TOL)
    assert native.COUNTERS["group_norm_bwd"].count == 0
