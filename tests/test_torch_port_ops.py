"""Port ops vs the JAX package: attention and GroupNorm, f32 on the CPU.

Inputs come from numpy with a fixed seed and go unchanged to the JAX function
and to its port counterpart. Tolerances are for f32 with a different summation
order: 2e-5 absolute on O(1) outputs (attention averages O(1) values; GN
outputs are O(few)). The kernels themselves run only on a CUDA device:
``tests/test_torch_port_cuda.py`` compares them with their plain versions there.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu.ops import attention as jax_attn  # noqa: E402
from stable_diffusion_pytorch_tpu.ops import fused_groupnorm as jax_fgn  # noqa: E402
from stable_diffusion_pytorch_tpu.ops import groupnorm as jax_gn  # noqa: E402
from stable_diffusion_pytorch_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.ops import native  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.ops.attention import (  # noqa: E402
    multi_head_attention,
    xla_attention,
)
from stable_diffusion_pytorch_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
)
from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import (  # noqa: E402
    fused_group_norm,
    fused_group_norm_cat,
)
from stable_diffusion_pytorch_tpu_torch.ops.groupnorm import (  # noqa: E402
    group_norm,
    group_norm_cat,
    xla_group_norm,
)

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=2e-5)


def _qkv(seed, b, n, m, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((b, n, h, d), (b, m, h, d), (b, m, h, d))]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize(
    "b,n,m,h,d",
    [(2, 64, 64, 2, 40), (1, 48, 77, 2, 80), (2, 96, 77, 1, 40)],
    ids=["self_d40", "cross_m77_d80", "cross_m77_ragged_q"],
)
def test_flash_attention_matches_pallas_interpret(b, n, m, h, d):
    q, k, v = _qkv(0, b, n, m, h, d)
    scale = d ** -0.5
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, interpret=True))
    out = flash_attention(*_t(q, k, v), scale)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "causal_mask"])
def test_xla_attention_matches_jax(masked):
    q, k, v = _qkv(1, 2, 77, 77, 3, 40)
    mask = np.triu(np.ones((77, 77), bool), k=1)[None, None] if masked else None
    ref = jax_attn.xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3,
        None if mask is None else jnp.asarray(mask),
    )
    out = xla_attention(*_t(q, k, v), 0.3, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_multi_head_attention_dispatch_on_cpu():
    """CPU tensors take the plain path and count no kernel launch."""
    native.reset_counters()
    q, k, v = _t(*_qkv(2, 1, 40, 77, 2, 80))
    out = multi_head_attention(q, k, v)
    torch.testing.assert_close(out, flash_attention_plain(q, k, v, 80 ** -0.5))
    assert native.COUNTERS["flash_attention"].count == 0


def _gn_inputs(seed, shape, c):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("silu", [False, True], ids=["gn", "gn_silu"])
def test_group_norm_matches_pallas_kernel(silu):
    """C % 128 == 0 so the JAX kernel (interpret mode off the TPU) runs."""
    x, scale, bias = _gn_inputs(3, (2, 8, 8, 256), 256)
    ref = jax_fgn.pallas_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-5, silu)
    out = group_norm(*_t(x, scale, bias), 32, 1e-5, silu)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("silu", [False, True], ids=["gn", "gn_silu"])
def test_group_norm_cat_matches_pallas_kernel(silu):
    x, scale, bias = _gn_inputs(4, (2, 4, 4, 128), 256)
    s = _gn_inputs(5, (2, 4, 4, 128), 128)[0] + 1.0
    ref = jax_fgn.pallas_group_norm_cat(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-5, silu
    )
    out = group_norm_cat(*_t(x, s, scale, bias), 32, 1e-5, silu)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize(
    "shape,groups,silu",
    [((2, 8, 8, 320), 32, True), ((1, 16, 16, 128), 32, False), ((2, 3, 5, 40), 8, True)],
    ids=["c320_g32", "c128_g32", "c40_g8_odd_hw"],
)
def test_group_norm_matches_xla_unaligned(shape, groups, silu):
    x, scale, bias = _gn_inputs(6, shape, shape[-1])
    ref = jax_gn.xla_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups, 1e-5, silu)
    out = group_norm(*_t(x, scale, bias), groups, 1e-5, silu)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize(
    "c1,c2,groups,silu",
    [(40, 24, 8, True), (40, 24, 8, False), (128, 64, 32, True), (20, 10, 3, True)],
    ids=["straddle_silu", "straddle", "1280_640_scaled", "cpg10_straddle"],
)
def test_group_norm_cat_matches_xla_straddling(c1, c2, groups, silu):
    x, scale, bias = _gn_inputs(7, (2, 4, 6, c1), c1 + c2)
    s = _gn_inputs(8, (2, 4, 6, c2), c2)[0] * 3.0 - 1.0
    args = (jnp.asarray(x), jnp.asarray(s), jnp.asarray(scale), jnp.asarray(bias))
    ref = jax_gn.xla_group_norm_cat(*args, groups, 1e-5, silu)
    out = group_norm_cat(*_t(x, s, scale, bias), groups, 1e-5, silu)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    whole = xla_group_norm(torch.cat(_t(x, s), dim=-1), *_t(scale, bias), groups, 1e-5, silu)
    np.testing.assert_allclose(out.numpy(), whole.numpy(), **TOL)


def test_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    """A tensor that is not on the CPU never reaches the plain path."""
    x = torch.empty((1, 4, 4, 8), device="meta")
    w = torch.empty(8, device="meta")
    with pytest.raises(ValueError):
        fused_group_norm(x, w, w, 2)
    with pytest.raises(ValueError):
        fused_group_norm_cat(x, x, torch.empty(16, device="meta"), torch.empty(16, device="meta"), 2)
    q = torch.empty((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)

