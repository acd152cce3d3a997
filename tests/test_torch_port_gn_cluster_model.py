"""A CPU model of the GroupNorm cluster kernels' arithmetic (K8, the concat
forward, and K7, the backward; ``csrc/group_norm.cu``, ``csrc/group_norm_bwd.cu``)
against the JAX package, f32 on the CPU.

The kernels run only on the card. The model repeats what they do with the
launch plan ``gn_launch_plan`` gives them: each slice of whole groups is read
through the per-thread column mapping (a vector column lies wholly in one
part, picked by its first concat channel), each CTA rank of a cluster sums
its rows per row lane and then per channel, the ranks' sums meet in rank
order, and the backward's dgamma and dbeta are summed over per-batch [B, C]
partials in batch order. Inputs come from numpy with a fixed seed; the JAX
side runs its Pallas kernels in interpret mode (C multiples of 128, S of 8,
as they require) and its plain ``xla_group_norm_cat`` (with ``jax.vjp``) at a
concat whose group 3 spans the part boundary (36 + 24 channels, 6 groups:
channels 30-39). Tolerance 1e-5 (relative and absolute): f32 sums of a few
hundred O(1) terms in another order.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu.ops import fused_groupnorm as jax_fgn  # noqa: E402
from stable_diffusion_pytorch_tpu.ops import groupnorm as jax_gn  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import (  # noqa: E402
    GN_THREADS,
    gn_launch_plan,
    group_norm_bwd_plain,
)

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
EPS = 1e-5


def _columns(plan, widths, cpg, s):
    """[(part, first column)] of each vector column of slice ``s``, by the
    kernels' rule: the part of the vector's first concat channel."""
    width = plan.groups_per_slice * cpg
    cols = []
    for vc in range(width // plan.vec):
        cc = s * width + vc * plan.vec
        part = int(len(widths) > 1 and cc >= widths[0])
        first = cc - part * widths[0]
        assert first + plan.vec <= widths[part], (cc, widths, plan)  # the vector lies in one part
        cols.append((part, first))
    return cols


def _gather(parts, cols, vec):
    """The slice's channels [B, S, W] read through the column mapping."""
    return torch.cat([parts[p][..., c:c + vec] for p, c in cols], dim=-1)


def _rank_lane_sums(t, plan, rows):
    """Per rank: the per-channel sums of t [B, S, W] over the rank's rows,
    each row lane's rows in row order, then over the lanes in lane order."""
    lanes = GN_THREADS // (t.shape[-1] // plan.vec)
    out = []
    for rank in range(plan.cluster):
        r0, r1 = rank * plan.rows_per_cta, min(rows, (rank + 1) * plan.rows_per_cta)
        chan = torch.zeros(t.shape[0], t.shape[-1])
        for lane in range(lanes):
            acc = torch.zeros(t.shape[0], t.shape[-1])
            for r in range(r0 + lane, r1, lanes):
                acc = acc + t[:, r]
            chan = chan + acc
        out.append(chan)
    return out


def _in_rank_order(terms):
    total = torch.zeros_like(terms[0])
    for t in terms:
        total = total + t
    return total


def model_forward(parts, scale, bias, groups, silu):
    """K6/K8 -> (y [B, S, C], mean, rstd [B, G])."""
    b, rows = parts[0].shape[:2]
    widths = [p.shape[-1] for p in parts]
    c = sum(widths)
    cpg = c // groups
    plan = gn_launch_plan(b, rows, c, groups, 4, 16, widths[0] if len(parts) > 1 else 0)
    width, gps = plan.groups_per_slice * cpg, plan.groups_per_slice
    y = torch.empty(b, rows, c)
    mean, rstd = torch.empty(b, groups), torch.empty(b, groups)
    n = rows * cpg
    for s in range(plan.n_slices):
        x = _gather(parts, _columns(plan, widths, cpg, s), plan.vec)
        sums = _in_rank_order([ch.view(b, gps, cpg).sum(-1) for ch in _rank_lane_sums(x, plan, rows)])
        sq = _in_rank_order([ch.view(b, gps, cpg).sum(-1) for ch in _rank_lane_sums(x * x, plan, rows)])
        m = sums / n
        r = torch.rsqrt(sq / n - m * m + EPS)
        mean[:, s * gps:(s + 1) * gps], rstd[:, s * gps:(s + 1) * gps] = m, r
        ch = slice(s * width, (s + 1) * width)
        a = r.repeat_interleave(cpg, 1)[:, None] * scale[ch]
        out = x * a + (bias[ch] - m.repeat_interleave(cpg, 1)[:, None] * a)
        y[..., ch] = out * torch.sigmoid(out) if silu else out
    return y, mean, rstd


def model_backward(parts, dy, scale, bias, mean, rstd, groups, silu):
    """K7 with the forward's statistics -> ([dx per part], dgamma, dbeta)."""
    b, rows = parts[0].shape[:2]
    widths = [p.shape[-1] for p in parts]
    c = sum(widths)
    cpg = c // groups
    plan = gn_launch_plan(b, rows, c, groups, 4, 16, widths[0] if len(parts) > 1 else 0, 2)
    width, gps = plan.groups_per_slice * cpg, plan.groups_per_slice
    dxs = [torch.empty_like(p) for p in parts]
    partial = torch.empty(2, b, c)  # dgamma, dbeta of each batch element
    n = rows * cpg
    for s in range(plan.n_slices):
        cols = _columns(plan, widths, cpg, s)
        ch = slice(s * width, (s + 1) * width)
        x = _gather(parts, cols, plan.vec)
        m = mean[:, s * gps:(s + 1) * gps].repeat_interleave(cpg, 1)[:, None]
        r = rstd[:, s * gps:(s + 1) * gps].repeat_interleave(cpg, 1)[:, None]
        xh = (x - m) * r
        d = dy[..., ch]
        if silu:
            yy = xh * scale[ch] + bias[ch]
            sg = torch.sigmoid(yy)
            d = d * (sg * (1.0 + yy * (1.0 - sg)))
        db = _rank_lane_sums(d, plan, rows)
        ds = _rank_lane_sums(d * xh, plan, rows)
        s1 = _in_rank_order([(t * scale[ch]).view(b, gps, cpg).sum(-1) for t in db])
        s2 = _in_rank_order([(t * scale[ch]).view(b, gps, cpg).sum(-1) for t in ds])
        partial[0, :, ch], partial[1, :, ch] = _in_rank_order(ds), _in_rank_order(db)
        dx = r * (scale[ch] * d - (s1.repeat_interleave(cpg, 1)[:, None]
                                   + xh * s2.repeat_interleave(cpg, 1)[:, None]) / n)
        for vc, (p, first) in enumerate(cols):
            dxs[p][..., first:first + plan.vec] = dx[..., vc * plan.vec:(vc + 1) * plan.vec]
    return dxs, _in_rank_order(list(partial[0])), _in_rank_order(list(partial[1]))


def _inputs(seed, b, rows, widths):
    rng = np.random.default_rng(seed)
    c = sum(widths)
    parts = [(rng.standard_normal((b, rows, w)) * (2.0 + i) + 0.5 - 1.5 * i).astype(np.float32)
             for i, w in enumerate(widths)]
    scale = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal((b, rows, c)).astype(np.float32)
    return parts, scale, bias, dy


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("silu", [False, True], ids=["gn", "gn_silu"])
def test_cluster_model_matches_the_pallas_kernels(silu):
    """K8's model against ``pallas_group_norm_cat`` (128 + 128 channels), K7's
    against ``pallas_group_norm_bwd`` (256 channels), in interpret mode."""
    parts, scale, bias, dy = _inputs(11, 2, 48, (128, 128))
    ref = jax_fgn.pallas_group_norm_cat(*(jnp.asarray(a) for a in (*parts, scale, bias)), 32, EPS, silu)
    y, _, _ = model_forward(_t(*parts), *_t(scale, bias), 32, silu)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)

    x = np.concatenate(parts, axis=-1)
    ref = jax_fgn.pallas_group_norm_bwd(*(jnp.asarray(a) for a in (x, dy, scale, bias)), 32, EPS, silu)
    _, mean, rstd = model_forward(_t(x), *_t(scale, bias), 32, silu)
    (dx,), dgamma, dbeta = model_backward(_t(x), *_t(dy, scale, bias), mean, rstd, 32, silu)
    for got, want in zip((dx, dgamma, dbeta), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("silu", [False, True], ids=["gn", "gn_silu"])
def test_cluster_model_matches_xla_at_a_straddling_concat(silu):
    """36 + 24 channels in 6 groups (group 3: channels 30-39 over both parts),
    batch 3, 64 rows: the model against ``xla_group_norm_cat`` and its
    ``jax.vjp``, and the backward against the port's ``group_norm_bwd_plain``."""
    parts, scale, bias, dy = _inputs(12, 3, 64, (36, 24))
    plan = gn_launch_plan(3, 64, 60, 6, 4, 16, 36, 2)
    assert plan.cluster > 1 and plan.n_slices > 1, plan  # ranks and slices both exercised
    def fwd_vjp(*args):
        out, vjp = jax.vjp(lambda *p: jax_gn.xla_group_norm_cat(*p, 6, EPS, silu), *args[:-1])
        return out, vjp(args[-1])

    ref_y, ref_grads = jax.jit(fwd_vjp)(*(jnp.asarray(a) for a in (*parts, scale, bias, dy)))
    y, mean, rstd = model_forward(_t(*parts), *_t(scale, bias), 6, silu)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **TOL)
    (dx, ds), dgamma, dbeta = model_backward(_t(*parts), *_t(dy, scale, bias), mean, rstd, 6, silu)
    plain = group_norm_bwd_plain(_t(*parts), *_t(dy, scale, bias), 6, EPS, silu)
    for got, want, p in zip((dx, ds, dgamma, dbeta), ref_grads, (*plain[0], *plain[1:])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), p.numpy(), **TOL)
