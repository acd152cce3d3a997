"""A plain-torch model of the bf16 tensor-core attention kernels' arithmetic.

The bf16 forward (``csrc/flash_attention.cu``, ``fa_forward_wgmma_kernel``),
the split backward (``csrc/flash_attention_bwd_split.cu``,
``split_dq_wgmma_kernel`` / ``split_dkv_wgmma_kernel``) and the fused
backward K3 (``csrc/flash_attention_bwd.cu``, ``fused_bwd_wgmma_kernel``),
tile order aside: bf16 operands, f32 products and sums, P rounded to bf16
before P.V and P^T.dO, dS rounded to bf16 before dS.K and dS^T.Q, f32
statistics, and delta = rowsum(P * dP) in f32 with S and dP recomputed
(``bwd_stats_wgmma_kernel``, the stats pass of both backward routes). The
delta the kernels took before that pass, rowsum(dO * O) from the bf16 output
O, stays as an option. K3 adds dQ's shares over kv blocks of 128 rows in
block order (:func:`model_backward_fused`).
Imports neither jax nor the JAX package, so the card's tests use it too.
"""

import torch

LOG2E = 1.4426950408889634


def model_forward(q, k, v, scale):
    """bf16 q/k/v [B, L, H, D] -> (out bf16, lse2 f32 [B, H, N])."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * (scale * LOG2E)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhnm,bmhd->bnhd", p.bfloat16().float(), v.float())
    o = o / l.squeeze(-1).transpose(1, 2)[..., None]
    return o.bfloat16(), (m + torch.log2(l)).squeeze(-1)


def model_backward(q, k, v, o, do, lse2, scale, delta="stats", round_ds=True):
    """-> (dq, dk, dv) bf16 [B, L, H, D]. ``delta``: ``"stats"``, the stats
    pass's f32 rowsum(P * dP) (:func:`exact_delta`); ``"output"``,
    rowsum(dO * O) from the bf16 O; or an f32 [B, H, N] tensor.
    ``round_ds=False`` keeps dS in f32."""
    ds16, p16 = _ds_and_p(q, k, v, o, do, lse2, scale, delta, round_ds)
    dv = torch.einsum("bhnm,bnhd->bmhd", p16, do.float())
    dq = torch.einsum("bhnm,bmhd->bnhd", ds16, k.float()) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds16, q.float()) * scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def model_backward_fused(q, k, v, o, do, lse2, scale, block_kv=128):
    """K3's rounding points: as :func:`model_backward`, with dQ the f32 sum
    of each block of ``block_kv`` kv rows' share, scale * dS16 K, added in
    block order (the ordered adds of ``fused_bwd_wgmma_kernel``)."""
    ds16, p16 = _ds_and_p(q, k, v, o, do, lse2, scale, "stats", True)
    dv = torch.einsum("bhnm,bnhd->bmhd", p16, do.float())
    dk = torch.einsum("bhnm,bnhd->bmhd", ds16, q.float()) * scale
    dq = None
    for m0 in range(0, k.shape[1], block_kv):
        share = torch.einsum("bhnm,bmhd->bnhd", ds16[..., m0:m0 + block_kv], k[:, m0:m0 + block_kv].float()) * scale
        dq = share if dq is None else dq + share
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _ds_and_p(q, k, v, o, do, lse2, scale, delta, round_ds):
    """(dS, P) as the kernels feed them to the next products: bf16-rounded, in f32."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    p = torch.exp2(s * (scale * LOG2E) - lse2[..., None])
    dp = torch.einsum("bnhd,bmhd->bhnm", do.float(), v.float())
    if isinstance(delta, str):
        if delta == "stats":
            delta = (p * dp).sum(-1)
        elif delta == "output":
            delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
        else:
            raise ValueError(f"delta: 'stats', 'output' or a tensor (got {delta!r})")
    ds = p * (dp - delta[..., None])
    return (ds.bfloat16().float() if round_ds else ds), p.bfloat16().float()


def exact_delta(q, k, v, do, lse2, scale):
    """rowsum(P * dP) in f32: the delta of the TPU kernels K3, K4 and K5."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    p = torch.exp2(s * (scale * LOG2E) - lse2[..., None])
    return (p * torch.einsum("bnhd,bmhd->bhnm", do.float(), v.float())).sum(-1)


def own_scale_err(got, ref):
    """max|got - ref| / max|ref|: the error relative to the output's own magnitude."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max()).item()
