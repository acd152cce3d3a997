"""A plain-torch model of the bf16 tensor-core attention kernels' arithmetic.

The bf16 forward (``csrc/flash_attention.cu``, ``fa_forward_wgmma_kernel``)
and split backward (``csrc/flash_attention_bwd_split.cu``,
``split_dq_wgmma_kernel`` / ``split_dkv_wgmma_kernel``), tile order aside:
bf16 operands, f32 products and sums, P rounded to bf16 before P.V and
P^T.dO, dS rounded to bf16 before dS.K and dS^T.Q, f32 statistics, and
delta = rowsum(dO * O) from the bf16 output O (the split set's delta pass).
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


def model_backward(q, k, v, o, do, lse2, scale, delta=None, round_ds=True):
    """-> (dq, dk, dv) bf16 [B, L, H, D]. ``delta`` (f32 [B, H, N]) replaces
    the kernels' rowsum(dO * O); ``round_ds=False`` keeps dS in f32."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    p = torch.exp2(s * (scale * LOG2E) - lse2[..., None])
    dp = torch.einsum("bnhd,bmhd->bhnm", do.float(), v.float())
    if delta is None:
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None])
    p16 = p.bfloat16().float()
    ds16 = ds.bfloat16().float() if round_ds else ds
    dv = torch.einsum("bhnm,bnhd->bmhd", p16, do.float())
    dq = torch.einsum("bhnm,bmhd->bnhd", ds16, k.float()) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds16, q.float()) * scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def exact_delta(q, k, v, do, lse2, scale):
    """rowsum(P * dP) in f32: the delta of the TPU kernels K3, K4 and K5."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    p = torch.exp2(s * (scale * LOG2E) - lse2[..., None])
    return (p * torch.einsum("bnhd,bmhd->bhnm", do.float(), v.float())).sum(-1)


def own_scale_err(got, ref):
    """max|got - ref| / max|ref|: the error relative to the output's own magnitude."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max()).item()
