"""Triton kernels for GroupNorm(+SiLU) and its concat variant.

This module imports ``triton`` at its top and is imported only by the
launching functions in ``ops/fused_groupnorm.py``, at the first launch on a
CUDA tensor; nothing else imports it.

Three kernels serve both ``_gn_kernel`` and ``_gn_cat_kernel`` of the JAX
package (see ``ops/fused_groupnorm.py`` for the design):

- ``gn_partial_sums``: per-channel partial sums and sums of squares over a
  split of the spatial rows, into [B, n_split, C_total] f32 buffers. A concat
  input runs it once per part, each part writing its own channel columns.
- ``gn_finalize``: per (batch, group), reduces the partials of the group's
  channels and splits (this joins the two parts of a straddling group) into
  mean and 1/std.
- ``gn_normalize``: normalize, affine and optional SiLU of one part, written
  into its channel columns of the [B, S, C_total] output.
"""

import triton
import triton.language as tl


@triton.jit
def gn_partial_sums(
    x_ptr, psum_ptr, psq_ptr,
    S, C_part, C_total, c_off, rows_per_prog, n_split,
    BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr,
):
    b = tl.program_id(0)
    sp = tl.program_id(1)
    cols = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C_part
    acc = tl.zeros([BLOCK_C], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK_C], dtype=tl.float32)
    row0 = sp * rows_per_prog
    for r in range(0, rows_per_prog, BLOCK_S):
        rows = row0 + r + tl.arange(0, BLOCK_S)
        mask = (rows < S)[:, None] & cmask[None, :]
        offs = (b * S + rows).to(tl.int64)[:, None] * C_part + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        acc += tl.sum(x, axis=0)
        acc2 += tl.sum(x * x, axis=0)
    out = (b * n_split + sp) * C_total + c_off + cols
    tl.store(psum_ptr + out, acc, mask=cmask)
    tl.store(psq_ptr + out, acc2, mask=cmask)


@triton.jit
def gn_finalize(
    psum_ptr, psq_ptr, mean_ptr, rstd_ptr,
    n_split, C_total, cpg, G, n_elems, eps,
    BLOCK_P: tl.constexpr, BLOCK_G: tl.constexpr,
):
    b = tl.program_id(0)
    g = tl.program_id(1)
    sp = tl.arange(0, BLOCK_P)
    j = tl.arange(0, BLOCK_G)
    mask = (sp < n_split)[:, None] & (j < cpg)[None, :]
    offs = (b * n_split + sp)[:, None] * C_total + g * cpg + j[None, :]
    s1 = tl.sum(tl.sum(tl.load(psum_ptr + offs, mask=mask, other=0.0), axis=1), axis=0)
    s2 = tl.sum(tl.sum(tl.load(psq_ptr + offs, mask=mask, other=0.0), axis=1), axis=0)
    mean = s1 / n_elems
    var = s2 / n_elems - mean * mean
    tl.store(mean_ptr + b * G + g, mean)
    tl.store(rstd_ptr + b * G + g, tl.rsqrt(var + eps))


@triton.jit
def gn_normalize(
    x_ptr, out_ptr, mean_ptr, rstd_ptr, w_ptr, bias_ptr,
    S, C_part, C_total, c_off, cpg, G,
    APPLY_SILU: tl.constexpr, BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr,
):
    b = tl.program_id(0)
    rows = tl.program_id(1) * BLOCK_S + tl.arange(0, BLOCK_S)
    cols = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C_part
    cg = c_off + cols
    grp = b * G + cg // cpg
    mean = tl.load(mean_ptr + grp, mask=cmask, other=0.0)
    rstd = tl.load(rstd_ptr + grp, mask=cmask, other=0.0)
    w = tl.load(w_ptr + cg, mask=cmask, other=0.0)
    bias = tl.load(bias_ptr + cg, mask=cmask, other=0.0)
    mask = (rows < S)[:, None] & cmask[None, :]
    row_ids = (b * S + rows).to(tl.int64)[:, None]
    x = tl.load(x_ptr + row_ids * C_part + cols[None, :], mask=mask, other=0.0).to(tl.float32)
    y = (x - mean[None, :]) * rstd[None, :] * w[None, :] + bias[None, :]
    if APPLY_SILU:
        y = y * tl.sigmoid(y)
    tl.store(
        out_ptr + row_ids * C_total + cg[None, :],
        y.to(out_ptr.dtype.element_ty),
        mask=mask,
    )
