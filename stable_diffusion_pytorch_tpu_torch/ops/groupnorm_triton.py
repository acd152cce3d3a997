"""Triton kernels for GroupNorm(+SiLU)'s concat variant and the backward of both.

This module imports ``triton`` at its top and is imported only by the
launching functions in ``ops/fused_groupnorm.py``, at the first launch on a
CUDA tensor; nothing else imports it. (The plain forward, K6, is CUDA C++:
``csrc/group_norm.cu``.)

Forward of the concat form, three kernels, the port of ``_gn_cat_kernel``
of the JAX package (see ``ops/fused_groupnorm.py`` for the design):

- ``gn_partial_sums``: per-channel partial sums and sums of squares over a
  split of the spatial rows, into [B, n_split, C_total] f32 buffers. A concat
  input runs it once per part, each part writing its own channel columns.
- ``gn_finalize``: per (batch, group), reduces the partials of the group's
  channels and splits (this joins the two parts of a straddling group) into
  mean and 1/std.
- ``gn_normalize``: normalize, affine and optional SiLU of one part, written
  into its channel columns of the [B, S, C_total] output.

Backward (``_gn_bwd_kernel``; the concat form runs the same kernels per part):

- ``gn_bwd_partial_sums``: per-channel partial sums of dy' and dy'*xhat over a
  split of the rows, where dy' is dy after the SiLU derivative and xhat the
  normalized input, recomputed from the forward's mean and 1/std.
- ``gn_bwd_finalize``: per (batch, group), S1 = sum(gamma * dy') and
  S2 = sum(gamma * dy' * xhat) over the group's channels and splits.
- ``gn_bwd_param_grads``: dgamma and dbeta, the partials summed over batch
  and splits.
- ``gn_bwd_dx``: dx = rstd * (gamma * dy' - (S1 + xhat * S2) / n) of one part.
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


@triton.jit
def _xhat_dy(x_ptr, dy_ptr, mean_ptr, rstd_ptr, w_ptr, bias_ptr, b, rows, cols, S, C_part,
             C_total, c_off, cpg, G, APPLY_SILU: tl.constexpr):
    """(xhat, dy', rstd, gamma, mask) of a [rows, cols] tile of one part."""
    cmask = cols < C_part
    cg = c_off + cols
    grp = b * G + cg // cpg
    mean = tl.load(mean_ptr + grp, mask=cmask, other=0.0)
    rstd = tl.load(rstd_ptr + grp, mask=cmask, other=0.0)
    w = tl.load(w_ptr + cg, mask=cmask, other=0.0)
    mask = (rows < S)[:, None] & cmask[None, :]
    row_ids = (b * S + rows).to(tl.int64)[:, None]
    x = tl.load(x_ptr + row_ids * C_part + cols[None, :], mask=mask, other=0.0).to(tl.float32)
    dy = tl.load(dy_ptr + row_ids * C_total + cg[None, :], mask=mask, other=0.0).to(tl.float32)
    xhat = (x - mean[None, :]) * rstd[None, :]
    if APPLY_SILU:
        bias = tl.load(bias_ptr + cg, mask=cmask, other=0.0)
        y = xhat * w[None, :] + bias[None, :]
        sig = tl.sigmoid(y)
        dy = dy * (sig * (1.0 + y * (1.0 - sig)))
    return xhat, dy, rstd, w, mask


@triton.jit
def gn_bwd_partial_sums(
    x_ptr, dy_ptr, mean_ptr, rstd_ptr, w_ptr, bias_ptr, pdb_ptr, pds_ptr,
    S, C_part, C_total, c_off, cpg, G, rows_per_prog, n_split,
    APPLY_SILU: tl.constexpr, BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr,
):
    b = tl.program_id(0)
    sp = tl.program_id(1)
    cols = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
    acc_db = tl.zeros([BLOCK_C], dtype=tl.float32)
    acc_ds = tl.zeros([BLOCK_C], dtype=tl.float32)
    row0 = sp * rows_per_prog
    for r in range(0, rows_per_prog, BLOCK_S):
        rows = row0 + r + tl.arange(0, BLOCK_S)
        xhat, dy, rstd, w, mask = _xhat_dy(
            x_ptr, dy_ptr, mean_ptr, rstd_ptr, w_ptr, bias_ptr, b, rows, cols, S, C_part,
            C_total, c_off, cpg, G, APPLY_SILU,
        )
        dy = tl.where(mask, dy, 0.0)
        acc_db += tl.sum(dy, axis=0)
        acc_ds += tl.sum(dy * xhat, axis=0)
    cmask = cols < C_part
    out = (b * n_split + sp) * C_total + c_off + cols
    tl.store(pdb_ptr + out, acc_db, mask=cmask)
    tl.store(pds_ptr + out, acc_ds, mask=cmask)


@triton.jit
def gn_bwd_finalize(
    pdb_ptr, pds_ptr, w_ptr, s1_ptr, s2_ptr, n_split, C_total, cpg, G,
    BLOCK_P: tl.constexpr, BLOCK_G: tl.constexpr,
):
    b = tl.program_id(0)
    g = tl.program_id(1)
    sp = tl.arange(0, BLOCK_P)
    j = tl.arange(0, BLOCK_G)
    jmask = j < cpg
    mask = (sp < n_split)[:, None] & jmask[None, :]
    offs = (b * n_split + sp)[:, None] * C_total + g * cpg + j[None, :]
    w = tl.load(w_ptr + g * cpg + j, mask=jmask, other=0.0)
    db = tl.sum(tl.load(pdb_ptr + offs, mask=mask, other=0.0), axis=0)
    ds = tl.sum(tl.load(pds_ptr + offs, mask=mask, other=0.0), axis=0)
    tl.store(s1_ptr + b * G + g, tl.sum(db * w, axis=0))
    tl.store(s2_ptr + b * G + g, tl.sum(ds * w, axis=0))


@triton.jit
def gn_bwd_param_grads(
    pdb_ptr, pds_ptr, dw_ptr, db_ptr, n_rows, C_total,
    BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
):
    cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C_total
    acc_w = tl.zeros([BLOCK_C], dtype=tl.float32)
    acc_b = tl.zeros([BLOCK_C], dtype=tl.float32)
    for r0 in range(0, n_rows, BLOCK_R):
        rows = r0 + tl.arange(0, BLOCK_R)
        mask = (rows < n_rows)[:, None] & cmask[None, :]
        offs = rows[:, None] * C_total + cols[None, :]
        acc_w += tl.sum(tl.load(pds_ptr + offs, mask=mask, other=0.0), axis=0)
        acc_b += tl.sum(tl.load(pdb_ptr + offs, mask=mask, other=0.0), axis=0)
    tl.store(dw_ptr + cols, acc_w, mask=cmask)
    tl.store(db_ptr + cols, acc_b, mask=cmask)


@triton.jit
def gn_bwd_dx(
    x_ptr, dy_ptr, dx_ptr, mean_ptr, rstd_ptr, w_ptr, bias_ptr, s1_ptr, s2_ptr,
    S, C_part, C_total, c_off, cpg, G, inv_n,
    APPLY_SILU: tl.constexpr, BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr,
):
    b = tl.program_id(0)
    rows = tl.program_id(1) * BLOCK_S + tl.arange(0, BLOCK_S)
    cols = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
    xhat, dy, rstd, w, mask = _xhat_dy(
        x_ptr, dy_ptr, mean_ptr, rstd_ptr, w_ptr, bias_ptr, b, rows, cols, S, C_part,
        C_total, c_off, cpg, G, APPLY_SILU,
    )
    cmask = cols < C_part
    grp = b * G + (c_off + cols) // cpg
    s1 = tl.load(s1_ptr + grp, mask=cmask, other=0.0)
    s2 = tl.load(s2_ptr + grp, mask=cmask, other=0.0)
    dx = rstd[None, :] * (dy * w[None, :] - (s1[None, :] + xhat * s2[None, :]) * inv_n)
    row_ids = (b * S + rows).to(tl.int64)[:, None]
    tl.store(
        dx_ptr + row_ids * C_part + cols[None, :],
        dx.to(dx_ptr.dtype.element_ty),
        mask=mask,
    )
