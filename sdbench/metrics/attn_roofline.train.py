"""Attention kernels share of their roofline over the traced training steps: K1 forward,
the stats pass and the K3/K4/K5 backward against the bound of every forward and backward
attention call (moves samples_per_s)."""

from readers import attn_bwd, attn_fwd, roofline_share

KERNELS = ("fa_forward_kernel", "fa_forward_wgmma", "bwd_stats_wgmma", "split_dq", "split_dkv", "split_delta",
           "fused_bwd_wgmma", "dkv_kernel", "delta_kernel", "cast_kernel<")


def read(rec):
    def calls(work):
        yield from (attn_fwd(*c, train=True) for c in work["attn_fwd"])
        yield from (attn_bwd(*c) for c in work["attn_bwd"])

    return roofline_share(rec, KERNELS, calls)
