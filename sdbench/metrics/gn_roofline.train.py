"""GroupNorm kernels (K6, K7, K8) share of their bytes roofline over the traced training
steps (moves samples_per_s)."""

from readers import gn_bwd, gn_fwd, roofline_share

KERNELS = ("gn_fwd_cluster", "gn_cat_cluster", "gn_bwd_cluster")


def read(rec):
    def calls(work):
        yield from (gn_fwd(*c) for c in work["gn_fwd"])
        yield from (gn_bwd(*c) for c in work["gn_bwd"])

    return roofline_share(rec, KERNELS, calls)
