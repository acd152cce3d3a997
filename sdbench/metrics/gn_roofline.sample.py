"""GroupNorm kernels (K6, K8) share of their bytes roofline over the traced txt2img calls
(moves images_per_s)."""

from readers import gn_fwd, roofline_share

KERNELS = ("gn_fwd_cluster", "gn_cat_cluster")


def read(rec):
    return roofline_share(rec, KERNELS, lambda work: (gn_fwd(*c) for c in work["gn_fwd"]))
