"""K1 (flash attention forward) share of its roofline over the traced txt2img calls:
the bound of every UNet and VAE attention call over the K1 kernels device time (moves images_per_s)."""

from readers import attn_fwd, roofline_share

KERNELS = ("fa_forward_kernel", "fa_forward_wgmma")


def read(rec):
    return roofline_share(rec, KERNELS, lambda work: (attn_fwd(*c, train=False) for c in work["attn_fwd"]))
