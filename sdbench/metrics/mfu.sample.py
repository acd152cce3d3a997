"""% of the bf16 peak that the traced txt2img calls reach by the reference model FLOPs
(text tower, the CFG UNet at every step, the decode; moves images_per_s)."""

from readers import model_flops_share


def read(rec):
    return model_flops_share(rec)
