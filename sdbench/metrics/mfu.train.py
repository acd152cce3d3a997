"""% of the bf16 peak that the traced training steps reach by the reference model FLOPs
(forward and backward, no recompute; moves samples_per_s)."""

from readers import model_flops_share


def read(rec):
    return model_flops_share(rec)
