"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at its
700 W limit): what a roofline share or a model-FLOPs share is taken against."""

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, flops_peak: float = BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / flops_peak, nbytes / HBM_BYTES_PER_S)
