"""The launch plan (``ops/fused_groupnorm.py:gn_launch_plan``) of K6, K8 (the
concat form) and K7 (the backward) over every GroupNorm shape of the SD-1.5
UNet and VAE at 512px and 1024px.

The plan is a pure function of the shape; the kernels (``csrc/group_norm.cu``,
``csrc/group_norm_bwd.cu``) run only on the card. The shapes here are a
superset of the model's: every channel count a GroupNorm of the UNet sees (its
levels' widths and the up path's concatenations) at every UNet level, and the
VAE's widths at every VAE level, at the sampling batches (1, 2 with CFG) and
the training ones (4, 16), in bfloat16 and float32; the concat form and the
backward over the up path's part widths. No jax needed.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import (  # noqa: E402
    GN_BWD_MAX_VECS,
    GN_FILL_CTAS,
    GN_MAX_CLUSTER,
    GN_MIN_ROWS,
    GN_RESIDENT_BYTES,
    GN_SMEM_MAX,
    GN_THREADS,
    gn_launch_plan,
)

GROUPS = 32
UNET_CHANNELS = (320, 640, 960, 1280, 1920, 2560)
VAE_CHANNELS = (128, 256, 512)
# the up path's skip concatenations (current, skip): 1280 + 640 and 640 + 320
# in 32 groups have a group across the boundary (channels 1260-1319, 630-659)
CONCAT_PARTS = ((1280, 1280), (1280, 640), (640, 640), (640, 320), (320, 320))


def sd15_group_norm_shapes():
    """(rows, channels) of the SD-1.5 UNet (latent side image/8, four levels)
    and VAE (image side down to image/8) at 512px and 1024px."""
    shapes = set()
    for image in (512, 1024):
        for level in range(4):
            side = image // 8 >> level
            shapes |= {(side * side, c) for c in UNET_CHANNELS}
            side = image >> level
            shapes |= {(side * side, c) for c in VAE_CHANNELS}
    return sorted(shapes)


def _most_slices(channels, vec, elem):
    """Slices of the narrowest plan a batch of one may take: whole groups whose
    width the vector divides and, where any does, that fill 32-byte sectors."""
    cpg = channels // GROUPS
    valid = [g for g in range(1, GROUPS + 1) if GROUPS % g == 0 and (g * cpg) % vec == 0]
    full = [g for g in valid if g * cpg * elem >= 32]
    return GROUPS // min(full or valid)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("batch", [1, 2, 4, 16])
def test_plan_over_the_model_shapes(batch, elem):
    for rows, channels in sd15_group_norm_shapes():
        p = gn_launch_plan(batch, rows, channels, GROUPS, elem)
        cpg = channels // GROUPS
        width = p.groups_per_slice * cpg
        where = (batch, rows, channels, elem, p)
        # no group straddles a slice: slices are runs of whole groups that tile the channels
        assert p.groups_per_slice * p.n_slices == GROUPS, where
        assert width % p.vec == 0 and channels % p.vec == 0 and p.vec * elem <= 16, where
        assert width // p.vec <= GN_THREADS, where
        # the cluster: at most 16 CTAs, splitting the rows with none empty
        assert 1 <= p.cluster <= GN_MAX_CLUSTER, where
        assert p.cluster * p.rows_per_cta >= rows > (p.cluster - 1) * p.rows_per_cta, where
        # shared memory within a block's 227 KB, the rows only where they fit
        assert p.smem <= GN_SMEM_MAX, where
        assert p.resident == (p.rows_per_cta * width * elem <= GN_RESIDENT_BYTES), where
        if batch == 1:
            # a batch of one fills the card where the shape allows it: the
            # narrowest slice that fills whole sectors and the largest cluster
            # bound what a plan may do
            cap = max(1, min(GN_MAX_CLUSTER, math.ceil(rows / GN_MIN_ROWS)))
            most = _most_slices(channels, p.vec, elem) * cap
            assert p.n_slices * p.cluster >= min(GN_FILL_CTAS, most), where


def test_plan_keeps_the_1024px_unet_map_on_chip_and_streams_the_vae_decoder():
    """The UNet's 1024px level 0 (16384 x 320) stays in shared memory at batch
    1 on about one CTA per SM (eight clusters of 16); the VAE decoder's 512^2 x 128 map (64 MB per
    image in bf16) does not fit any cluster and streams."""
    p = gn_launch_plan(1, 128 * 128, 320, GROUPS, 2)
    assert p.resident and p.n_slices * p.cluster >= 128 and p.cluster == GN_MAX_CLUSTER, p
    p = gn_launch_plan(1, 512 * 512, 128, GROUPS, 2)
    assert not p.resident and p.n_slices * p.cluster >= 128, p


def test_plan_narrows_the_vector_to_the_alignment_and_the_channels():
    assert gn_launch_plan(1, 64, 320, GROUPS, 2).vec == 8
    assert gn_launch_plan(1, 64, 320, GROUPS, 2, align_bytes=4).vec == 2
    assert gn_launch_plan(2, 17, 20, 4, 2).vec == 4  # 20 channels: 8 does not divide them
    assert gn_launch_plan(2, 17, 20, 4, 4).vec == 4
    with pytest.raises(ValueError):
        gn_launch_plan(1, 64, 100, 32, 2)  # 32 groups do not divide 100 channels


def sd15_concat_shapes():
    """(rows, C0, C1) of the SD-1.5 UNet's concat GroupNorms at 512px and 1024px."""
    return sorted({((image // 8 >> level) ** 2, c0, c1)
                   for image in (512, 1024) for level in range(4) for c0, c1 in CONCAT_PARTS})


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("batch", [1, 4, 16])
@pytest.mark.parametrize("kind", ["cat", "bwd_cat", "bwd"])
def test_concat_and_backward_plans_over_the_model_shapes(kind, batch, elem):
    """K8's plan (two parts) and K7's (x and dy in shared memory together; one
    part or two): the vector divides both parts, so every vector column lies
    in one part; a group across the boundary stays whole within its slice;
    the backward's slices stay narrow where the groups allow; the resident
    budget holds both inputs; clusters of at most 16 CTAs, none empty; shared
    memory within a block's 227 KB."""
    inputs = 1 if kind == "cat" else 2
    shapes = [(r, c, 0) for r, c in sd15_group_norm_shapes()] if kind == "bwd" else sd15_concat_shapes()
    for rows, c0, c1 in shapes:
        c = c0 + c1
        p = gn_launch_plan(batch, rows, c, GROUPS, elem, 16, c0 if c1 else 0, inputs)
        cpg = c // GROUPS
        width = p.groups_per_slice * cpg
        where = (kind, batch, rows, c0, c1, elem, p)
        assert c0 % p.vec == 0 and c1 % p.vec == 0 and p.vec * elem <= 16, where
        if c1:
            firsts = range(0, c, p.vec)  # every vector column of every slice
            assert all((cc < c0) == (cc + p.vec - 1 < c0) for cc in firsts), where
            if c0 % cpg:
                g = c0 // cpg  # the group across the boundary
                assert g * cpg // width == ((g + 1) * cpg - 1) // width, where
        assert p.groups_per_slice * p.n_slices == GROUPS and width // p.vec <= GN_THREADS, where
        if inputs == 2 and any(GROUPS % g == 0 and (g * cpg) % p.vec == 0 and g * cpg // p.vec <= GN_BWD_MAX_VECS
                               for g in range(1, GROUPS + 1)):
            assert width // p.vec <= GN_BWD_MAX_VECS, where
        assert 1 <= p.cluster <= GN_MAX_CLUSTER, where
        assert p.cluster * p.rows_per_cta >= rows > (p.cluster - 1) * p.rows_per_cta, where
        assert p.smem <= GN_SMEM_MAX, where
        assert p.resident == (inputs * p.rows_per_cta * width * elem <= GN_RESIDENT_BYTES), where


def test_plan_fills_the_resident_budget_exactly():
    """A cluster is sized by the rows a CTA can hold, so a map that fits in
    shared memory at the largest cluster is not streamed for a rounding: the
    1920-channel concat at 32x32 (batch 16), forward and backward."""
    for inputs in (1, 2):
        p = gn_launch_plan(16, 1024, 1920, GROUPS, 2, 16, 1280, inputs)
        assert p.resident and p.rows_per_cta * p.groups_per_slice * 60 * 2 * inputs <= GN_RESIDENT_BYTES, p


@pytest.mark.parametrize("inputs", [1, 2], ids=["forward", "backward"])
@pytest.mark.parametrize("groups", [32, 2], ids=["groups32", "bottleneck_default_groups"])
def test_plan_over_the_vae_training_shapes(groups, inputs):
    """The SD-1.5 VAE's training maps at 256px (image side 256 down to 32,
    128-512 channels: 4 to 16 channels a group, the 32x32 bottleneck
    included) and at the f32 parity's 64px, batches 1 and 4; with 2 groups,
    the first bottleneck ResBlock's under ``bottleneck_default_groups`` (256
    channels a group at 512). The same invariants as at the UNet's shapes."""
    for batch, image in ((4, 256), (1, 64)):
        for level in range(4):
            rows = (image >> level) ** 2
            for channels in VAE_CHANNELS:
                for elem in (2, 4):
                    p = gn_launch_plan(batch, rows, channels, groups, elem, 16, 0, inputs)
                    width = p.groups_per_slice * channels // groups
                    where = (batch, rows, channels, groups, elem, inputs, p)
                    assert p.groups_per_slice * p.n_slices == groups, where
                    assert width % p.vec == 0 and channels % p.vec == 0 and p.vec * elem <= 16, where
                    assert width // p.vec <= GN_THREADS, where
                    assert 1 <= p.cluster <= GN_MAX_CLUSTER, where
                    assert p.cluster * p.rows_per_cta >= rows > (p.cluster - 1) * p.rows_per_cta, where
                    assert p.smem <= GN_SMEM_MAX, where
                    assert p.resident == (inputs * p.rows_per_cta * width * elem <= GN_RESIDENT_BYTES), where
