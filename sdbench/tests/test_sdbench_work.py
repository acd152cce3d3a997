"""work.py's tallies against hand counts at a tiny configuration, and the
per-layer readers on canned traces."""

import json
import os

import pytest

import harness
import readers
import work
from peaks import BF16_FLOPS, HBM_BYTES_PER_S

TINY = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny.json")))


def test_sample_tallies_match_a_hand_count():
    tr = {"batch": 2, "image_size": 64, "steps": 3}
    w = work.sample_work(TINY, tr)
    # The tiny VAE downsamples by 2: a 64 image is a 32x32 latent. UNet attention at 32x32
    # (level 0: one input block, two output blocks) and 16x16 (level 1: one input block, the
    # bottleneck, two output blocks); each transformer a self and a cross attention on the
    # CFG batch of 4, 2 heads, d_head = width / 2; text context of 77 tokens.
    per_step = []
    for hw, width, count in ((1024, 32, 3), (256, 64, 4)):
        per_step += [(4, 2, hw, hw, width // 2), (4, 2, hw, 77, width // 2)] * count
    vae = [(2, 1, 1024, 1024, 32)]  # the decoder's mid block: 32x32 latent, the widest level's 32 channels
    assert sorted(w["attn_fwd"]) == sorted(per_step * 3 + vae)
    # GroupNorm calls: two a ResBlock, one a transformer, one before the UNet's output conv.
    # UNet: input Res+ST, Res+ST (6), middle Res, ST, Res (5), output 4 x (Res+ST) (12), out (1);
    # VAE decoder: mid block Res, attention, Res (5), up path 2 x 2 Res (8), out (1).
    assert len(w["gn_fwd"]) == 24 * 3 + 14
    # the first: the first ResBlock over conv_in's output, 4 x 32 x 32 x 32 in and out
    assert w["gn_fwd"][0] == (4 * 32 * 32 * 32, 4 * 32 * 32 * 32)
    # an up-path ResBlock's first norm normalizes its input and the skip together: at 32x32,
    # 64 channels from below and the 32 of the skip
    assert (4 * 32 * 32 * 96, 4 * 32 * 32 * 96) in w["gn_fwd"]
    assert w["attn_bwd"] == [] and w["gn_bwd"] == []


def test_train_tallies_count_forward_and_backward():
    w = work.train_work(TINY, {"batch": 2, "image_size": 32})
    # image 32 -> latent 16x16: the frozen encoder's mid block at 16x16 with 32 channels runs
    # forward only; every UNet call runs forward and backward
    assert w["attn_fwd"][0] == (2, 1, 256, 256, 32) and w["attn_bwd"] == w["attn_fwd"][1:]
    # the encoder's GroupNorms: a resnet at each of 2 levels (4), the mid block (5), the out norm (1)
    assert w["gn_bwd"] == w["gn_fwd"][10:]


def test_flop_counter_counts_a_linear_layer_by_hand():
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from reference.models import Lin
    from reference.numerics import Prec

    lin = Lin(Prec(), 768, 3072)
    with FlopCounterMode(display=False) as fc:
        lin(torch.empty((2, 77, 768), device="meta"))
    assert fc.get_total_flops() == 2 * 2 * 77 * 768 * 3072


def test_unet_flops_are_its_convolutions_and_products():
    w = work.sample_work(TINY, {"batch": 2, "image_size": 64, "steps": 1})
    # the conv_in alone: 2 * B * H * W * C_out * C_in * 9 at the CFG batch of 4, 32x32
    assert w["model_flops"] > 2 * 4 * 32 * 32 * 32 * 4 * 9


def test_idle_share_uses_the_union_of_overlapping_kernels():
    rec = {"kernels": [("a", 0.0, 0.4), ("b", 0.2, 0.5), ("c", 0.7, 0.8)], "window_s": 1.0}
    assert harness.busy_seconds(rec["kernels"]) == pytest.approx(0.6)
    assert readers.idle_share(rec) == pytest.approx(40.0)
    assert readers.idle_share({"kernels": [], "window_s": 1.0}) is None


def test_roofline_share_of_attention_and_groupnorm():
    calls = [(2, 8, 4096, 4096, 40)]
    flops, nbytes = readers.attn_fwd(*calls[0], train=False)
    assert flops == 4 * 2 * 8 * 4096 * 4096 * 40
    assert nbytes == 2 * 2 * 8 * 40 * (2 * 4096 + 2 * 4096)
    least = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
    rec = {"kernels": [("void fa_forward_wgmma_kernel<64>", 0.0, 2 * least), ("conv", 0.0, 1.0)],
           "window_s": 1.0, "units": 1, "work": {"attn_fwd": calls, "gn_fwd": [(100, 100)], "model_flops": 1e12}}
    share = harness.load_module("metrics", "attn_roofline.sample").read(rec)
    assert share == pytest.approx(50.0)
    assert harness.load_module("metrics", "gn_roofline.sample").read(rec) is None  # no GroupNorm kernel traced
    assert harness.load_module("metrics", "mfu.sample").read(rec) == pytest.approx(100.0 * 1e12 / BF16_FLOPS)
    flops_b, bytes_b = readers.attn_bwd(*calls[0])
    assert flops_b == 10 * 2 * 8 * 4096 * 4096 * 40 and bytes_b > nbytes
    assert readers.gn_fwd(10, 10) == (0.0, 40.0) and readers.gn_bwd(10, 10) == (0.0, 60.0)


def test_span_readers():
    rec = {"loop_ms": [500.0, 520.0], "decode_ms": [40.0, 44.0], "steps": 50, "place_ms_p50": 12.5}
    assert harness.load_module("metrics", "loop_ms_per_step.sample").read(rec) == pytest.approx(10.2)
    assert harness.load_module("metrics", "decode_ms.sample").read(rec) == pytest.approx(42.0)
    assert harness.load_module("metrics", "place_ms.train").read(rec) == 12.5
    assert harness.load_module("metrics", "place_ms.train").read({}) is None


def test_breakdown_names_gaps_by_the_open_span():
    traced = {"kernels": [("gn_fwd_cluster", 0.0, 0.1), ("fa_forward_wgmma", 0.3, 0.5)], "window_s": 1.0, "t0": 100.0}
    spans = [("call", 100.0, 101.0), ("decode", 100.1, 100.3)]
    out = harness.breakdown(traced, spans)
    assert out["idle_gaps"][0] == ["call", pytest.approx(0.5)]
    assert out["idle_gaps"][1] == ["decode", pytest.approx(0.2)]
    assert dict(out["device_ops"]) == pytest.approx({"K6 GroupNorm fwd": 0.1, "K1 flash attention fwd": 0.2})
