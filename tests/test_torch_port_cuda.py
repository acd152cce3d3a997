"""The port's kernels against their plain versions on a CUDA device.

Marked ``cuda``: they skip without a card (the kernels have no CPU mode). This
file needs no jax, so it also runs on a GPU machine without it, where the
repository's conftest (which imports jax) is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

Tolerances on max-abs error, relative to max(1, max|plain|): float32 1e-5 for
attention and 5e-5 for GroupNorm (summation order); bfloat16 2e-2 (both sides
round their outputs to bf16, spacing 2^-7 of the magnitude). The backward
kernels: float32 5e-5 for attention (sums over up to 300 kv rows in another
order) and 1e-4 for GroupNorm (two reductions over the map); bfloat16 2e-2 as
above. Both attention backward routes, K3 (dQ added over kv blocks in a fixed
order) and the split set (K4/K5), sum in a fixed order and are also held to
bit-identical results from two launches; in bf16 their delta is the stats
pass's f32 sum of P * dP, so correlated inputs whose keys share a large
component (dO = Q, V = K) are held to the plain version too. GroupNorm's
forward (K6), its concat form (K8) and its backward (K7) are each one device
kernel per call, on resident and streaming plans (``gn_launch_plan``); K7
and K8 also give the same bits from two launches. The int8 Adam
update (K9) repeats its plain version's IEEE operations in the same order:
one leaf's update at rtol 1e-6 (atol 1e-7) in f32 and within one bf16 ulp
(rtol 2^-8) in bf16, at most one code in 10^4 one step apart (a value on a
rounding boundary), dequantized moments at rtol 1e-5 / atol 1e-8 elsewhere;
the whole step (clip, K9 and apply in one launch over every leaf) gives
``adam8bit_step_plain``'s parameters, codes and scales bit for bit, with one
device kernel per step. The trainers' graphs (tiny, cuDNN deterministic):
each optimizer step and each evaluation signature replayed at
``--steps-per-dispatch`` 1 and 2 gives the eager trainer's losses,
evaluation losses and parameters bit for bit; a window the graph cannot
take runs eagerly. The text encoder's graphs give the eager tower's bits.
The sampling loop's graphs (a tiny model, cuDNN deterministic): each signature's warm-up and its replays give the eager
loop's x_0 bit for bit, the capture's tally its launches, A-B-A each its
own, a replay after an in-place weight load the new weights' render; a
changed input, a moved parameter and a loop that syncs with the host
raise.

bfloat16 attention runs on the tensor-core (wgmma) kernels and float32 on the
FMA kernels; the bf16 tests check which one each launch reports and hold the
wgmma kernels to the same 2e-2 (they round P and dS to bf16 before their
products, where the TPU kernels do; the plain versions keep them f32), and
to their rounding model (``tests/torch_attention_bf16_model.py``) within
1e-2 of each output's own magnitude, one bf16 ulp. The row log-sum-exp of
the bf16 forward is held to 1e-3 absolute (base-2 units): f32 sums of bf16
products in another order.
"""

import functools
import json

import pytest

torch = pytest.importorskip("torch")

from stable_diffusion_pytorch_tpu_torch.ops import native  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.ops.adam8bit_update import (  # noqa: E402
    Adam8bitStep,
    adam8bit_plan,
    adam8bit_step_plain,
    adam8bit_update,
    adam8bit_update_plain,
    dequantize,
    quantize,
)
from stable_diffusion_pytorch_tpu_torch.ops.flash_attention import (  # noqa: E402
    _forward_kernel,
    flash_attention,
    backward_route,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_bwd_split,
    flash_attention_plain,
)
from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import (  # noqa: E402
    _forward,
    fused_group_norm,
    fused_group_norm_cat,
    gn_launch_plan,
    group_norm_bwd,
    group_norm_bwd_plain,
)
from stable_diffusion_pytorch_tpu_torch.ops.groupnorm import (  # noqa: E402
    xla_group_norm,
    xla_group_norm_cat,
)
from torch_attention_bf16_model import model_backward, model_forward, own_scale_err  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {"float32": (1e-5, 5e-5), "bfloat16": (2e-2, 2e-2)}
BWD_TOL = {"float32": (5e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
# the bf16 kernels against their rounding model, of each output's own scale:
# one bf16 ulp at the largest output (2^-8 to 2^-7 of it), and no more
MODEL_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max().clamp(min=1.0)).item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_plain(cuda, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    for b, n, m, h, d in [(2, 200, 77, 8, 40), (2, 256, 256, 8, 160), (1, 64, 64, 1, 128), (1, 33, 300, 2, 80),
                          (1, 100, 130, 1, 512)]:
        q, k, v = (torch.randn(b, s, h, d, device=cuda, generator=g).to(dt) for s in (n, m, m))
        assert _rel_err(flash_attention(q, k, v), flash_attention_plain(q, k, v, d ** -0.5)) <= TOL[dtype][0]


def test_flash_attention_takes_strided_qkv_views(cuda):
    """The fused-QKV split: q/k/v are views into one [B, N, 3*H*D] tensor."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 100, 3 * 4 * 40, device=cuda, generator=g)
    q, k, v = (t.view(2, 100, 4, 40) for t in qkv.split(160, dim=-1))
    assert not q.is_contiguous()
    assert _rel_err(flash_attention(q, k, v), flash_attention_plain(q, k, v, 40 ** -0.5)) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_kernels_match_plain(cuda, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(2)
    for shape, groups in [((2, 64, 960), 32), ((1, 8, 8, 128), 32), ((2, 17, 40), 8)]:
        c = shape[-1]
        x = (torch.randn(*shape, device=cuda, generator=g) * 2 + 0.5).to(dt)
        w, bias = 1 + 0.3 * torch.randn(c, device=cuda, generator=g), 0.3 * torch.randn(c, device=cuda, generator=g)
        for silu in (False, True):
            out = fused_group_norm(x, w, bias, groups, 1e-5, silu)
            assert _rel_err(out, xla_group_norm(x, w, bias, groups, 1e-5, silu)) <= TOL[dtype][1]
            c1 = c * 2 // 3  # 640 | 320 of 960: the group of channels 630-659 straddles
            x1, x2 = x[..., :c1].contiguous(), x[..., c1:].contiguous()
            out = fused_group_norm_cat(x1, x2, w, bias, groups, 1e-5, silu)
            assert _rel_err(out, xla_group_norm_cat(x1, x2, w, bias, groups, 1e-5, silu)) <= TOL[dtype][1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_matches_plain(cuda, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(3)
    for b, n, m, h, d in [(2, 200, 77, 8, 40), (2, 256, 256, 8, 160), (1, 33, 300, 2, 80), (1, 70, 64, 1, 128)]:
        q, k, v, do = (torch.randn(b, s, h, d, device=cuda, generator=g).to(dt) for s in (n, m, m, n))
        out, lse = _forward_kernel(q, k, v, d ** -0.5, with_lse=True)
        grads = flash_attention_bwd(q, k, v, out, do, lse, d ** -0.5)
        refs = flash_attention_bwd_plain(q, k, v, do, d ** -0.5)
        for got, ref in zip(grads, refs):
            assert got.shape == ref.shape and got.dtype == ref.dtype
            assert _rel_err(got, ref) <= BWD_TOL[dtype][0], (b, n, m, h, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_split_matches_plain_and_repeats_bit_for_bit(cuda, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(6)
    for b, n, m, h, d in [(2, 200, 77, 8, 40), (2, 256, 256, 8, 160), (1, 33, 300, 2, 80), (1, 70, 64, 1, 128),
                          (1, 130, 10000, 2, 40)]:
        q, k, v, do = (torch.randn(b, s, h, d, device=cuda, generator=g).to(dt) for s in (n, m, m, n))
        out, lse = _forward_kernel(q, k, v, d ** -0.5, with_lse=True)
        grads = flash_attention_bwd_split(q, k, v, out, do, lse, d ** -0.5)
        again = flash_attention_bwd_split(q, k, v, out, do, lse, d ** -0.5)
        refs = flash_attention_bwd_plain(q, k, v, do, d ** -0.5)
        for got, rep, ref in zip(grads, again, refs):
            assert got.shape == ref.shape and got.dtype == ref.dtype
            assert torch.equal(got, rep), (b, n, m, h, d)
            assert _rel_err(got, ref) <= BWD_TOL[dtype][0], (b, n, m, h, d)


@pytest.mark.parametrize("d", [40, 80, 160, 512])
def test_bf16_forward_runs_the_tensor_core_kernel(cuda, d):
    """The wgmma forward against its plain version: ragged q lengths (not a
    multiple of the 64-row block), kv of 77 (cross-attention) and ragged kv
    past one tile; the launch reports the tensor-core implementation."""
    g = torch.Generator(device=cuda).manual_seed(10 + d)
    for b, n, m, h in [(2, 200, 77, 2), (1, 130, 300, 2), (1, 33, 1000, 1)]:
        q, k, v = (torch.randn(b, s, h, d, device=cuda, generator=g).bfloat16() for s in (n, m, m))
        native.reset_counters()
        out, lse = _forward_kernel(q, k, v, d ** -0.5, with_lse=True)
        assert dict(native.COUNTERS["flash_attention"].impls) == {"wgmma": 1}
        assert _rel_err(out, flash_attention_plain(q, k, v, d ** -0.5)) <= TOL["bfloat16"][0], (b, n, m, h, d)
        s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * d ** -0.5
        # lse2 = log2(sum exp2(s * log2 e)); f32 scores from bf16 inputs, summed in another order
        assert (lse - torch.logsumexp(s, -1) * 1.4426950408889634).abs().max().item() <= 1e-3


def test_bf16_forward_takes_strided_qkv_views(cuda):
    """The fused-QKV split in bf16: 16-byte-aligned views with a contiguous
    head dim go to the tensor-core kernel as they are."""
    g = torch.Generator(device=cuda).manual_seed(11)
    qkv = torch.randn(2, 100, 3 * 4 * 40, device=cuda, generator=g).bfloat16()
    q, k, v = (t.view(2, 100, 4, 40) for t in qkv.split(160, dim=-1))
    assert not q.is_contiguous()
    native.reset_counters()
    assert _rel_err(flash_attention(q, k, v), flash_attention_plain(q, k, v, 40 ** -0.5)) <= TOL["bfloat16"][0]
    assert dict(native.COUNTERS["flash_attention"].impls) == {"wgmma": 1}


@pytest.mark.parametrize("d", [40, 80, 160, 512])
def test_bf16_split_backward_runs_the_tensor_core_kernels(cuda, d):
    """The wgmma split backward against its plain version at ragged q and kv
    lengths (77, past one tile), bit-identical across two launches."""
    g = torch.Generator(device=cuda).manual_seed(20 + d)
    for b, n, m, h in [(2, 200, 77, 2), (1, 70, 300, 2), (1, 130, 1000, 1)]:
        q, k, v, do = (torch.randn(b, s, h, d, device=cuda, generator=g).bfloat16() for s in (n, m, m, n))
        out, lse = _forward_kernel(q, k, v, d ** -0.5, with_lse=True)
        native.reset_counters()
        grads = flash_attention_bwd_split(q, k, v, out, do, lse, d ** -0.5)
        again = flash_attention_bwd_split(q, k, v, out, do, lse, d ** -0.5)
        assert dict(native.COUNTERS["flash_attention_bwd_split"].impls) == {"wgmma": 2}
        for got, rep, ref in zip(grads, again, flash_attention_bwd_plain(q, k, v, do, d ** -0.5)):
            assert got.shape == ref.shape and got.dtype == ref.dtype == torch.bfloat16
            assert torch.equal(got, rep), (b, n, m, h, d)
            assert _rel_err(got, ref) <= BWD_TOL["bfloat16"][0], (b, n, m, h, d)


def test_dtype_picks_the_implementation(cuda):
    """f32 runs the FMA kernels, bf16 the tensor-core ones, as each launch reports."""
    g = torch.Generator(device=cuda).manual_seed(12)
    for dtype, impl in ((torch.float32, "fma"), (torch.bfloat16, "wgmma")):
        q, k, v, do = (torch.randn(1, 96, 2, 40, device=cuda, generator=g).to(dtype) for _ in range(4))
        native.reset_counters()
        out, lse = _forward_kernel(q, k, v, 0.2, with_lse=True)
        flash_attention_bwd_split(q, k, v, out, do, lse, 0.2)
        assert dict(native.COUNTERS["flash_attention"].impls) == {impl: 1}
        assert dict(native.COUNTERS["flash_attention_bwd_split"].impls) == {impl: 1}


@pytest.mark.parametrize("d", [20, 33, 36, 100])
def test_bf16_kernels_take_any_head_dim_and_view(cuda, d):
    """Head dims that are not a multiple of 8 (33: nor of 4, so K3 adds its dQ
    shares one element at a time): contiguous multi-head tensors,
    whose rows do not start 16-byte aligned (copied element by element), and
    a view into a tensor padded to a multiple of 8 (16-byte copies that
    zero-fill a short last chunk); also views 8 bytes past alignment, with
    their own data and correlated (dO = Q, V = K). Each is held to the
    rounding model of ``tests/torch_attention_bf16_model.py``, fed the
    kernel's own output and lse, within ``MODEL_TOL``, and to the plain
    versions within the chip's 2e-2, on both backward routes."""
    g = torch.Generator(device=cuda).manual_seed(30 + d)
    pad = -(-d // 8) * 8
    contiguous = [torch.randn(1, s, 3, d, device=cuda, generator=g).bfloat16() for s in (70, 130, 130, 70)]
    padded = [torch.randn(2, s, 2, pad, device=cuda, generator=g).bfloat16()[..., :d] for s in (70, 130, 130, 70)]
    shifted = [torch.randn(1, s, 2 * d + 4, device=cuda, generator=g).bfloat16()[..., 4:].view(1, s, 2, d)
               for s in (70, 130, 130, 70)]
    correlated = [shifted[0], shifted[1], shifted[1], shifted[0]]
    scale = d ** -0.5
    for q, k, v, do in (contiguous, padded, shifted, correlated):
        out, lse = _forward_kernel(q, k, v, scale, with_lse=True)
        cq, ck, cv, cdo, cout, clse = (t.cpu() for t in (q, k, v, do, out, lse))
        assert own_scale_err(cout, model_forward(cq, ck, cv, scale)[0]) <= MODEL_TOL, d
        assert _rel_err(out, flash_attention_plain(q, k, v, scale)) <= TOL["bfloat16"][0], d
        refs = flash_attention_bwd_plain(q, k, v, do, scale)
        for bwd in (flash_attention_bwd_split, flash_attention_bwd):
            grads = bwd(q, k, v, out, do, lse, scale)
            for got, want in zip(grads, model_backward(cq, ck, cv, cout, cdo, clse, scale)):
                assert own_scale_err(got.cpu(), want) <= MODEL_TOL, (bwd.__name__, d)
            for got, ref in zip(grads, refs):
                assert _rel_err(got, ref) <= BWD_TOL["bfloat16"][0], (bwd.__name__, d)


def test_kv_past_the_crossover_runs_k1_and_the_split_backward(cuda):
    """K1 and the Function at 10000 kv tokens (past the 9216 crossover): the
    backward routes to the split kernels."""
    assert backward_route(10000) == "split" and backward_route(4096) == "fused"
    assert backward_route(4096, dtype=torch.bfloat16) == "split"
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(1, 96, 2, 40, device=cuda, generator=g)
    kv = torch.randn(1, 10000, 2, 80, device=cuda, generator=g)
    assert _rel_err(flash_attention(q, kv[..., :40], kv[..., 40:]),
                    flash_attention_plain(q, kv[..., :40], kv[..., 40:], 40 ** -0.5)) <= TOL["float32"][0]
    w = torch.randn(1, 96, 2, 40, device=cuda, generator=g)
    native.reset_counters()
    grads = []
    for fn in (flash_attention, lambda q, k, v: flash_attention_plain(q, k, v, 40 ** -0.5)):
        leaves = [t.clone().requires_grad_(True) for t in (q, kv)]
        (fn(leaves[0], leaves[1][..., :40], leaves[1][..., 40:]) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    assert native.COUNTERS["flash_attention_bwd_split"].count == 1
    assert native.COUNTERS["flash_attention_bwd"].count == 0
    for got, ref in zip(*grads):
        assert _rel_err(got, ref) <= BWD_TOL["float32"][0]


def test_flash_attention_function_gradients(cuda):
    """Autograd through the Function (K1 + K3) against autograd through the
    plain forward, on strided fused-QKV views as the model hands them."""
    g = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn(2, 96, 3 * 2 * 40, device=cuda, generator=g)
    w = torch.randn(2, 96, 2, 40, device=cuda, generator=g)
    grads = []
    for fn in (flash_attention, lambda q, k, v: flash_attention_plain(q, k, v, 40 ** -0.5)):
        leaf = qkv.clone().requires_grad_(True)
        q, k, v = (t.view(2, 96, 2, 40) for t in leaf.split(80, dim=-1))
        (fn(q, k, v) * w).sum().backward()
        grads.append(leaf.grad)
    assert _rel_err(grads[0], grads[1]) <= BWD_TOL["float32"][0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_bwd_matches_plain(cuda, dtype):
    """K7 through the Functions (single and concat, straddling group) against
    the plain backward, and the concat's gradients against autograd through
    the plain concat forward, on resident plans and a streaming one (x and dy
    read twice); two launches on the same inputs give the same bits."""
    dt = getattr(torch, dtype)
    elem = torch.empty((), dtype=dt).element_size()
    g = torch.Generator(device=cuda).manual_seed(5)
    kinds = set()
    for shape, groups in [((2, 64, 960), 32), ((1, 8, 8, 128), 32), ((2, 17, 40), 8), ((1, 70000, 64), 32)]:
        c = shape[-1]
        rows = shape[1] * (shape[2] if len(shape) == 4 else 1)
        kinds.add(gn_launch_plan(shape[0], rows, c, groups, elem, inputs=2).resident)
        x = (torch.randn(*shape, device=cuda, generator=g) * 2 + 0.5).to(dt)
        w, bias = 1 + 0.3 * torch.randn(c, device=cuda, generator=g), 0.3 * torch.randn(c, device=cuda, generator=g)
        dy = torch.randn(*shape, device=cuda, generator=g).to(dt)
        c1 = c * 2 // 3
        for silu in (False, True):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
            fused_group_norm(*leaves, groups, 1e-5, silu).backward(dy)
            (dx_ref,), dw_ref, db_ref = group_norm_bwd_plain([x], dy, w, bias, groups, 1e-5, silu)
            for t, ref in zip(leaves, (dx_ref, dw_ref, db_ref)):
                assert _rel_err(t.grad, ref) <= BWD_TOL[dtype][1], (shape, silu)
            parts = [x[..., :c1].contiguous(), x[..., c1:].contiguous()]
            leaves = [t.clone().requires_grad_(True) for t in (*parts, w, bias)]
            fused_group_norm_cat(*leaves, groups, 1e-5, silu).backward(dy)
            refs = [t.clone().float().requires_grad_(True) for t in (*parts, w, bias)]
            xla_group_norm_cat(*refs, groups, 1e-5, silu).backward(dy.float())
            for t, ref in zip(leaves, refs):
                assert _rel_err(t.grad, ref.grad) <= BWD_TOL[dtype][1], (shape, silu, "cat")
            for ps in ([x], parts):
                _, mean, rstd = _forward(ps[0], ps[1] if len(ps) > 1 else None, w, bias, groups, 1e-5, silu)
                first = group_norm_bwd(ps, dy, w, bias, mean, rstd, groups, 1e-5, silu)
                again = group_norm_bwd(ps, dy, w, bias, mean, rstd, groups, 1e-5, silu)
                assert all(torch.equal(a, b) for a, b in zip((*first[0], *first[1:]), (*again[0], *again[1:])))
    assert kinds == {True, False}, kinds


def test_cuda_tensors_count_launches_and_reject_bad_input(cuda):
    native.reset_counters()
    q = torch.randn(1, 16, 2, 40, device=cuda)
    flash_attention(q, q, q)
    x = torch.randn(1, 16, 64, device=cuda)
    w = torch.ones(64, device=cuda)
    fused_group_norm(x, w, w, 8)
    fused_group_norm_cat(x, x, torch.ones(128, device=cuda), torch.ones(128, device=cuda), 8)
    assert {k: c.count for k, c in native.COUNTERS.items()} == {
        "flash_attention": 1, "flash_attention_bwd": 0, "flash_attention_bwd_split": 0, "group_norm": 1,
        "group_norm_cat": 1, "group_norm_bwd": 0, "adam8bit_update": 0,
    }
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        fused_group_norm(x[..., ::2], w[:32], w[:32], 8)  # not contiguous
    with pytest.raises(ValueError):
        fused_group_norm(x, w.bfloat16(), w, 8)  # affine params must be f32
    assert native.COUNTERS["flash_attention"].count == 1


def test_train_step_on_cuda_runs_the_backward_kernels(cuda, tmp_path):
    """A tiny UNet train step on the card in bf16 over f32 parameters: finite
    loss, every parameter updated, K1, the split backward (bf16's route at
    every kv length) and K6/K7/K8 launched."""
    from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig, ClipConfig, DDPMConfig, UnetConfig
    from stable_diffusion_pytorch_tpu_torch.models.build import build_models
    from stable_diffusion_pytorch_tpu_torch.trainers.optim import AdamW, build_lr_schedule
    from stable_diffusion_pytorch_tpu_torch.trainers.steps import TrainState, make_unet_train_step, sample_draws

    model = build_models(
        UnetConfig(channels_list=[32, 64], n_heads=4, time_emb_dim=64, n_layers=1, context_dim=768),
        AutoencoderConfig(autoencoder_channels_list=[16, 32], groups=8), ClipConfig(model_dir=None), DDPMConfig(),
        dtype=torch.bfloat16, device=cuda, seed=0, for_training=True,
    )
    params = [p for p in model.unet.parameters()]
    with torch.no_grad():  # the zero-initialized layers would pass no gradient to the layers before them
        for p in params:
            if p.dim() > 1 and not p.any():
                p.normal_(0.0, 0.02)
    before = [p.detach().clone() for p in params]
    state = TrainState(model.unet, AdamW(params, build_lr_schedule("constant", 1e-3, 0, 10), max_grad_norm=1.0))
    train_step, _ = make_unet_train_step(model.unet, model.text_encoder.module, model.autoencoder,
                                         model.noise_scheduler, compute_dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {"pixel_values": torch.rand(2, 32, 32, 3, device=cuda, generator=g) * 2 - 1,
             "input_ids": torch.randint(0, 49408, (2, 77), device=cuda, generator=g)}
    uncond = torch.tensor(model.text_encoder.tokenize([""]).input_ids[0], device=cuda)
    native.reset_counters()
    metrics = train_step(state, batch, uncond, sample_draws(g, 2, (2, 16, 16, 4), 1000, cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    unchanged = [n for (n, _), a, b in zip(model.unet.named_parameters(), before, params) if torch.equal(a, b)]
    assert not unchanged, unchanged
    counts = {k: c.count for k, c in native.COUNTERS.items()}
    assert all(counts[k] > 0 for k in ("flash_attention", "flash_attention_bwd_split", "group_norm",
                                       "group_norm_bwd", "group_norm_cat")), counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam8bit_update_matches_plain(cuda, dtype):
    """K9 at a sub-blocked conv, a one-block conv, a linear and 1-D leaves,
    from non-zero seeded state with step-3 bias corrections."""
    g_ = torch.Generator(device=cuda).manual_seed(0)
    bc1, bc2 = float(torch.tensor(1 - 0.9 ** 3)), float(torch.tensor(1 - 0.999 ** 3))
    native.reset_counters()
    for shape in [(1280, 640, 3, 3), (320, 4, 3, 3), (640, 768), (1280,), (320,)]:
        g = (torch.randn(shape, device=cuda, generator=g_) * 0.02).to(getattr(torch, dtype))
        mu = quantize(torch.randn(shape, device=cuda, generator=g_) * 0.01, 256)
        nu = quantize(torch.randn(shape, device=cuda, generator=g_).abs().mul(1e-4).sqrt(), 256)
        upd, nmu, nnu = adam8bit_update(g, mu, nu, bc1, bc2)
        r_upd, r_mu, r_nu = adam8bit_update_plain(g, mu, nu, bc1, bc2, 0.9, 0.999, 1e-8, 256)
        torch.cuda.synchronize()
        assert upd.dtype == g.dtype and nmu[0].dtype == torch.int8 and nmu[1].shape == mu[1].shape
        torch.testing.assert_close(upd.float(), r_upd.float(), rtol=1e-6 if dtype == "float32" else 2.0 ** -8,
                                   atol=1e-7, msg=lambda m: f"{shape}: {m}")
        for ours, ref in ((nmu, r_mu), (nnu, r_nu)):
            diff = (ours[0].int() - ref[0].int()).abs()
            assert diff.max() <= 1 and int((diff > 0).sum()) <= max(1, ours[0].numel() // 10 ** 4), (
                shape, int(diff.max()), int((diff > 0).sum()))
            got, want = dequantize(*ours), dequantize(*ref)
            assert (((got - want).abs() <= 1e-8 + 1e-5 * want.abs()) | (diff > 0)).all(), shape
    assert native.COUNTERS["adam8bit_update"].count == 5
    with pytest.raises(ValueError):
        adam8bit_update(g, (mu[0].float(), mu[1]), nu, bc1, bc2)


def test_lean_train_step_on_cuda_runs_k9_per_leaf(cuda):
    """A tiny UNet accumulated over 2 micro steps with int8 Adam, a bf16
    accumulator and conv-save remat on the card: finite loss, every parameter
    updated, K9 launched once for the optimizer step (every leaf, the clip
    and the apply in the launch), the UNet kernels launched."""
    from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig, ClipConfig, DDPMConfig, UnetConfig
    from stable_diffusion_pytorch_tpu_torch.models.build import build_models
    from stable_diffusion_pytorch_tpu_torch.trainers.adam8bit import AdamW8bit
    from stable_diffusion_pytorch_tpu_torch.trainers.optim import build_lr_schedule
    from stable_diffusion_pytorch_tpu_torch.trainers.steps import TrainState, make_unet_train_step, sample_draws

    model = build_models(
        UnetConfig(channels_list=[32, 64], n_heads=4, time_emb_dim=64, n_layers=1, context_dim=768),
        AutoencoderConfig(autoencoder_channels_list=[16, 32], groups=8), ClipConfig(model_dir=None), DDPMConfig(),
        dtype=torch.bfloat16, device=cuda, seed=0, for_training=True, remat="conv-save",
    )
    params = [p for p in model.unet.parameters()]
    with torch.no_grad():
        for p in params:
            if p.dim() > 1 and not p.any():
                p.normal_(0.0, 0.02)
    before = [p.detach().clone() for p in params]
    opt = AdamW8bit(params, build_lr_schedule("constant", 1e-3, 0, 10), max_grad_norm=1.0, accum_steps=2,
                    acc_dtype=torch.bfloat16)
    state = TrainState(model.unet, opt)
    train_step, _ = make_unet_train_step(model.unet, model.text_encoder.module, model.autoencoder,
                                         model.noise_scheduler, compute_dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {"pixel_values": torch.rand(2, 32, 32, 3, device=cuda, generator=g) * 2 - 1,
             "input_ids": torch.randint(0, 49408, (2, 77), device=cuda, generator=g)}
    uncond = torch.tensor(model.text_encoder.tokenize([""]).input_ids[0], device=cuda)
    native.reset_counters()
    for _ in range(2):
        metrics = train_step(state, batch, uncond, sample_draws(g, 2, (2, 16, 16, 4), 1000, cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"]) and opt.count == 1
    unchanged = [n for (n, _), a, b in zip(model.unet.named_parameters(), before, params) if torch.equal(a, b)]
    assert not unchanged, unchanged
    counts = {k: c.count for k, c in native.COUNTERS.items()}
    assert counts["adam8bit_update"] == 1, counts
    assert all(counts[k] > 0 for k in ("flash_attention", "flash_attention_bwd_split", "group_norm",
                                       "group_norm_bwd", "group_norm_cat")), counts


# leaves of every kind of work item (adam8bit_plan): 1-D on the row mapping
# (one sub-blocked, one tall block), column runs of 32, 16, 8 and 512 columns
# (a channels_last conv among them; 33 columns end in a run of one), and two
# blocks too tall to hold, which recompute (a 2-D leaf and a 1-D one)
ADAM_STEP_SHAPES = [(1280,), (960,), (1280, 40), (320, 64, 3, 3), (640, 96), (4, 320, 3, 3), (640, 33), (2000, 64),
                    (9000,)]


def _adam_step_leaves(dev, dtype, seed):
    g_ = torch.Generator(device=dev).manual_seed(seed)
    params, grads, mu, nu = [], [], [], []
    for shape in ADAM_STEP_SHAPES:
        fmt = torch.channels_last if len(shape) == 4 else torch.contiguous_format

        def t(scale):
            return (torch.randn(shape, device=dev, generator=g_) * scale).contiguous(memory_format=fmt)

        params.append(t(0.3))
        grads.append(t(0.02).to(dtype).contiguous(memory_format=fmt))
        for store, x in ((mu, t(0.01)), (nu, t(1e-4).abs().sqrt())):
            q, sc = quantize(x, 256)
            store.append((q.contiguous(memory_format=fmt), sc.contiguous(memory_format=fmt)))
    return params, grads, mu, nu


def _copies(params, mu, nu):
    return [p.clone() for p in params], [tuple(x.clone() for x in m) for m in mu], [tuple(x.clone() for x in n)
                                                                                    for n in nu]


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam8bit_step_matches_plain_bit_for_bit(cuda, dtype, clip):
    """The fused step (clip, K9, apply; one launch) against adam8bit_step_plain
    on the card, from non-zero state at step 3, twice in a row: parameters,
    codes and scales equal bit for bit, one device kernel a step."""
    from stable_diffusion_pytorch_tpu_torch.trainers.optim import global_norm

    params, grads, mu, nu = _adam_step_leaves(cuda, getattr(torch, dtype), 3)
    plan = adam8bit_plan([p.shape for p in params], 256)
    assert {leaf.one_pass for leaf in plan.leaves} == {True, False}
    norm = global_norm(grads)
    max_norm = float(norm) * (0.5 if clip else 2.0)
    bc = [(float(torch.tensor(1 - b1 ** k)), float(torch.tensor(1 - 0.999 ** k))) for b1, k in ((0.9, 3), (0.9, 4))]
    fused, plain = _copies(params, mu, nu), _copies(params, mu, nu)
    step = Adam8bitStep(*fused, 256)
    table = step._table
    native.reset_counters()
    for bc1, bc2 in bc:
        step(grads, norm, bc1, bc2, 1e-3, weight_decay=0.1, max_grad_norm=max_norm)
        adam8bit_step_plain(*plain[:1], grads, *plain[1:], norm, bc1, bc2, 1e-3, 0.9, 0.999, 1e-8, 0.1, max_norm, 256)
    torch.cuda.synchronize()
    assert step._table is table  # built once: the state was updated in place
    assert native.COUNTERS["adam8bit_update"].count == 2
    for name, a, b in (("params", fused[0], plain[0]), ("mu", fused[1], plain[1]), ("nu", fused[2], plain[2])):
        for shape, x, y in zip(ADAM_STEP_SHAPES, a, b):
            for u, v in ([(x, y)] if name == "params" else zip(x, y)):
                assert torch.equal(u, v), (name, shape, (u.float() - v.float()).abs().max().item())
    assert not torch.equal(fused[0][0], params[0])
    kernels = _device_kernels(lambda: step(grads, norm, *bc[0], 1e-3, weight_decay=0.1, max_grad_norm=max_norm))
    launched = {k: n for k, n in kernels.items() if not k.startswith("Memcpy")}  # the step's one upload aside
    assert len(launched) == 1 and "adam8bit_step_kernel" in next(iter(launched)), kernels
    assert sum(launched.values()) == 1 == native.COUNTERS["adam8bit_update"].count, kernels


def test_adam8bit_step_rejects_what_its_table_does_not_describe(cuda):
    params, grads, mu, nu = _adam_step_leaves(cuda, torch.float32, 4)
    step = Adam8bitStep(params, mu, nu, 256)
    norm = torch.ones((), device=cuda)
    native.reset_counters()
    bad_grads = [
        [g.cpu() if i == 2 else g for i, g in enumerate(grads)],                 # mixed devices
        [g.bfloat16() if i == 1 else g for i, g in enumerate(grads)],            # mixed dtypes
        [g.contiguous() if g.dim() == 4 else g for g in grads],                  # another layout
        [g.half() for g in grads],                                               # not f32 or bf16
        grads[:-1],                                                              # a leaf short
    ]
    for bad in bad_grads:
        with pytest.raises((TypeError, ValueError)):
            step(bad, norm, 0.1, 0.01, 1e-3, max_grad_norm=1.0)
    with pytest.raises(ValueError):
        step(grads, norm.double(), 0.1, 0.01, 1e-3, max_grad_norm=1.0)  # the norm not f32
    with pytest.raises(ValueError):
        Adam8bitStep(params, [(q.float(), s) if i == 0 else (q, s) for i, (q, s) in enumerate(mu)], nu, 256)
    with pytest.raises(ValueError):
        Adam8bitStep(params, mu, [(q, s.cpu()) if i == 3 else (q, s) for i, (q, s) in enumerate(nu)], 256)
    assert native.COUNTERS["adam8bit_update"].count == 0
    step(grads, norm, 0.1, 0.01, 1e-3, max_grad_norm=1.0)
    assert native.COUNTERS["adam8bit_update"].count == 1


def _shared_key_views(g, n, m, h, d, dev):
    """dO = Q, V = K, keys sharing one component of size 3 (as in
    ``tests/test_torch_port_attention_bf16.py``): dS = P (dP - delta) cancels
    hard, and dQ = scale * dS K cancels the shared component exactly."""
    q = torch.randn(1, n, h, d, device=dev, generator=g).bfloat16()
    shared = 3.0 * torch.randn(1, 1, h, d, device=dev, generator=g)
    k = (shared + torch.randn(1, m, h, d, device=dev, generator=g)).bfloat16()
    return q, k, k, q


@pytest.mark.parametrize("d", [40, 80, 160, 512])
def test_both_backward_routes_hold_correlated_views(cuda, d):
    """K3 and the split set at keys sharing a component of 3 (dO = Q, V = K):
    with the stats pass's f32 delta both stay within the bf16 tolerance of
    the plain version, of each output's own scale, and run wgmma."""
    g = torch.Generator(device=cuda).manual_seed(40 + d)
    for n, m in [(128, 1024), (70, 300)]:
        q, k, v, do = _shared_key_views(g, n, m, 2, d, cuda)
        scale = d ** -0.5
        out, lse = _forward_kernel(q, k, v, scale, with_lse=True)
        refs = flash_attention_bwd_plain(q, k, v, do, scale)
        native.reset_counters()
        for bwd in (flash_attention_bwd, flash_attention_bwd_split):
            for got, ref in zip(bwd(q, k, v, out, do, lse, scale), refs):
                assert own_scale_err(got, ref) <= BWD_TOL["bfloat16"][0], (bwd.__name__, n, m, d)
        assert dict(native.COUNTERS["flash_attention_bwd"].impls) == {"wgmma": 1}
        assert dict(native.COUNTERS["flash_attention_bwd_split"].impls) == {"wgmma": 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_repeats_bit_for_bit(cuda, dtype):
    """K3 adds dQ over kv blocks in a fixed order (no unordered atomics): two launches
    on the same inputs give the same bits, at several kv blocks, ragged q and
    kv lengths and every head-dim tiling; f32 runs the FMA kernel, bf16 wgmma."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(50)
    for b, n, m, h, d in [(2, 200, 77, 2, 40), (1, 130, 1000, 2, 80), (1, 300, 700, 1, 160), (1, 64, 4096, 2, 40)]:
        q, k, v, do = (torch.randn(b, s, h, d, device=cuda, generator=g).to(dt) for s in (n, m, m, n))
        out, lse = _forward_kernel(q, k, v, d ** -0.5, with_lse=True)
        native.reset_counters()
        grads = flash_attention_bwd(q, k, v, out, do, lse, d ** -0.5)
        again = flash_attention_bwd(q, k, v, out, do, lse, d ** -0.5)
        want = "fma" if dtype == "float32" else "wgmma"
        assert dict(native.COUNTERS["flash_attention_bwd"].impls) == {want: 2}
        for got, rep, ref in zip(grads, again, flash_attention_bwd_plain(q, k, v, do, d ** -0.5)):
            assert torch.equal(got, rep), (b, n, m, h, d)
            assert _rel_err(got, ref) <= BWD_TOL[dtype][0], (b, n, m, h, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_at_the_vae_training_shapes(cuda, dtype):
    """K6 and K7 at the SD-1.5 VAE's training maps: 4 channels a group at the
    256px top level (streamed), 16 at the 32x32 bottleneck, and 2 groups of
    256 channels (the first bottleneck ResBlock under
    ``bottleneck_default_groups``), with SiLU, against the plain versions;
    one launch each, two backward launches bit-identical."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(80)
    for shape, groups in [((4, 65536, 128), 32), ((4, 1024, 512), 32), ((4, 1024, 512), 2), ((1, 64, 512), 2)]:
        c = shape[-1]
        x = (torch.randn(*shape, device=cuda, generator=g) * 2 + 0.5).to(dt)
        w, bias = 1 + 0.3 * torch.randn(c, device=cuda, generator=g), 0.3 * torch.randn(c, device=cuda, generator=g)
        dy = torch.randn(*shape, device=cuda, generator=g).to(dt)
        native.reset_counters()
        out, mean, rstd = _forward(x, None, w, bias, groups, 1e-5, True)
        assert _rel_err(out, xla_group_norm(x, w, bias, groups, 1e-5, True)) <= TOL[dtype][1], (shape, groups)
        first = group_norm_bwd([x], dy, w, bias, mean, rstd, groups, 1e-5, True)
        again = group_norm_bwd([x], dy, w, bias, mean, rstd, groups, 1e-5, True)
        (dx_ref,), dw_ref, db_ref = group_norm_bwd_plain([x], dy, w, bias, groups, 1e-5, True)
        for got, rep, ref in zip((first[0][0], *first[1:]), (again[0][0], *again[1:]), (dx_ref, dw_ref, db_ref)):
            assert torch.equal(got, rep), (shape, groups)
            assert _rel_err(got, ref) <= BWD_TOL[dtype][1], (shape, groups)
        assert native.COUNTERS["group_norm"].count == 1 and native.COUNTERS["group_norm_bwd"].count == 2


@pytest.mark.parametrize("route", ["split", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_d512_backward_matches_plain_and_repeats_bit_for_bit(cuda, dtype, route):
    """The VAE's single 512-wide head on both backward routes: each output
    against the plain version, two launches bit-identical (the column parts
    of K3's kernels each keep their ordered dQ adds), at one kv tile, ragged
    q and kv lengths and several kv blocks; f32 runs FMA, bf16 wgmma."""
    dt = getattr(torch, dtype)
    bwd = flash_attention_bwd_split if route == "split" else flash_attention_bwd
    name = "flash_attention_bwd_split" if route == "split" else "flash_attention_bwd"
    g = torch.Generator(device=cuda).manual_seed(70)
    for b, n, m, h in [(1, 64, 64, 1), (2, 200, 77, 1), (1, 130, 300, 2)]:
        q, k, v, do = (torch.randn(b, s, h, 512, device=cuda, generator=g).to(dt) for s in (n, m, m, n))
        out, lse = _forward_kernel(q, k, v, 512 ** -0.5, with_lse=True)
        native.reset_counters()
        grads = bwd(q, k, v, out, do, lse, 512 ** -0.5)
        again = bwd(q, k, v, out, do, lse, 512 ** -0.5)
        assert dict(native.COUNTERS[name].impls) == {"fma" if dtype == "float32" else "wgmma": 2}
        for got, rep, ref in zip(grads, again, flash_attention_bwd_plain(q, k, v, do, 512 ** -0.5)):
            assert got.shape == ref.shape and got.dtype == ref.dtype
            assert torch.equal(got, rep), (b, n, m, h)
            assert _rel_err(got, ref) <= BWD_TOL[dtype][0], (b, n, m, h)


def test_autoencoder_trainer_micro_step_on_cuda(cuda, tmp_path):
    """One micro step of the autoencoder trainer on the card (tiny VAE, bf16
    over f32 parameters): finite loss and parts, and K1, the split backward
    (the bottleneck's single head) and K6/K7 launched."""
    from stable_diffusion_pytorch_tpu_torch.scripts.train_autoencoder import build_trainer
    from stable_diffusion_pytorch_tpu_torch.trainers.trainer import step_generator

    trainer = build_trainer([
        "--device", "cuda", "--dataset", "synthetic", "--resolution", "32", "--train-batch-size", "2",
        "--eval-batch-size", "2", "--max-train-samples", "4", "--max-val-samples", "2", "--max-test-samples", "2",
        "--autoencoder-channels-list", "16,32", "--groups", "8", "--ckpt-dir", str(tmp_path / "ckpt"),
        "--logging-dir", str(tmp_path / "logs"), "--dataloader-num-workers", "0",
    ])
    batch = trainer._place_batch(next(iter(trainer.train_loader)))
    native.reset_counters()
    metrics = trainer._train_step(batch, step_generator(cuda, 0, 0, 0))
    torch.cuda.synchronize()
    assert all(torch.isfinite(torch.as_tensor(v)) for v in metrics.values()), metrics
    assert sorted(metrics) == ["grad_norm", "kl_loss", "loss", "recon_loss"]
    counts = {k: c.count for k, c in native.COUNTERS.items()}
    assert all(counts[k] > 0 for k in ("flash_attention", "flash_attention_bwd_split", "group_norm",
                                       "group_norm_bwd")), counts


def _device_kernels(fn, attempts=4):
    """{kernel name: launches} of the device work ``fn()`` queues, by
    torch.profiler: the fullest of up to ``attempts`` profiles (a profile
    now and then misses a kernel and never adds one), stopping at the first
    that saw any. The wrappers' launch counts are set to 0 before each
    attempt, so they count the calls of the profile kept."""
    from torch.profiler import ProfilerActivity, profile

    best = {}
    for _ in range(attempts):
        native.reset_counters()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if "cuda" in str(getattr(e, "device_type", "")).lower() and e.self_device_time_total > 0}
        if sum(kernels.values()) > sum(best.values()):
            best = kernels
        if best:
            break
    return best


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_is_one_cluster_launch(cuda, dtype):
    """K6 against its plain version on a resident plan (the rows stay in
    shared memory) and a streaming one (read twice), with and without SiLU,
    the statistics matching the plain version's; each call is one launch."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(60)
    elem = torch.empty((), dtype=dt).element_size()
    for shape, groups, resident in [((1, 4096, 320), 32, True), ((1, 300000, 64), 32, False),
                                    ((3, 7, 5, 40), 8, True)]:
        plan = gn_launch_plan(shape[0], shape[1] * (shape[2] if len(shape) == 4 else 1), shape[-1], groups, elem)
        assert plan.resident == resident, plan
        c = shape[-1]
        x = (torch.randn(*shape, device=cuda, generator=g) * 2 + 0.5).to(dt)
        w, bias = 1 + 0.3 * torch.randn(c, device=cuda, generator=g), 0.3 * torch.randn(c, device=cuda, generator=g)
        for silu in (False, True):
            native.reset_counters()
            kernels = _device_kernels(lambda: fused_group_norm(x, w, bias, groups, 1e-5, silu))
            assert len(kernels) == 1 and "gn_fwd_cluster" in next(iter(kernels)), kernels
            assert next(iter(kernels.values())) == 1 and native.COUNTERS["group_norm"].count == 1
            out = fused_group_norm(x, w, bias, groups, 1e-5, silu)
            assert _rel_err(out, xla_group_norm(x, w, bias, groups, 1e-5, silu)) <= TOL[dtype][1], (shape, silu)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_cat_and_bwd_are_one_cluster_launch(cuda, dtype):
    """K8 (the concat forward) and K7 (the backward, of one part and of two)
    against their plain versions on resident and streaming plans, with groups
    that straddle the parts (1280 + 640 in 32 groups: group 21 spans channels
    1260-1319); each call is one device kernel of its own name, and a repeat
    gives the same bits."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(70)
    elem = torch.empty((), dtype=dt).element_size()
    kinds = {"cat": set(), "bwd": set()}
    for b, rows, c1, c2, groups in [(2, 1024, 640, 320, 32), (2, 64, 1280, 640, 32), (1, 300000, 32, 32, 32),
                                    (1, 4096, 640, 320, 32), (3, 35, 26, 14, 8)]:
        c = c1 + c2
        kinds["cat"].add(gn_launch_plan(b, rows, c, groups, elem, split=c1).resident)
        kinds["bwd"].add(gn_launch_plan(b, rows, c, groups, elem, split=c1, inputs=2).resident)
        x = (torch.randn(b, rows, c1, device=cuda, generator=g) * 2 + 0.5).to(dt)
        s = (torch.randn(b, rows, c2, device=cuda, generator=g) * 3 - 1.0).to(dt)
        w, bias = 1 + 0.3 * torch.randn(c, device=cuda, generator=g), 0.3 * torch.randn(c, device=cuda, generator=g)
        dy = torch.randn(b, rows, c, device=cuda, generator=g).to(dt)
        for silu in (False, True):
            where = (b, rows, c1, c2, groups, silu)
            out = fused_group_norm_cat(x, s, w, bias, groups, 1e-5, silu)
            assert torch.equal(out, fused_group_norm_cat(x, s, w, bias, groups, 1e-5, silu)), where
            ref = xla_group_norm_cat(x, s, w, bias, groups, 1e-5, silu)
            assert _rel_err(out, ref) <= TOL[dtype][1], where
            native.reset_counters()
            kernels = _device_kernels(lambda: fused_group_norm_cat(x, s, w, bias, groups, 1e-5, silu))
            assert len(kernels) == 1 and "gn_cat_cluster" in next(iter(kernels)), kernels
            assert next(iter(kernels.values())) == 1 and native.COUNTERS["group_norm_cat"].count == 1
            for parts in ([x, s], [torch.cat([x, s], dim=-1)]):
                _, mean, rstd = _forward(parts[0], parts[1] if len(parts) > 1 else None, w, bias, groups, 1e-5, silu)
                call = functools.partial(group_norm_bwd, parts, dy, w, bias, mean, rstd, groups, 1e-5, silu)
                got, again = call(), call()
                flat = (*got[0], *got[1:])
                assert all(torch.equal(a, b) for a, b in zip(flat, (*again[0], *again[1:]))), where
                want = group_norm_bwd_plain(parts, dy, w, bias, groups, 1e-5, silu)
                for o, r in zip(flat, (*want[0], *want[1:])):
                    assert _rel_err(o, r) <= BWD_TOL[dtype][1], (where, len(parts))
                native.reset_counters()
                kernels = _device_kernels(call)
                assert len(kernels) == 1 and "gn_bwd_cluster" in next(iter(kernels)), kernels
                assert next(iter(kernels.values())) == 1 and native.COUNTERS["group_norm_bwd"].count == 1
    assert kinds == {"cat": {True, False}, "bwd": {True, False}}, kinds


def test_serve_path_on_cuda_launches_the_sampling_kernels(cuda):
    """The server on the card at a tiny width: every sampler answers a PNG
    over HTTP, two concurrent requests share a batch, and the sampling
    kernels (K1, K6, K8) were launched by the batcher thread."""
    import json
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from stable_diffusion_pytorch_tpu_torch.scripts import serve

    service, _ = serve.build_service([
        "--channels-list", "32,64", "--n-heads", "4", "--time-emb-dim", "64", "--n-layers", "1",
        "--autoencoder-channels-list", "16,32", "--groups", "8", "--noise-steps", "50",
        "--default-image-size", "32", "--default-steps", "3", "--max-batch", "4", "--batch-window-ms", "300",
        "--device", "cuda"])
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/txt2img"

    def post(payload):
        req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.read()

    try:
        native.reset_counters()
        for sampler in serve.SAMPLERS:
            status, body = post({"prompt": "a cat", "seed": 1, "sampler": sampler})
            assert status == 200 and body[:4] == b"\x89PNG", sampler
        before = service.batches_run
        results = []
        threads = [threading.Thread(target=lambda s=s: results.append(post({"prompt": "a dog", "seed": s})))
                   for s in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert len(results) == 2 and all(status == 200 for status, _ in results)
        assert service.batches_run - before == 1
        counts = {k: c.count for k, c in native.COUNTERS.items()}
        assert all(counts[k] > 0 for k in ("flash_attention", "group_norm", "group_norm_cat")), counts
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.stop()


TINY_TRAIN = ["--device", "cuda", "--dataset", "synthetic", "--resolution", "32", "--train-batch-size", "2",
              "--eval-batch-size", "2", "--max-train-samples", "8", "--max-val-samples", "3",
              "--gradient-accumulation-steps", "2", "--dataloader-num-workers", "0", "--channels-list", "32,64",
              "--n-heads", "4", "--time-emb-dim", "64", "--n-layers", "1", "--autoencoder-channels-list", "16,32",
              "--groups", "8"]


def _tiny_run(build_trainer, work, flags, capture=True):
    """Train a tiny trainer on the card (its evaluation loader keeping a
    short last batch) -> its losses, evaluation losses, parameters, launches
    (host and replays), graph and route."""
    trainer = build_trainer([*TINY_TRAIN, "--ckpt-dir", str(work / "ckpt"), "--logging-dir", str(work / "logs"),
                             *flags], capture=capture)
    trainer.eval_loader.drop_last = False
    native.reset_counters()
    trainer.train()
    torch.cuda.synchronize()
    with open(trainer.tracker.jsonl_path) as f:
        records = [json.loads(line) for line in f]
    return {"losses": [r["train_loss"] for r in records if "train_loss" in r],
            "eval": [r["eval_loss"] for r in records if "eval_loss" in r],
            "params": [p.detach().clone() for p in trainer.state.params],
            "launches": {k: c.count + c.replays for k, c in native.COUNTERS.items()},
            "graph": trainer._graph, "route": trainer._route, "graphs": dict(trainer._graphs.graphs)}


@pytest.mark.parametrize("lean", [False, True], ids=["adamw", "adamw8bit"])
def test_chained_dispatch_replays_the_step_as_a_cuda_graph(cuda, tmp_path, lean):
    """Each optimizer step on the card is one CUDA graph (tiny UNet trainer,
    bf16 over f32, accumulation 2, cuDNN deterministic), captured at the
    first and replayed, at ``--steps-per-dispatch`` 1 (JAX's ``_jit_step``)
    and 2: the losses and parameters equal the eager trainer's
    (``capture=False``) bit for bit; the capture's tally per replay equals
    the eager launches per optimizer step (K9 in it under int8 Adam, with
    the bf16 accumulator and conv-save remat)."""
    from stable_diffusion_pytorch_tpu_torch.scripts.train_unet import build_trainer

    torch.backends.cudnn.deterministic = True
    flags = ["--max-train-steps", "4", "--log-interval", "0",
             *(["--use-8bit-adam", "--accum-dtype", "bf16", "--remat-policy", "conv-save"] if lean else [])]
    eager = _tiny_run(build_trainer, tmp_path / "eager", flags, capture=False)
    assert eager["route"] is None and eager["graph"] is None and len(eager["losses"]) == 4
    kernels = ["flash_attention", "flash_attention_bwd_split", "group_norm", "group_norm_bwd", "group_norm_cat"]
    for spd in (1, 2):
        run = _tiny_run(build_trainer, tmp_path / str(spd), [*flags, "--steps-per-dispatch", str(spd)])
        assert run["route"] == "graph" and run["graph"] is not None
        assert run["losses"] == eager["losses"]
        assert all(torch.equal(a, b) for a, b in zip(run["params"], eager["params"]))
        tally = {k: sum(v.values()) for k, v in run["graph"].tally.items()}
        for k in kernels + (["adam8bit_update"] if lean else []):
            assert tally[k] * 4 == eager["launches"][k] == run["launches"][k], (k, tally, eager["launches"])


@pytest.mark.parametrize("kind", ["unet", "textual_inversion", "controlnet", "vae"])
def test_default_step_and_evaluation_replay_bit_for_bit(cuda, tmp_path, kind):
    """Each trainer at ``--steps-per-dispatch 1`` on the card (tiny, cuDNN
    deterministic, 3 optimizer steps at accumulation 2 over 8 rows: the
    epoch's 4 micro batches hold two windows, so step 3's window is the
    next epoch's): losses, evaluation losses and parameters equal the eager
    trainer's bit for bit. The evaluation step is one graph per batch
    signature: 3 rows at batch 2 give a batch of 2 and a last batch of 1
    (the loader set to keep it)."""
    import importlib

    script = {"unet": "train_unet", "textual_inversion": "train_textual_inversion",
              "controlnet": "train_controlnet", "vae": "train_autoencoder"}[kind]
    build_trainer = importlib.import_module(f"stable_diffusion_pytorch_tpu_torch.scripts.{script}").build_trainer
    extra = {"textual_inversion": ["--placeholder-token", "<c>", "--num-vectors", "2", "--initializer-token", "toy"],
             "vae": ["--max-test-samples", "1"]}.get(kind, [])
    flags = ["--max-train-steps", "3", "--log-interval", "2" if kind != "vae" else "3", *extra]
    torch.backends.cudnn.deterministic = True
    eager = _tiny_run(build_trainer, tmp_path / "eager", flags, capture=False)
    run = _tiny_run(build_trainer, tmp_path / "graph", flags)
    assert eager["route"] is None and run["route"] == "graph" and run["graph"] is not None
    assert len(run["losses"]) == 3 and run["losses"] == eager["losses"]
    assert len(run["eval"]) == 1 and run["eval"] == eager["eval"]
    assert all(torch.equal(a, b) for a, b in zip(run["params"], eager["params"]))
    assert len([k for k in run["graphs"] if k[0] == "eval"]) == 2  # the batch of 2 and the last batch of 1


def test_step_graph_runs_a_window_it_cannot_take_eagerly(cuda, tmp_path):
    """A window whose batches differ from the captured step's runs eagerly
    on the graph route, and the next matching window replays again."""
    from stable_diffusion_pytorch_tpu_torch.scripts.train_unet import build_trainer

    trainer = build_trainer([*TINY_TRAIN, "--max-train-steps", "4", "--log-interval", "0", "--ckpt-dir",
                             str(tmp_path / "ckpt"), "--logging-dir", str(tmp_path / "logs")])
    batches = list(trainer.train_loader)
    short = [{k: v[:1] for k, v in b.items()} for b in batches[:2]]
    rows = [trainer._dispatch(batches[:2], 0, 1), trainer._dispatch(short, 2, 1), trainer._dispatch(batches[2:4], 4, 1)]
    graph = trainer._graph
    assert graph is not None and not graph.takes(trainer._window_inputs(short, 2))
    assert trainer.state.optimizer.count == 3 and trainer.state.step == 6
    assert all(r.shape[0] == 2 for r in rows)


def test_text_encoder_replays_the_eager_tower_bit_for_bit(cuda):
    """``encode_text`` on the card captures the tower once per (batch,
    length, concept) and replays it: the context equals the eager tower's
    (``capture=False``) bit for bit, with and without token weights and a
    textual-inversion concept; a cond and an uncond encode of one signature
    each keep their own values (the output is cloned out); new concept
    vectors reach the captured tower through its buffer, updated in place;
    inside another capture the tower runs eagerly."""
    import numpy as np

    model = _tiny_sampling_model()
    te = model.text_encoder
    ids_a, ids_b = (te.tokenize([p]).input_ids for p in ("a cat", ""))
    w = np.ones(np.shape(ids_a), np.float32)
    w[0, 2] = 1.3
    for call in range(3):
        a, b = te.encode_text(ids_a), te.encode_text(ids_b)
        assert torch.equal(a, te.encode_text(ids_a, capture=False)), call
        assert torch.equal(b, te.encode_text(ids_b, capture=False)) and not torch.equal(a, b), call
        assert torch.equal(te.encode_text(ids_a, token_weights=w), te.encode_text(ids_a, token_weights=w,
                                                                                  capture=False))
    assert len(te._graphs.graphs) == 1
    rng = np.random.default_rng(0)
    te.add_textual_inversion("<c>", rng.standard_normal((2, te.module.d_model)).astype(np.float32))
    ids = te.tokenize(["a photo of <c>"]).input_ids
    first = te.encode_text(ids)
    assert torch.equal(first, te.encode_text(ids, capture=False)) and torch.equal(te.encode_text(ids), first)
    buffer = te._ti_device[2]
    te.set_textual_inversion_vectors(rng.standard_normal((2, te.module.d_model)).astype(np.float32))
    assert te._ti_device[2] is buffer
    moved = te.encode_text(ids)
    assert not torch.equal(moved, first) and torch.equal(moved, te.encode_text(ids, capture=False))
    ids_t = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=cuda)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        inner = te.encode_text(ids_t)  # eager inside the capture
    graph.replay()
    assert torch.equal(inner, moved)


def _tiny_sampling_model(dtype=torch.bfloat16):
    """A tiny txt2img model on the card, random weights from seed 0."""
    from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig, ClipConfig, DDPMConfig, UnetConfig
    from stable_diffusion_pytorch_tpu_torch.models.build import build_models

    return build_models(UnetConfig(channels_list=[32, 64], n_heads=4, time_emb_dim=64, n_layers=1),
                        AutoencoderConfig(autoencoder_channels_list=[16, 32], groups=8), ClipConfig(),
                        DDPMConfig(noise_steps=50), dtype=dtype, device="cuda", pretrained_dir=None)


GRAPH_CASES = {"ddim": dict(sampler="ddim"), "euler_a": dict(sampler="euler_a"),
               "dpmpp_sde": dict(sampler="dpmpp_sde", karras=True), "deep_cache": dict(sampler="ddpm",
                                                                                    deep_cache_interval=2)}


def _eager_x0(model, x_T, ctx, seed, **kw):
    """The eager loop (``make_sample_fn``) from a seeded generator."""
    from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import make_sample_fn

    fn = make_sample_fn(model.unet, model.noise_scheduler, 4, guidance_scale=7.5, **kw)
    with torch.no_grad():
        return fn(x_T, ctx, model.uncond_for(ctx, 7.5), torch.Generator().manual_seed(seed))


def test_sample_graph_replays_the_eager_loop_bit_for_bit(cuda):
    """Each signature's first ``sample`` call (the warm-up) and its replays
    give the eager loop's x_0 bit for bit (cuDNN deterministic); a replay's
    tally of K1, K6 and K8 equals the eager loop's launches; A, B, then A
    again each give their own eager result from one shared pool."""
    torch.backends.cudnn.deterministic = True
    model = _tiny_sampling_model()
    ctx = model.encode_prompts(["a cat", "a dog"]).to(model.dtype)
    x_T = torch.randn(model.latent_shape(2, 32), generator=torch.Generator().manual_seed(1)).to(cuda, model.dtype)
    eager = {}
    for name, kw in GRAPH_CASES.items():
        native.reset_counters()
        eager[name] = _eager_x0(model, x_T, ctx, 5, **kw)
        launches = {k: native.COUNTERS[k].count for k in ("flash_attention", "group_norm", "group_norm_cat")}
        known = set(model._loops)
        for call in range(3):
            out = model.sample(x_T, ctx, time_steps=4, generator=torch.Generator().manual_seed(5), **kw)
            assert torch.equal(out, eager[name]), (name, call)
        (key,) = set(model._loops) - known
        graph = model._loops[key].graph
        assert graph is not None and graph.capture_s > 0
        assert {k: sum(graph.tally.get(k, {}).values()) for k in launches} == launches, (name, launches)
    for name in ("ddim", "euler_a", "ddim"):  # A-B-A
        out = model.sample(x_T, ctx, time_steps=4, generator=torch.Generator().manual_seed(5), **GRAPH_CASES[name])
        assert torch.equal(out, eager[name]), name
    assert len(model._loops) == len(GRAPH_CASES)


def test_sample_graph_replays_new_weights_and_refuses_what_moved(cuda):
    """A weight load copies in place: the next replay renders with the new
    weights (the eager loop's bits). A replay whose inputs differ from the
    captured ones, or after a parameter's storage moved, raises; a loop that
    syncs with the host cannot be captured and raises, naming the loop."""
    from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import LatentDiffusion
    from stable_diffusion_pytorch_tpu_torch.utils.graphs import CapturedGraph

    torch.backends.cudnn.deterministic = True
    model = _tiny_sampling_model()
    ctx = model.encode_prompts(["a cat"]).to(model.dtype)
    x_T = torch.randn(model.latent_shape(1, 32), generator=torch.Generator().manual_seed(2)).to(cuda, model.dtype)
    kw = dict(sampler="ddim", time_steps=4)
    before = model.sample(x_T, ctx, **kw)
    assert torch.equal(model.sample(x_T, ctx, **kw), before)
    g = torch.Generator().manual_seed(3)
    state = {n: (p.float().cpu() + 0.05 * torch.randn(p.shape, generator=g)).to(p.dtype)
             for n, p in model.unet.state_dict().items()}
    model.unet.load_state_dict(state)
    after = model.sample(x_T, ctx, **kw)
    assert not torch.equal(after, before)
    assert torch.equal(after, _eager_x0(model, x_T, ctx, 0, sampler="ddim"))
    entry = next(iter(model._loops.values()))
    with pytest.raises(RuntimeError, match="differ from the captured"):
        entry(x_T.float(), ctx, model.uncond_for(ctx, 7.5), torch.Generator())
    p = next(model.unet.parameters())
    p.data = p.data.clone()
    with pytest.raises(RuntimeError, match="moved since the graph was captured"):
        model.sample(x_T, ctx, **kw)

    class _Syncing(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv_in = torch.nn.Conv2d(4, 4, 1)

        def forward(self, x, t, c):
            return x * float(x.abs().max())

    syncing = LatentDiffusion(_Syncing().to(cuda), model.autoencoder, model.text_encoder, model.noise_scheduler)
    with pytest.raises(RuntimeError, match="capturing"):
        CapturedGraph(lambda inp: inp["x"] * float(inp["x"].sum()), {"x": torch.ones(4, device=cuda)}, what="a sync")
    with pytest.raises(RuntimeError, match="capturing the sampling loop"):
        syncing.sample(x_T.float(), ctx.float(), guidance_scale=1.0, **kw)


def test_sample_graph_failed_capture_leaves_the_process_usable(cuda):
    """A loop whose capture fails (its UNet syncs with the host) raises, and
    the process stays as it was: the caller's stream is current, the default
    CUDA generator draws and initializes modules, and the same model's next
    capture, into a new pool on the same stream (the failed one takes no
    further capture), succeeds and replays the warm-up's bits."""
    from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import LatentDiffusion

    class _MaybeSyncing(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv_in = torch.nn.Conv2d(4, 4, 1)
            self.sync = True

        def forward(self, x, t, c):
            return x * (float(x.abs().max()) if self.sync else 0.5)

    tiny = _tiny_sampling_model()
    unet = _MaybeSyncing().to(cuda)
    model = LatentDiffusion(unet, tiny.autoencoder, tiny.text_encoder, tiny.noise_scheduler)
    x_T = torch.randn(1, 8, 8, 4, generator=torch.Generator().manual_seed(0)).to(cuda)
    ctx = torch.zeros(1, 77, 768, device=cuda)
    kw = dict(guidance_scale=1.0, sampler="ddim", time_steps=3)
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="capturing the sampling loop"):
            model.sample(x_T, ctx, **kw)
        stream = model._graphs.stream
        assert model._graphs.pool is None and stream is not None
        assert torch.cuda.current_stream() == torch.cuda.default_stream()
        assert torch.isfinite(torch.randn(16, device=cuda)).all()
        assert torch.isfinite(torch.nn.Linear(8, 8, device=cuda).weight).all()
        unet.sync = False
        first = model.sample(x_T, ctx, **kw)
        (entry,) = model._loops.values()
        assert entry.graph is not None and model._graphs.pool is not None and model._graphs.stream is stream
        assert torch.equal(model.sample(x_T, ctx, **kw), first)
        assert torch.isfinite(torch.randn(16, device=cuda)).all()


def test_evaluation_towers_latent_cache_and_quick_train_replay_eager_bits(cuda, tmp_path):
    """The evaluation towers (a VAE's features, a random Inception's, the
    canonical extractor's with ``transform_input`` on a random state, a tiny
    CLIP scorer's similarities), the latent cache's encode and
    ``fid_samplers``' quick-train step, each through its graphs (one per
    batch signature; a short last batch is its own) and eagerly
    (``capture=False``), cuDNN deterministic: the same bits."""
    import numpy as np

    from stable_diffusion_pytorch_tpu_torch.config import DDPMConfig
    from stable_diffusion_pytorch_tpu_torch.models.bpe import CLIPBPETokenizer
    from stable_diffusion_pytorch_tpu_torch.models.clip_vision import CLIPScorer
    from stable_diffusion_pytorch_tpu_torch.models.schedule import make_schedule
    from stable_diffusion_pytorch_tpu_torch.scripts import fid_samplers as fs
    from stable_diffusion_pytorch_tpu_torch.utils import fid
    from stable_diffusion_pytorch_tpu_torch.utils.latent_cache import build_latent_cache

    torch.backends.cudnn.deterministic = True
    model = _tiny_sampling_model(torch.float32)
    images = np.random.default_rng(0).uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
    state = fid.RandomInceptionFeatureExtractor(seed=2, device="cpu").model.state_dict()
    for make in (lambda c: fid.VAEFeatureExtractor(model.autoencoder, capture=c),
                 lambda c: fid.RandomInceptionFeatureExtractor(seed=1, feat_dim=64, device="cuda", capture=c),
                 lambda c: fid.InceptionFeatureExtractor(state=state, device="cuda", capture=c)):
        graph, eager = make(True), make(False)
        for batch in (images[:2], images[2:4], images[4:]):
            np.testing.assert_array_equal(graph(batch), eager(batch))
        assert len(graph._graphs.graphs) == 2 and not eager._graphs.graphs
    text = dict(d_model=32, n_layers=1, n_heads=2, intermediate=64)
    vision = dict(d_model=32, n_layers=1, n_heads=2, intermediate=64, image_size=28, patch_size=14)
    scorers = [CLIPScorer(CLIPBPETokenizer(), model_dir=None, text_cfg=text, vision_cfg=vision, device="cuda",
                          capture=c) for c in (True, False)]
    pixels = ((images + 1) * 127.5).astype(np.uint8)
    prompts = ["a cat", "a dog", "a red car", "", "a photo"]
    for _ in range(2):
        np.testing.assert_array_equal(*(s.similarities(pixels, prompts, batch=2) for s in scorers))
    rows = [{"pixel_values": img, "input_ids": model.text_encoder.tokenize(["a cat"]).input_ids[0]}
            for img in images]
    caches = [np.load(build_latent_cache(model.autoencoder, rows, str(tmp_path / f"{c}.npz"), batch_size=2,
                                         text_encoder=model.text_encoder, capture=c)) for c in (True, False)]
    for key in ("moments", "context_emb", "uncond_emb"):
        np.testing.assert_array_equal(caches[0][key], caches[1][key])
    schedule = make_schedule(DDPMConfig(noise_steps=1000))
    basis = fs.make_basis(16)
    runs = []
    for c in (True, False):
        unet = fs.build_unet(0, "cuda")
        runs.append((fs.quick_train(unet, schedule, basis, 4, capture=c), [p.detach().clone() for p in unet.parameters()]))
    assert runs[0][0] == runs[1][0] and all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
