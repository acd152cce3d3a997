"""The port's kernels against their plain versions on a CUDA device.

Marked ``cuda``: they skip without a card (the kernels have no CPU mode). This
file needs no jax, so it also runs on a GPU machine without it, where the
repository's conftest (which imports jax) is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

Tolerances on max-abs error, relative to max(1, max|plain|): float32 1e-5 for
attention and 5e-5 for GroupNorm (summation order); bfloat16 2e-2 (both sides
round their outputs to bf16, spacing 2^-7 of the magnitude). The backward
kernels: float32 5e-5 for attention (sums over up to 300 kv rows, and dq is
summed with atomics in an order that changes between runs) and 1e-4 for
GroupNorm (two reductions over the map); bfloat16 2e-2 as above (the kernel's
delta = rowsum(dO * O) reads the bf16-rounded O, the plain version sums
dP * P in f32). The split backward (K4/K5) is held to the same tolerances and,
having no atomics, to bit-identical results from two launches.
"""

import pytest

torch = pytest.importorskip("torch")

from stable_diffusion_pytorch_tpu_torch.ops import native  # noqa: E402
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
    fused_group_norm,
    fused_group_norm_cat,
    group_norm_bwd_plain,
)
from stable_diffusion_pytorch_tpu_torch.ops.groupnorm import (  # noqa: E402
    xla_group_norm,
    xla_group_norm_cat,
)

pytestmark = pytest.mark.cuda
TOL = {"float32": (1e-5, 5e-5), "bfloat16": (2e-2, 2e-2)}
BWD_TOL = {"float32": (5e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}


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


def test_kv_past_the_crossover_runs_k1_and_the_split_backward(cuda):
    """K1 and the Function at 10000 kv tokens (past the 9216 crossover): the
    backward routes to the split kernels."""
    assert backward_route(10000) == "split" and backward_route(4096) == "fused"
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
    the plain concat forward."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(5)
    for shape, groups in [((2, 64, 960), 32), ((1, 8, 8, 128), 32), ((2, 17, 40), 8)]:
        c = shape[-1]
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
        "group_norm_cat": 1, "group_norm_bwd": 0,
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
    loss, every parameter updated, K1/K3/K6/K7/K8 launched."""
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
    assert all(counts[k] > 0 for k in ("flash_attention", "flash_attention_bwd", "group_norm", "group_norm_bwd",
                                       "group_norm_cat")), counts
