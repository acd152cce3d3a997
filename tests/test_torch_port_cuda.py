"""The port's kernels against their plain versions on a CUDA device.

Marked ``cuda``: they skip without a card (the kernels have no CPU mode). This
file needs no jax, so it also runs on a GPU machine without it, where the
repository's conftest (which imports jax) is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

Tolerances on max-abs error, relative to max(1, max|plain|): float32 1e-5 for
attention and 5e-5 for GroupNorm (summation order); bfloat16 2e-2 (both sides
round their outputs to bf16, spacing 2^-7 of the magnitude).
"""

import pytest

torch = pytest.importorskip("torch")

from stable_diffusion_pytorch_tpu_torch.ops import native  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
)
from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import (  # noqa: E402
    fused_group_norm,
    fused_group_norm_cat,
)
from stable_diffusion_pytorch_tpu_torch.ops.groupnorm import (  # noqa: E402
    xla_group_norm,
    xla_group_norm_cat,
)

pytestmark = pytest.mark.cuda
TOL = {"float32": (1e-5, 5e-5), "bfloat16": (2e-2, 2e-2)}


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
    for b, n, m, h, d in [(2, 200, 77, 8, 40), (2, 256, 256, 8, 160), (1, 64, 64, 1, 128), (1, 33, 300, 2, 80)]:
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


def test_cuda_tensors_count_launches_and_reject_bad_input(cuda):
    native.reset_counters()
    q = torch.randn(1, 16, 2, 40, device=cuda)
    flash_attention(q, q, q)
    x = torch.randn(1, 16, 64, device=cuda)
    w = torch.ones(64, device=cuda)
    fused_group_norm(x, w, w, 8)
    fused_group_norm_cat(x, x, torch.ones(128, device=cuda), torch.ones(128, device=cuda), 8)
    assert {k: c.count for k, c in native.COUNTERS.items()} == {
        "flash_attention": 1, "group_norm": 1, "group_norm_cat": 1,
    }
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        fused_group_norm(x[..., ::2], w[:32], w[:32], 8)  # not contiguous
    with pytest.raises(ValueError):
        fused_group_norm(x, w.bfloat16(), w, 8)  # affine params must be f32
    assert native.COUNTERS["flash_attention"].count == 1
