"""Per-block remat of the port's UNet (``UNetModel(remat=...)``), on the CPU (f32).

- The gradients of a tiny UNet under ``full``, ``conv-save`` and
  ``dots_saveable`` equal those without remat: recomputation repeats the same
  f32 operations, so 1e-6 of each leaf's largest gradient covers it.
- What each policy keeps: counted by a dispatch mode around the backward
  (whose own gradient matmuls are the no-remat count), the recomputation runs
  every convolution and matmul under ``full``, no 3x3 convolution under
  ``conv-save`` (their outputs are saved, as JAX saves the ``resblock_conv``
  names), and no matmul under ``dots_saveable``.
- ``conv-save`` against the JAX ``UNetModel(remat="conv-save")`` on the same
  weights and inputs: per leaf, max-abs gradient error within 1e-4 of the
  leaf's largest gradient (+1e-7), the bar of ``test_torch_port_train_step.py``.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from stable_diffusion_pytorch_tpu.models import unet as jax_unet  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.config import UnetConfig  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import convert  # noqa: E402

torch.set_num_threads(2)

# one level with attention everywhere: ResBlocks with and without the skip
# concat and 1x1 residual, transformers in every place, a small JAX compile
UNET_KW = dict(num_res_blocks=1, n_heads=2, attention_resolutions=[1], channels_list=[16],
               time_emb_dim=16, dropout=0.0, n_layers=1, context_dim=16)
POLICIES = ("full", "conv-save", "dots_saveable")


@functools.lru_cache(maxsize=None)
def setup():
    cfg = jax_unet.UnetConfig(**UNET_KW)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(jax_unet.UNetModel.from_config(4, 4, cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 16)))
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))).astype(np.float32),
        shapes)
    inputs = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32), np.array([3, 700], np.int32),
              rng.standard_normal((2, 7, 16)).astype(np.float32), rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    return cfg, params, inputs


def port_grads(remat, mode=None):
    cfg, params, (x, t, ctx, w) = setup()
    unet = UNetModel(4, 4, UnetConfig(**UNET_KW), remat=remat)
    unet.load_state_dict(convert.to_torch(convert.unet_state_dict(params, cfg)), strict=True)
    out = unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    loss = (out * torch.from_numpy(w)).sum()
    if mode is None:
        loss.backward()
    else:
        with mode:
            loss.backward()
    return {n: p.grad for n, p in unet.named_parameters()}


class CountForwardOps(TorchDispatchMode):
    """Counts the convolutions (3x3 and others) and matmuls dispatched."""

    def __init__(self):
        super().__init__()
        self.counts = {"conv3x3": 0, "conv_other": 0, "matmul": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if func is aten.convolution.default:
            self.counts["conv3x3" if tuple(args[1].shape[-2:]) == (3, 3) else "conv_other"] += 1
        elif func in (aten.mm.default, aten.addmm.default, aten.bmm.default):
            self.counts["matmul"] += 1
        return func(*args, **(kwargs or {}))


def _assert_grads_close(got, want, rel):
    for name, g in want.items():
        err = (got[name] - g).abs().max().item()
        assert err <= rel * g.abs().max().item() + 1e-7, (name, err)


@pytest.mark.parametrize("remat", POLICIES)
def test_remat_gradients_equal_no_remat(remat):
    _assert_grads_close(port_grads(remat), port_grads("none"), 1e-6)


@functools.lru_cache(maxsize=None)
def backward_counts(remat):
    mode = CountForwardOps()
    port_grads(remat, mode)
    return mode.counts


@pytest.mark.parametrize("remat", POLICIES)
def test_remat_policies_recompute_what_jax_recomputes(remat):
    base, c = backward_counts("none"), backward_counts(remat)
    assert base["conv3x3"] == base["conv_other"] == 0 and base["matmul"] > 0
    recomputed = {"conv3x3": c["conv3x3"] > 0, "conv_other": c["conv_other"] > 0,
                  "matmul": c["matmul"] > base["matmul"]}
    assert recomputed == {"full": {"conv3x3": True, "conv_other": True, "matmul": True},
                          "conv-save": {"conv3x3": False, "conv_other": True, "matmul": True},
                          "dots_saveable": {"conv3x3": True, "conv_other": True, "matmul": False}}[remat], c


def test_conv_save_gradients_match_jax_conv_save():
    cfg, params, (x, t, ctx, w) = setup()
    model = jax_unet.UNetModel.from_config(4, 4, cfg, remat="conv-save")

    def loss(p):
        return jnp.sum(model.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)) * jnp.asarray(w))

    ref = convert.to_torch(convert.unet_state_dict(jax.jit(jax.grad(loss))(params), cfg))
    _assert_grads_close(port_grads("conv-save"), ref, 1e-4)
