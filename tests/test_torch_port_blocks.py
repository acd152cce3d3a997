"""Port blocks vs the JAX package's flax blocks on the same weights (f32, CPU).

Each flax block gets seeded random parameters (zero-initialized convs
included), converted by ``utils/convert.py`` and loaded into the port block
with ``strict=True``. Tolerance: 1e-4 absolute on
O(1) outputs, for f32 sums taken in another order through a few layers.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu.models import blocks as jb  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import blocks as tb  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import convert  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def random_params(module, seed, *args):
    """Seeded random parameters of a flax module (shapes from ``eval_shape``,
    no init run): unit-centred norm scales, small biases, LeCun-scaled kernels,
    so zero-initialized layers contribute too."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", None)
        n = rng.standard_normal(s.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "bias":
            return 0.1 * n
        return n / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def load(module, write, params, *args):
    sd = {}
    write(params, sd, "m", *args)
    module.load_state_dict(convert.to_torch({k[2:]: v for k, v in sd.items()}), strict=True)
    return module.eval()


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("flipped", [False, True])
def test_sinusoidal_time_proj(flipped):
    # the flipped frequencies grow to 10000**(15/16): at large t the f32 sine
    # arguments reach ~1e7, where one ulp of exp() moves the sine by ~1e-3
    t = np.array([0, 1, 3] if flipped else [0, 3, 999], np.int32)
    ref = jb.sinusoidal_time_proj(jnp.asarray(t), 32, flipped=flipped)
    out = tb.sinusoidal_time_proj(torch.from_numpy(t), 32, flipped=flipped)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize(
    "c1,c2,out_ch",
    [(16, 0, 24), (24, 0, 24), (24, 16, 24), (24, 24, 48)],
    ids=["resize", "identity", "skip_cat_split_residual", "skip_cat_equal_width"],
)
def test_resblock(c1, c2, out_ch):
    groups, t_dim = 4, 32
    x, t = rand(0, 2, 6, 6, c1), rand(1, 2, t_dim)
    s = rand(2, 2, 6, 6, c2) if c2 else None
    jmod = jb.ResBlock(out_channels=out_ch, time_emb_dim=t_dim, groups=groups)
    jargs = (jnp.asarray(x), jnp.asarray(t), True, None if s is None else jnp.asarray(s))
    params = random_params(jmod, 3, *jargs)
    ref = jmod.apply(params, *jargs)
    port = load(tb.ResBlock(c1 + c2, out_ch, t_dim, groups), convert.resblock, params["params"])
    out = port(torch.from_numpy(x), torch.from_numpy(t), None if s is None else torch.from_numpy(s))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("cross", [False, True], ids=["self_fused_qkv", "cross_m77"])
def test_cross_attention(cross):
    x = rand(4, 2, 5, 8, 32)  # a [B, H, W, C] map, flattened inside
    ctx = rand(5, 2, 77, 24) if cross else None
    jmod = jb.CrossAttention(query_dim=32, context_dim=24 if cross else None, n_heads=4, d_head=10)
    jargs = (jnp.asarray(x), None if ctx is None else jnp.asarray(ctx))
    params = random_params(jmod, 6, *jargs)
    ref = jmod.apply(params, *jargs)
    port = load(tb.CrossAttention(32, 24 if cross else None, 4, 10), convert.cross_attention, params["params"])
    out = port(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def test_spatial_transformer():
    x, ctx = rand(7, 2, 4, 6, 32), rand(8, 2, 77, 24)
    jmod = jb.SpatialTransformer(in_channels=32, n_heads=4, d_head=8, n_layers=2, context_dim=24, groups=8)
    jargs = (jnp.asarray(x), jnp.asarray(ctx))
    params = random_params(jmod, 9, *jargs)
    ref = jmod.apply(params, *jargs)
    port = load(
        tb.SpatialTransformer(32, 4, 8, n_layers=2, context_dim=24, groups=8),
        convert.spatial_transformer, params["params"], 2,
    )
    out = port(torch.from_numpy(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("down", [False, True], ids=["upsample", "downsample"])
def test_resampling(down):
    x = rand(10, 2, 6, 4, 8)
    jmod = jb.DownSample(out_channels=12) if down else jb.UpSample(out_channels=12)
    params = random_params(jmod, 11, jnp.asarray(x))
    ref = jmod.apply(params, jnp.asarray(x))
    cls = tb.DownSample if down else tb.UpSample
    sd = {}
    convert._conv(params["params"]["conv"], sd, "conv")
    port = cls(8, 12)
    port.load_state_dict(convert.to_torch(sd), strict=True)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), np.asarray(ref), **TOL)
