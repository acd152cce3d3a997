"""Port models vs the JAX package at tiny sizes (f32, CPU); configs, plans, converter.

Weights: each JAX model gets seeded random parameters (zero-initialized convs
included), converted by ``utils/convert.py``; the port model loads the result
with ``strict=True``. Tolerance 1e-4 absolute on
O(1) outputs: f32 through ~30 layers, sums in another order.
"""

import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu import pipeline as jax_pipeline  # noqa: E402
from stable_diffusion_pytorch_tpu.models import autoencoder as jax_vae  # noqa: E402
from stable_diffusion_pytorch_tpu.models import clip as jax_clip  # noqa: E402
from stable_diffusion_pytorch_tpu.models import presets as jax_presets  # noqa: E402
from stable_diffusion_pytorch_tpu.models import schedule as jax_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu.models import unet as jax_unet  # noqa: E402
from stable_diffusion_pytorch_tpu.utils import compat as jax_compat  # noqa: E402
from stable_diffusion_pytorch_tpu.utils.torch_port import (  # noqa: E402
    export_reference_autoencoder,
    export_reference_unet,
)
from stable_diffusion_pytorch_tpu_torch import config as port_config  # noqa: E402
from stable_diffusion_pytorch_tpu_torch import pipeline as port_pipeline  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import presets as port_presets  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import schedule as port_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import unet as port_unet  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.autoencoder import AutoEncoderKL  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.clip import CLIPTextTransformer  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import compat as port_compat  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import convert  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)

# up-path concats 24+16 and 16+16 with 4 groups: the group of channels 20-29
# straddles the boundary at 24
UNET_KW = dict(num_res_blocks=1, n_heads=2, attention_resolutions=[1, 2], channels_list=[16, 24],
               time_emb_dim=32, dropout=0.0, n_layers=1, context_dim=24)
VAE_KW = dict(in_channels=3, latent_channels=4, out_channels=3, autoencoder_channels_list=[16, 32],
              autoencoder_num_res_blocks=1, groups=8, kl_weight=1.0)


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


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _field_table(cls, with_meta=True):
    return [
        (f.name, f.default if f.default_factory is dataclasses.MISSING else f.default_factory(),
         dict(f.metadata) if with_meta else None)
        for f in dataclasses.fields(cls)
    ]


@pytest.mark.parametrize(
    "port_cls,jax_cls",
    [
        (port_config.UnetConfig, jax_unet.UnetConfig),
        (port_config.AutoencoderConfig, jax_vae.AutoencoderConfig),
        (port_config.ClipConfig, jax_clip.ClipConfig),
        (port_config.DDPMConfig, jax_schedule.DDPMConfig),
    ],
    ids=["unet", "autoencoder", "clip", "ddpm"],
)
def test_config_dataclasses_equal_jax(port_cls, jax_cls):
    assert _field_table(port_cls) == _field_table(jax_cls)


def test_subset_configs_match_jax_fields():
    """SamplingConfig and CompatConfig hold a subset of the JAX fields with
    the same names and defaults."""
    for port_cls, jax_cls in [
        (port_pipeline.SamplingConfig, jax_pipeline.SamplingConfig),
        (port_compat.CompatConfig, jax_compat.CompatConfig),
    ]:
        jax_fields = {n: d for n, d, _ in _field_table(jax_cls, with_meta=False)}
        for name, default, _ in _field_table(port_cls, with_meta=False):
            assert jax_fields[name] == default, name


def test_presets_equal_jax():
    for name in ("reference_unet_config", "sd15_unet_config", "sd15_autoencoder_config", "sd15_ddpm_config"):
        assert dataclasses.asdict(getattr(port_presets, name)()) == dataclasses.asdict(getattr(jax_presets, name)())


@pytest.mark.parametrize(
    "cfg",
    [jax_presets.sd15_unet_config(), jax_unet.UnetConfig(**UNET_KW), jax_unet.UnetConfig(attention_resolutions=[0, 1])],
    ids=["sd15", "tiny", "default"],
)
def test_block_plans_equal_jax(cfg):
    args = (cfg.channels_list[0], cfg.channels_list, cfg.num_res_blocks, cfg.attention_resolutions)
    j_in, p_in = jax_unet.plan_input_blocks(*args), port_unet.plan_input_blocks(*args)
    assert j_in == p_in
    _, skips, mid, _, mult = j_in
    out_args = (cfg.channels_list, cfg.num_res_blocks, cfg.attention_resolutions, skips, mid, mult)
    assert jax_unet.plan_output_blocks(*out_args) == port_unet.plan_output_blocks(*out_args)


def test_schedule_and_ddim_step_match_jax():
    cfg = jax_schedule.DDPMConfig()
    js = jax_schedule.make_schedule(cfg)
    ps = port_schedule.make_schedule(port_config.DDPMConfig())
    # XLA's cumprod is an associative scan, torch's a sequential product: over
    # 1000 f32 factors the two orders differ by up to ~3e-5 relative
    for name in ("betas", "alphas_cumprod", "sqrt_recip_alpha_bar", "sqrt_recip_m1_alpha_bar", "log_var"):
        np.testing.assert_allclose(getattr(ps, name).numpy(), np.asarray(getattr(js, name)), rtol=1e-4, atol=1e-7)
    assert port_schedule.spaced_timesteps(1000, 7) == list(np.asarray(jax_schedule.spaced_timesteps(1000, 7)))
    x, eps = rand(0, 2, 4, 4, 4), rand(1, 2, 4, 4, 4)
    for t, t_prev in [(980, 960), (20, 0), (0, -1)]:
        ref, _ = jax_schedule.ddim_step(js, jnp.asarray(eps), jnp.asarray(x), jnp.int32(t), jnp.int32(t_prev))
        out, _ = port_schedule.ddim_step(ps, torch.from_numpy(eps), torch.from_numpy(x), t, t_prev)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for schedule in ("cosine", "cubic"):
        np.testing.assert_allclose(
            port_schedule.make_betas(schedule, 1000, 1e-4, 0.02).numpy(),
            # cosine betas are 1 - a/b: the cancellation leaves ~ulp(1) absolute error
            np.asarray(jax_schedule.make_betas(schedule, 1000, 1e-4, 0.02)), rtol=1e-4, atol=5e-7,
        )


@pytest.mark.parametrize("t,t_prev", [(980, 960), (20, 0), (0, -1)], ids=["early", "late", "last"])
def test_ddim_step_with_eta_matches_jax(t, t_prev):
    """eta > 0: the two frameworks draw different noise from their seeds, so
    each side's own noise times sigma (float64 from the JAX tables) is taken
    off, and the rest must agree; the last step adds no noise at all."""
    eta, shape = 0.5, (2, 4, 4, 4)
    js = jax_schedule.make_schedule(jax_schedule.DDPMConfig())
    ps = port_schedule.make_schedule(port_config.DDPMConfig())
    x, eps = rand(2, *shape), rand(3, *shape)
    key = jax.random.PRNGKey(4)
    ref, _ = jax_schedule.ddim_step(
        js, jnp.asarray(eps), jnp.asarray(x), jnp.int32(t), jnp.int32(t_prev), key=key, eta=eta
    )
    out, _ = port_schedule.ddim_step(
        ps, torch.from_numpy(eps), torch.from_numpy(x), t, t_prev, eta, torch.Generator().manual_seed(4)
    )
    abar = np.asarray(js.alphas_cumprod, np.float64)
    a_t, a_prev = abar[t], (abar[t_prev] if t_prev >= 0 else 1.0)
    sigma = eta * np.sqrt((1 - a_prev) / (1 - a_t)) * np.sqrt(1 - a_t / a_prev)
    jax_noise = np.asarray(jax.random.normal(key, shape, jnp.float32)) if t_prev >= 0 else 0.0
    port_noise = torch.randn(shape, generator=torch.Generator().manual_seed(4)).numpy() if t_prev >= 0 else 0.0
    np.testing.assert_allclose(out.numpy() - sigma * port_noise, np.asarray(ref) - sigma * jax_noise,
                               rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_unet(quirks: bool):
    compat = jax_compat.CompatConfig(flipped_time_embedding=True, bottleneck_default_groups=True) if quirks else None
    cfg = jax_unet.UnetConfig(**UNET_KW)
    model = jax_unet.UNetModel.from_config(4, 4, cfg, compat=compat)
    params = random_params(model, 1, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 24)))
    return cfg, model, params, compat


@functools.lru_cache(maxsize=None)
def _jax_vae():
    cfg = jax_vae.AutoencoderConfig(**VAE_KW)
    model = jax_vae.AutoEncoderKL.from_config(cfg)
    return cfg, model, random_params(model, 2, jnp.zeros((1, 16, 16, 3)))


def test_converter_equals_export_reference():
    cfg, _, params, _ = _jax_unet(False)
    ref, ours = export_reference_unet(params, cfg), convert.unet_state_dict(params, cfg)
    assert ref.keys() == ours.keys()
    assert all(np.array_equal(ref[k], ours[k]) for k in ref)
    vcfg, _, vparams = _jax_vae()
    ref, ours = export_reference_autoencoder(vparams, vcfg), convert.autoencoder_state_dict(vparams, vcfg)
    assert ref.keys() == ours.keys()
    assert all(np.array_equal(ref[k], ours[k]) for k in ref)


def port_unet_from(cfg, params, compat):
    model = port_unet.UNetModel(
        4, 4, port_config.UnetConfig(**dataclasses.asdict(cfg)),
        flipped_time_embedding=bool(compat and compat.flipped_time_embedding),
        bottleneck_default_groups=bool(compat and compat.bottleneck_default_groups),
    )
    model.load_state_dict(convert.to_torch(convert.unet_state_dict(params, cfg)), strict=True)
    return model.eval()


@pytest.mark.parametrize("quirks", [False, True], ids=["default", "reference_quirks"])
def test_unet_matches_jax(quirks):
    cfg, model, params, compat = _jax_unet(quirks)
    x, ctx = rand(3, 2, 8, 8, 4), rand(4, 2, 77, 24)
    t = np.array([1, 3], np.int32) if compat else np.array([981, 3], np.int32)
    ref = model.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    port = port_unet_from(cfg, params, compat)
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def port_vae_from(cfg, params):
    model = AutoEncoderKL(port_config.AutoencoderConfig(**dataclasses.asdict(cfg)))
    model.load_state_dict(convert.to_torch(convert.autoencoder_state_dict(params, cfg)), strict=True)
    return model.eval()


def test_autoencoder_encode_decode_match_jax():
    cfg, model, params = _jax_vae()
    port = port_vae_from(cfg, params)
    img, lat = rand(5, 2, 16, 16, 3), rand(6, 2, 8, 8, 4)
    post = model.apply(params, jnp.asarray(img), method=model.encode).latent_dist
    dec = model.apply(params, jnp.asarray(lat), method=model.decode)
    with torch.no_grad():
        port_post = port.encode(torch.from_numpy(img))
        out = port.decode(torch.from_numpy(lat))
    np.testing.assert_allclose(port_post.mean.numpy(), np.asarray(post.mean), **TOL)
    np.testing.assert_allclose(port_post.log_var.numpy(), np.asarray(post.log_var), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(dec), **TOL)


def test_clip_text_transformer_matches_jax():
    kw = dict(vocab_size=600, d_model=32, n_layers=2, n_heads=4, intermediate=64, max_positions=77)
    jmod = jax_clip.CLIPTextTransformer(**kw)
    ids = np.random.default_rng(7).integers(0, 600, (2, 77)).astype(np.int32)
    params = random_params(jmod, 8, jnp.asarray(ids))
    ref = jmod.apply(params, jnp.asarray(ids))
    sd = convert.clip_state_dict(params)
    back = jax_clip.convert_text_tower(sd, "text_model.")
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, params["params"]))
    port = CLIPTextTransformer(**kw)
    port.load_state_dict(convert.to_torch(sd), strict=True)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
