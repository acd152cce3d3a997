"""The text-to-image slice, port vs JAX package, at a tiny size on the CPU (f32).

The same prompts, the same numpy ``x_T`` and the same weights (JAX trees
converted by ``utils/convert.py``) go through the JAX ``LatentDiffusion``
(``encode_prompts``, the jitted DDIM ``make_sample_fn`` scan with CFG 7.5,
``decode_latent``) and through the port's. Tolerances: 1e-4 on the prompt
embeddings (f32 through the text tower) and on the decoder run on one latent;
2e-4 on the 5-step latents, since CFG multiplies each step's eps difference by
7.5; 1e-3 on the image decoded from each side's own latents, since the
decoder's gain amplifies that latent gap.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu.models import autoencoder as jax_vae  # noqa: E402
from stable_diffusion_pytorch_tpu.models import clip as jax_clip  # noqa: E402
from stable_diffusion_pytorch_tpu.models import latent_diffusion as jax_ld  # noqa: E402
from stable_diffusion_pytorch_tpu.models import schedule as jax_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu.models import unet as jax_unet  # noqa: E402
from stable_diffusion_pytorch_tpu.models.bpe import CLIPBPETokenizer  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.config import (  # noqa: E402
    AutoencoderConfig,
    ClipConfig,
    DDPMConfig,
    UnetConfig,
)
from stable_diffusion_pytorch_tpu_torch.models.autoencoder import AutoEncoderKL  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.clip import CLIPModel, CLIPTextTransformer  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import LatentDiffusion  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.schedule import make_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import convert  # noqa: E402

torch.set_num_threads(2)

UNET_KW = dict(num_res_blocks=1, n_heads=2, attention_resolutions=[1, 2], channels_list=[16, 24],
               time_emb_dim=32, dropout=0.0, n_layers=1, context_dim=32)
VAE_KW = dict(in_channels=3, latent_channels=4, out_channels=3, autoencoder_channels_list=[16, 32],
              autoencoder_num_res_blocks=1, groups=8, kl_weight=1.0)
CLIP_KW = dict(d_model=32, n_layers=2, n_heads=4, intermediate=64, max_positions=77)
PROMPTS = ["a photo of a cat", "an astronaut riding a horse"]


def random_params(module, seed, *args):
    """Seeded random parameters of a flax module (shapes from ``eval_shape``):
    unit-centred norm scales, small biases, LeCun-scaled kernels."""
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


@pytest.fixture(scope="module")
def models():
    unet_cfg, vae_cfg = jax_unet.UnetConfig(**UNET_KW), jax_vae.AutoencoderConfig(**VAE_KW)
    j_unet = jax_unet.UNetModel.from_config(4, 4, unet_cfg)
    j_vae = jax_vae.AutoEncoderKL.from_config(vae_cfg)
    j_clip = jax_clip.CLIPTextTransformer(**CLIP_KW)
    u_params = random_params(j_unet, 0, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 32)))
    v_params = random_params(j_vae, 1, jnp.zeros((1, 16, 16, 3)))
    c_params = random_params(j_clip, 2, jnp.zeros((1, 77), jnp.int32))

    # the JAX text-encoder facade around the tiny tower, with the offline BPE
    # tokenizer its resolver picks when no vocab files are staged
    te = jax_clip.CLIPModel.__new__(jax_clip.CLIPModel)
    te.cfg, te.max_seq_len, te.module, te.params, te._ti = jax_clip.ClipConfig(model_dir=None), 77, j_clip, c_params, None
    te.tokenizer = CLIPBPETokenizer(max_seq_len=77)
    te._encode = jax.jit(j_clip.apply)
    jax_model = jax_ld.LatentDiffusion(
        j_unet, u_params, j_vae, v_params, te, jax_schedule.make_schedule(jax_schedule.DDPMConfig())
    )

    p_unet = UNetModel(4, 4, UnetConfig(**UNET_KW))
    p_unet.load_state_dict(convert.to_torch(convert.unet_state_dict(u_params, unet_cfg)), strict=True)
    p_vae = AutoEncoderKL(AutoencoderConfig(**VAE_KW))
    p_vae.load_state_dict(convert.to_torch(convert.autoencoder_state_dict(v_params, vae_cfg)), strict=True)
    p_clip = CLIPTextTransformer(**CLIP_KW)
    p_clip.load_state_dict(convert.to_torch(convert.clip_state_dict(c_params)), strict=True)
    port_model = LatentDiffusion(
        p_unet.eval(), p_vae.eval(), CLIPModel(ClipConfig(model_dir=None), p_clip.eval()),
        make_schedule(DDPMConfig()),
    )
    return jax_model, port_model


def test_encode_prompts_matches_jax(models):
    jax_model, port_model = models
    ref = jax_model.encode_prompts(PROMPTS)
    out = port_model.encode_prompts(PROMPTS)
    assert out.shape == (2, 77, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        port_model.encode_uncond(2, "").numpy(), np.asarray(jax_model.encode_uncond(2, "")), rtol=1e-4, atol=1e-4
    )


def test_ddim_cfg_five_steps_and_decode_match_jax(models):
    jax_model, port_model = models
    x_T = np.random.default_rng(3).standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = jax_model.encode_prompts(PROMPTS)
    ref = jax_model.sample(jnp.asarray(x_T), ctx, guidance_scale=7.5, time_steps=5, sampler="ddim",
                           negative_prompt="blurry")
    ref_img = jax_model.decode_latent(ref)

    p_ctx = port_model.encode_prompts(PROMPTS)
    out = port_model.sample(torch.from_numpy(x_T), p_ctx, guidance_scale=7.5, time_steps=5,
                            sampler="ddim", negative_prompt="blurry")
    img = port_model.decode_latent(out)
    assert img.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), rtol=1e-4, atol=1e-3)
    # the decoder alone, on the same latent
    same = port_model.decode_latent(torch.from_numpy(np.asarray(ref)))
    np.testing.assert_allclose(same.numpy(), np.asarray(ref_img), rtol=1e-4, atol=1e-4)


def test_unported_sampler_raises(models):
    _, port_model = models
    with pytest.raises(NotImplementedError):
        port_model.sample(torch.zeros(1, 8, 8, 4), torch.zeros(1, 77, 32), time_steps=2, sampler="ddpm")
