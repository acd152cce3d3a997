"""img2img and inpainting: the port vs the JAX package, on the CPU (f32),
through the tiny models of ``test_torch_port_slice.py`` (one JAX model for
the module).

Held: the mask's resize against ``jax.image.resize(..., "nearest")`` (equal,
at sizes that do not divide evenly; ``nearest`` would not be), the image
loader against JAX's ``_load_image`` (equal, from arrays and from PNG files
of every channel count, masks too), the VAE posterior sample with JAX's eps
(1e-4), and 5-step loops at the slice's bar (rtol 1e-4, atol 2e-4): img2img
with ddim and dpmpp, inpaint with ddim and euler_a fed JAX's step and blend
draws (``split(k, 3)`` per step), where the kept region is the init latent
exactly after the last step; ddim through the tiny UNet, the other sampler
of each through the samplers' stand-in UNet, whose loop's pre-drawn body
(what a CUDA graph captures) is held to the same JAX result. Then the port's pipelines, and its img2img CLI
in img2img mode (in a process without jax) and in inpaint mode.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu import pipeline as jax_pipeline  # noqa: E402
from stable_diffusion_pytorch_tpu.models import latent_diffusion as jax_ld  # noqa: E402
from stable_diffusion_pytorch_tpu.models import schedule as jax_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu_torch import pipeline  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.config import DDPMConfig  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import latent_diffusion as port_ld  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import schedule as sched  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.data import encode_png, read_image  # noqa: E402
from test_torch_port_sample_graph import body_draws  # noqa: E402
from test_torch_port_samplers import _StandIn, _stand_in  # noqa: E402
from test_torch_port_slice import PROMPTS, models  # noqa: E402,F401  (module-scoped tiny JAX + port models)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP = dict(rtol=1e-4, atol=2e-4)
JS = jax_schedule.make_schedule(jax_schedule.DDPMConfig())
PS = sched.make_schedule(DDPMConfig())


def jax_draws(key, steps: int, shape):
    """The JAX scan's per-step draws, ``k, sub, k_blend = split(k, 3)``:
    (step noise from ``sub``, blend noise from ``k_blend``)."""
    step, blend, k = [], [], key
    for _ in range(steps):
        k, sub, k_blend = jax.random.split(k, 3)
        step.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
        blend.append(torch.from_numpy(np.array(jax.random.normal(k_blend, shape, jnp.float32))))
    return step, blend


@pytest.mark.parametrize("src,dst", [((512, 512), (64, 64)), ((50, 37), (8, 6)), ((21, 100), (13, 9)),
                                     ((16, 16), (8, 8))])
def test_mask_resize_is_jax_nearest(src, dst):
    rng = np.random.default_rng(sum(src))
    mask = (rng.random(src) * 255).astype(np.float32)
    ref = jax_pipeline.jax.image.resize(jnp.asarray(mask / 255.0), dst, method="nearest")
    ref = np.asarray(ref > 0.5, np.float32)
    out = pipeline.load_mask(mask, dst)
    assert out.shape == (1, *dst, 1)
    np.testing.assert_array_equal(out[0, :, :, 0].numpy(), ref)
    if src == (512, 512):  # "nearest" samples at the corners, and misses
        import torch.nn.functional as F

        plain = F.interpolate(torch.from_numpy(mask / 255.0)[None, None], size=dst, mode="nearest")[0, 0] > 0.5
        assert (plain.float().numpy() != ref).sum() > 0


def test_images_and_masks_from_files_are_jax_s(tmp_path):
    """``load_image`` and ``load_mask`` from a path, against JAX's
    ``_load_image`` (PIL's RGB conversion, the center crop) and its inpaint
    mask (PIL's L conversion, the resize), for PNGs of every channel count
    and the port's own PNG."""
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for mode, shape in (("RGB", (19, 11, 3)), ("RGBA", (9, 14, 4)), ("L", (12, 7)), ("LA", (8, 5, 2))):
        paths.append(tmp_path / f"{mode}.png")
        Image.fromarray((rng.random(shape) * 255).astype(np.uint8), mode).save(paths[-1])
    paths.append(tmp_path / "own.png")
    paths[-1].write_bytes(encode_png((rng.random((23, 17, 3)) * 255).astype(np.uint8)))
    for path in map(str, paths):
        side = min(Image.open(path).size)  # the short side: a crop, no resize (the port's is not PIL's)
        np.testing.assert_array_equal(pipeline.load_image(path, side).numpy(), jax_pipeline._load_image(path, side))
        gray = np.asarray(Image.open(path).convert("L"), np.float32) / 255.0
        ref = np.asarray(jax_pipeline.jax.image.resize(jnp.asarray(gray), (5, 3), method="nearest") > 0.5)
        np.testing.assert_array_equal(pipeline.load_mask(path, (5, 3))[0, :, :, 0].numpy(), ref)


def test_load_image_is_jax_load_image():
    rng = np.random.default_rng(1)
    for image in ((rng.random((16, 16, 3)) * 255).astype(np.uint8), rng.uniform(-1, 1, (16, 16, 3)).astype(np.float32)):
        np.testing.assert_array_equal(pipeline.load_image(image, 16).numpy(), jax_pipeline._load_image(image, 16))


def test_posterior_sample_with_jax_eps(models):
    """The VAE encoder and the posterior sample, eps handed in: 1e-4."""
    jax_model, port_model = models
    img = np.random.default_rng(2).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jax.jit(lambda im, k: jax_model.encode_image(im).latent_dist.sample(k))(jnp.asarray(img), key)
    posterior = port_model.encode_image(torch.from_numpy(img))
    eps = torch.from_numpy(np.array(jax.random.normal(key, ref.shape, jnp.float32)))
    np.testing.assert_allclose(posterior.sample(eps=eps).numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def _ctx(jax_model):
    ctx, uncond = jax_model.encode_prompts(PROMPTS), jax_model.encode_uncond(2, "blurry")
    return ctx, uncond, torch.from_numpy(np.array(ctx)), torch.from_numpy(np.array(uncond))


def _unets(models, tiny: bool):
    """(JAX UNet, port UNet, JAX params): the tiny UNet, or the samplers'
    stand-in (the loop under test at a fraction of the tiny UNet's compile)."""
    jax_model, port_model = models
    if tiny:
        return jax_model.unet, port_model.unet, jax_model.unet_params
    return _StandIn(), _stand_in, None


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
def test_img2img_loop_matches_jax(models, sampler):
    """strength 0.75 of 7 steps: the final 5, from the init latent q-sampled
    to the first of them; ddim through the tiny UNet, dpmpp through the
    stand-in."""
    jax_model, port_model = models
    j_unet, p_unet, params = _unets(models, tiny=sampler == "ddim")
    rng = np.random.default_rng(4)
    init, noise = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    j_fn = jax_ld.make_sample_fn(j_unet, JS, 7, sampler=sampler, guidance_scale=7.5, strength=0.75)
    p_fn = port_ld.make_sample_fn(p_unet, PS, 7, sampler=sampler, guidance_scale=7.5, strength=0.75)
    assert p_fn.start_timestep == j_fn.start_timestep
    t0 = np.full((2,), j_fn.start_timestep, np.int32)
    j_xt = jax_schedule.add_noise(JS, jnp.asarray(init), jnp.asarray(noise), jnp.asarray(t0))
    p_xt = sched.add_noise(PS, torch.from_numpy(init), torch.from_numpy(noise), torch.from_numpy(t0))
    np.testing.assert_allclose(p_xt.numpy(), np.asarray(j_xt), rtol=1e-5, atol=1e-5)
    ctx, uncond, p_ctx, p_uncond = _ctx(jax_model)
    ref = jax.jit(j_fn)(params, j_xt, ctx, uncond, jax.random.PRNGKey(0))
    with torch.no_grad():
        out = p_fn(p_xt, p_ctx, p_uncond)
        body = None if sampler == "ddim" else p_fn.body(p_xt, p_ctx, p_uncond, body_draws(p_fn, None))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOOP)
    if body is not None:
        np.testing.assert_allclose(body.numpy(), np.asarray(ref), **LOOP)


@pytest.mark.parametrize("sampler", ["ddim", "euler_a"])
def test_inpaint_loop_matches_jax(models, sampler):
    """ddim through the tiny UNet, euler_a through the stand-in."""
    jax_model, port_model = models
    j_unet, p_unet, params = _unets(models, tiny=sampler == "ddim")
    rng = np.random.default_rng(5)
    init, x_T = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    mask = np.zeros((2, 8, 8, 1), np.float32)
    mask[:, :, :4] = 1.0  # repaint the left half
    j_fn = jax_ld.make_sample_fn(j_unet, JS, 5, sampler=sampler, guidance_scale=7.5, inpaint=True)
    p_fn = port_ld.make_sample_fn(p_unet, PS, 5, sampler=sampler, guidance_scale=7.5, inpaint=True)
    ctx, uncond, p_ctx, p_uncond = _ctx(jax_model)
    key = jax.random.PRNGKey(6)
    ref = np.asarray(jax.jit(j_fn)(params, jnp.asarray(x_T), ctx, uncond, key,
                                   jnp.asarray(mask), jnp.asarray(init)))
    step, blend = jax_draws(key, 5, x_T.shape)
    with torch.no_grad():
        out = p_fn(torch.from_numpy(x_T), p_ctx, p_uncond, noise=step, blend_noise=blend,
                   mask=torch.from_numpy(mask), init_latents=torch.from_numpy(init)).numpy()
        body = None if sampler == "ddim" else p_fn.body(
            torch.from_numpy(x_T), p_ctx, p_uncond, body_draws(p_fn, step, blend), mask=torch.from_numpy(mask),
            init_latents=torch.from_numpy(init)).numpy()
    np.testing.assert_allclose(out, ref, **LOOP)
    if body is not None:
        np.testing.assert_allclose(body, ref, **LOOP)
    keep = np.broadcast_to(mask == 0, out.shape)
    np.testing.assert_array_equal(out[keep], init[keep])
    np.testing.assert_array_equal(ref[keep], init[keep])
    assert np.abs(out[~keep] - init[~keep]).max() > 0.1


def test_pipelines_run_and_repeat_by_seed(models):
    """img2img and inpaint on the tiny models: a 16x16 uint8 image; the same
    seed gives the same bytes, another seed other bytes; inpainting with an
    all-keep mask decodes the init latent itself."""
    _, port_model = models
    rng = np.random.default_rng(7)
    image = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
    kw = dict(prompt="a (red:1.3) cat", image_size=16, time_steps=4, save_dir=None)
    a = pipeline.img2img(port_model, image, strength=0.75, seed=1, **kw)
    assert a.shape == (16, 16, 3) and a.dtype == np.uint8
    assert np.array_equal(a, pipeline.img2img(port_model, image, strength=0.75, seed=1, **kw))
    assert not np.array_equal(a, pipeline.img2img(port_model, image, strength=0.75, seed=2, **kw))
    mask = np.zeros((16, 16), np.uint8)
    mask[:, :8] = 255
    b = pipeline.inpaint(port_model, image, mask, seed=1, **kw)
    assert b.shape == (16, 16, 3) and np.array_equal(b, pipeline.inpaint(port_model, image, mask, seed=1, **kw))
    kept = pipeline.inpaint(port_model, image, np.zeros((16, 16), np.uint8), seed=3, **kw)
    init = pipeline._init_latents(port_model, image, 16, torch.Generator().manual_seed(3))
    from stable_diffusion_pytorch_tpu_torch.utils.data import detransform

    assert np.array_equal(kept, detransform(port_model.decode_latent(init).numpy()[0]))


_NO_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import torch
torch.set_num_threads(2)
from stable_diffusion_pytorch_tpu_torch.scripts.img2img import main
main(sys.argv[1:])
"""
TINY = ("--image-size 16 --sampling-steps 3 --channels-list 16,32 --n-heads 4 --time-emb-dim 32 --n-layers 1 "
        "--autoencoder-channels-list 8,16 --groups 4 --noise-steps 50 --device cpu").split()


@pytest.mark.parametrize("mode", ["img2img", "inpaint"])
def test_img2img_cli_runs(tmp_path, mode):
    """img2img in a process of its own without jax (the CLI stands alone);
    inpaint through ``main`` in this process (no second interpreter)."""
    rng = np.random.default_rng(8)
    (tmp_path / "init.png").write_bytes(encode_png((rng.random((20, 24, 3)) * 255).astype(np.uint8)))
    mask = np.zeros((20, 24), np.uint8)
    mask[5:15] = 255
    (tmp_path / "mask.png").write_bytes(encode_png(mask))
    extra = ["--mask-image", str(tmp_path / "mask.png")] if mode == "inpaint" else ["--strength", "0.6"]
    out = tmp_path / "out"
    argv = ["--init-image", str(tmp_path / "init.png"), "--prompt", "a (red:1.2) cube", "--output-dir", str(out),
            *extra, *TINY]
    if mode == "img2img":
        proc = subprocess.run([sys.executable, "-c", _NO_JAX, *argv], cwd=REPO, capture_output=True, text=True,
                              timeout=300, env={**os.environ, "PYTHONPATH": REPO})
        assert proc.returncode == 0, proc.stderr[-3000:]
    else:
        from stable_diffusion_pytorch_tpu_torch.scripts import img2img as cli

        cli.main(argv)
    png = out / f"{mode}.png"
    assert png.exists()
    assert read_image(str(png)).shape == (16, 16, 3)


def test_img2img_cli_refuses_without_init_image_or_card():
    from stable_diffusion_pytorch_tpu_torch.scripts import img2img as cli

    with pytest.raises(SystemExit, match="--init-image"):
        cli.main(TINY[:-2])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            cli.main(["--init-image", "x.png", *TINY[:-2]])
