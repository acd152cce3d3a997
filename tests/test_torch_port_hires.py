"""The hires slice, port vs JAX package, at a tiny size on the CPU (f32).

- The split attention backward (K4/K5): the port's plain backward, which the
  split kernels are held to on the card, against the JAX package's Pallas
  ``flash_attention_bwd_streaming`` (K5) and ``flash_attention_bwd`` (K4) in
  interpret mode, ragged kv. 1e-5: f32 sums over 200 kv rows in another order.
- The forward at kv past the crossover: the port's against the JAX
  ``flash_attention`` forced onto its streaming kernel (K2); 2e-5, as the
  JAX package holds K2 to its own einsum.
- Backward routing: the port's :func:`backward_route` against the kernel the
  JAX package's ``_flash_bwd`` calls, for the same kv length and environment.
- ``strength``: timesteps and ``start_timestep`` against JAX's
  ``make_sample_fn``, halves included (Python's ``round``); the loops are
  compared through a stand-in UNet whose eps depends on t, so the latents
  agree only if the two step sequences do (1e-4 relative: f32 steps whose
  values grow to ~40; one step more or less moves them by far more).
- The latent upscale against ``jax.image.resize`` at factors 2 and 1.5; 1e-6.
- Tiled decode against JAX's ``decode_latent`` on the same tiny VAE; 1e-4, as
  the whole decode in ``test_torch_port_slice.py``.
- The refine stage with JAX's own noise passed in: q-sample to
  ``start_timestep``, then 3 DDIM + CFG 7.5 steps at 16x16 against JAX's
  ``_hires_refine``; as the 5-step loop there (1e-4 relative, 2e-4 absolute).
- The txt2img CLI with ``--hires-scale 2 --vae-tile`` in a process without jax.
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
from stable_diffusion_pytorch_tpu.ops import flash_attention as jax_fa  # noqa: E402
from stable_diffusion_pytorch_tpu.ops import flash_attention_bwd as jax_fa_bwd  # noqa: E402
from stable_diffusion_pytorch_tpu_torch import pipeline  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.config import DDPMConfig  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import make_sample_fn  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.schedule import make_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.ops.flash_attention import (  # noqa: E402
    backward_route,
    flash_attention,
    flash_attention_bwd_plain,
)
from test_torch_port_cli import _NO_JAX, REPO, TINY, _read_png  # noqa: E402
from test_torch_port_slice import PROMPTS, models  # noqa: E402,F401  (module-scoped tiny JAX + port models)

torch.set_num_threads(2)


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_split_backward_plain_matches_pallas_k4_and_k5():
    b, n, m, h, d = 1, 48, 200, 2, 8
    q, k, v, do = _rand(0, (b, n, h, d), (b, m, h, d), (b, m, h, d), (b, n, h, d))
    scale = d ** -0.5
    jargs = [jnp.asarray(a) for a in (q, k, v, do)]
    k5 = jax_fa_bwd.flash_attention_bwd_streaming(*jargs, scale, interpret=True, block_n=64, block_m=128)
    k4 = jax_fa_bwd.flash_attention_bwd(*jargs, scale, interpret=True)
    ours = flash_attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, do)), scale)
    for got, ref5, ref4 in zip(ours, k5, k4):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref5), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref4), rtol=1e-5, atol=1e-5)


def test_forward_matches_the_streaming_kernel(monkeypatch):
    monkeypatch.setenv("SD_FLASH_KV_RESIDENT_MAX", "64")  # force K2
    monkeypatch.setenv("SD_FLASH_BLOCK_M", "128")
    q, k, v = _rand(1, (2, 96, 2, 40), (2, 300, 2, 40), (2, 300, 2, 40))
    ref = jax_fa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), 40 ** -0.5, interpret=True)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), 40 ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kv_len,env", [
    (16384, {}), (9216, {}), (9089, {}), (9217, {}), (77, {}), (4096, {}),
    (77, {"SD_FLASH_BWD": "split"}), (4096, {"SD_FLASH_BWD": "split"}), (4096, {"SD_FLASH_BWD": "fused"}),
    (16384, {"SD_FLASH_BWD": "fused"}),
])
def test_backward_route_matches_jax(kv_len, env, monkeypatch):
    for name in ("SD_FLASH_BWD", "SD_FLASH_KV_RESIDENT_MAX", "SD_FLASH_KV_RESIDENT_MAX_BWD"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for fn, route in (("flash_attention_bwd_streaming", "split"), ("flash_attention_bwd", "split"),
                      ("flash_attention_bwd_fused", "fused")):
        monkeypatch.setattr(jax_fa_bwd, fn, lambda *a, route=route, **kw: route)
    k = jnp.zeros((1, kv_len, 1, 8))
    assert jax_fa._flash_bwd(0.35, True, (k, k, k), k) == backward_route(kv_len, env)


class _TUnet:
    """Stand-in UNet whose eps depends on t (JAX ``apply`` form)."""

    @staticmethod
    def apply(params, x, t, ctx):
        return 0.1 * x + 1e-3 * t.astype(jnp.float32)[:, None, None, None]


def _t_unet(x, t, ctx):
    return 0.1 * x + 1e-3 * t.float()[:, None, None, None]


@pytest.mark.parametrize("steps,strength", [
    (10, 0.25), (5, 0.5), (10, 0.6), (50, 0.75), (4, 0.1), (7, 1.0), (1000, 0.3),
])
def test_strength_truncates_the_schedule_as_jax(steps, strength):
    j_fn = jax_ld.make_sample_fn(_TUnet(), jax_schedule.make_schedule(jax_schedule.DDPMConfig()), steps,
                                 guidance_scale=1.0, strength=strength)
    fn = make_sample_fn(_t_unet, make_schedule(DDPMConfig()), steps, guidance_scale=1.0, strength=strength)
    assert fn.start_timestep == j_fn.start_timestep
    x, ctx = _rand(2, (1, 4, 4, 4), (1, 3, 8))
    ref = j_fn(None, jnp.asarray(x), jnp.asarray(ctx), jnp.zeros_like(ctx), jax.random.PRNGKey(0))
    out = fn(torch.from_numpy(x), torch.from_numpy(ctx), None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("scale", [2.0, 1.5])
def test_upscale_latent_matches_jax_image_resize(scale):
    (x,) = _rand(3, (2, 7, 5, 4))
    h2, w2 = int(round(7 * scale)), int(round(5 * scale))
    ref = jax.image.resize(jnp.asarray(x), (2, h2, w2, 4), method="bilinear")
    out = pipeline.upscale_latent(torch.from_numpy(x), scale)
    assert out.shape == (2, h2, w2, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_tiled_decode_matches_jax(models):
    jax_model, port_model = models
    lat = _rand(4, (1, 14, 12, 4))[0] * 0.5
    ref = jax.jit(lambda z: jax_model.decode_latent(z, tile=10, tile_overlap=4))(jnp.asarray(lat))
    out = port_model.decode_latent(torch.from_numpy(lat), tile=10, tile_overlap=4)
    assert out.shape == (1, 28, 24, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    whole = port_model.decode_latent(torch.from_numpy(lat))
    torch.testing.assert_close(port_model.decode_latent(torch.from_numpy(lat), tile=20), whole, rtol=0, atol=0)
    with pytest.raises(ValueError):
        port_model.decode_latent(torch.from_numpy(lat), tile=8, tile_overlap=4)


def test_hires_refine_matches_jax(models):
    jax_model, port_model = models
    x0 = _rand(5, (2, 8, 8, 4))[0] * 0.5
    key = jax.random.PRNGKey(5)
    kw = dict(guidance_scale=7.5, sampler="ddim", time_steps=5, hires_scale=2.0, hires_strength=0.6,
              negative_prompt="blurry", eta=0.0)
    ref = jax_pipeline._hires_refine(
        jax_model, jnp.asarray(x0), jax_model.encode_prompts(PROMPTS), key=key, prediction_type="epsilon",
        timestep_spacing="even", guidance_rescale=0.0, **kw,
    )
    noise = jax.random.normal(jax.random.split(key)[0], (2, 16, 16, 4), jnp.float32)  # JAX's k_noise draw
    out = pipeline.hires_refine(port_model, torch.from_numpy(x0), port_model.encode_prompts(PROMPTS),
                                noise=torch.from_numpy(np.array(noise)), **kw)
    assert out.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=2e-4)


def test_txt2img_cli_hires_fix_without_jax(tmp_path):
    out = tmp_path / "imgs"
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, *TINY, "--hires-scale", "2", "--hires-strength", "0.6",
         "--vae-tile", "20", "--output-dir", str(out), "--output-name", "big"],
        capture_output=True, text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO), cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(os.listdir(out)) == ["big.png"]
    assert _read_png(out / "big.png").shape == (64, 64, 3)
