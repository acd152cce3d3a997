"""Every sampler of the port vs the JAX package, on the CPU (f32).

Step level (1e-6 relative, 1e-7 absolute where values cross 0): each step
function of ``models/schedule.py`` on the same inputs and the same tables
(the port's schedule is built from the JAX tables, so only the step's own
arithmetic is compared), with JAX's own noise passed to the stochastic
steps; the spacings, ``karras_sigmas`` and ``t_from_sigma`` against JAX's;
``rescale_cfg`` (whose std is the population std, ``jnp.std``'s ddof 0; one
case is a batch where ddof 0 and 1 differ by 40 %). Two looser bars, each
with its reason at its test: ``rescale_zero_terminal_snr`` (the cumprod's
order) and ``karras_sigmas`` (float32 ``pow`` of rho 7).

Loop level: JAX ``make_sample_fn`` against the port's, 5 steps, CFG 7.5,
with the port's own schedule, every case through a stand-in UNet whose eps
depends on x, t and the context, and one case of each sampler family through
the tiny UNet of ``test_torch_port_slice.py`` (one JAX model for the module): 2e-4 absolute and 1e-4 relative on the
latents, the slice test's bar (CFG multiplies each step's eps difference by
7.5, and the two schedules' cumprods differ by ~3e-5 relative). ``ddpm``,
``euler_a`` and ``dpmpp_sde`` take JAX's per-step draws (``split(k, 3)`` per
step, as its scan draws them). Each stand-in loop's pre-drawn body (what a
CUDA graph captures, ``SampleLoop.body``) is held to the same JAX result,
JAX's draws laid out in its draw order. The pipeline: a row of a batch with per-row
seeds gives its solo render's bytes.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu import pipeline as jax_pipeline  # noqa: E402
from stable_diffusion_pytorch_tpu.models import latent_diffusion as jax_ld  # noqa: E402
from stable_diffusion_pytorch_tpu.models import schedule as jax_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu.utils import compat as jax_compat  # noqa: E402
from stable_diffusion_pytorch_tpu_torch import pipeline  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.config import DDPMConfig  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import latent_diffusion as port_ld  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import schedule as sched  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import LatentDiffusion  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.compat import CompatConfig  # noqa: E402
from test_torch_port_sample_graph import body_draws  # noqa: E402
from test_torch_port_slice import PROMPTS, models  # noqa: E402,F401  (module-scoped tiny JAX + port models)

torch.set_num_threads(2)
STEP = dict(rtol=1e-6, atol=1e-7)
LOOP = dict(rtol=1e-4, atol=2e-4)
SHAPE = (2, 4, 4, 4)
JS = jax_schedule.make_schedule(jax_schedule.DDPMConfig())
JS_ZT = jax_schedule.make_schedule(jax_schedule.DDPMConfig(zero_terminal_snr=True))


def _port_tables(js) -> sched.DiffusionSchedule:
    """The port's schedule holding the JAX tables themselves."""
    return sched.DiffusionSchedule(
        **{f.name: torch.from_numpy(np.array(getattr(js, f.name))) for f in dataclasses.fields(sched.DiffusionSchedule)
           if f.name != "noise_steps"}, noise_steps=js.noise_steps)


PS, PS_ZT = _port_tables(JS), _port_tables(JS_ZT)


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(out, ref, **tol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), **(tol or STEP))


# --------------------------------------------------------------------------- #
# step level
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("t,repeat,scale,override", [
    (980, False, 1.0, False), (500, True, 1.0, False), (1, False, 0.8, False), (0, False, 1.0, False),
    (700, False, 1.0, True), (0, True, 0.8, True),
])
def test_ddpm_step_matches_jax(t, repeat, scale, override):
    x, eps, x0 = _rand(t, SHAPE, SHAPE, SHAPE)
    key = jax.random.PRNGKey(t)
    jnoise = jax.random.normal(key, ((1,) + SHAPE[1:]) if repeat else SHAPE, jnp.float32)
    ref, ref_x0 = jax_schedule.ddpm_step(JS, jnp.asarray(eps), jnp.asarray(x), jnp.int32(t), key, repeat_noise=repeat,
                                         scale_factor=scale, x0=jnp.asarray(x0) if override else None)
    out, out_x0 = sched.ddpm_step(PS, torch.from_numpy(eps), torch.from_numpy(x), t, torch.from_numpy(np.array(jnoise)),
                                  repeat_noise=repeat, scale_factor=scale,
                                  x0=torch.from_numpy(x0) if override else None)
    _close(out, ref)
    _close(out_x0, ref_x0)


@pytest.mark.parametrize("t,t_prev,eta,override", [
    (980, 960, 0.0, True), (20, -1, 0.0, True), (500, 400, 0.7, False), (500, 400, 0.7, True), (40, -1, 1.0, False),
])
def test_ddim_step_with_noise_and_x0_matches_jax(t, t_prev, eta, override):
    x, eps, x0 = _rand(t + 1, SHAPE, SHAPE, SHAPE)
    key = jax.random.PRNGKey(t)
    ref, _ = jax_schedule.ddim_step(JS, jnp.asarray(eps), jnp.asarray(x), jnp.int32(t), jnp.int32(t_prev), key=key,
                                    eta=eta, x0=jnp.asarray(x0) if override else None)
    noise = torch.from_numpy(np.array(jax.random.normal(key, SHAPE, jnp.float32)))
    out, _ = sched.ddim_step(PS, torch.from_numpy(eps), torch.from_numpy(x), t, t_prev, eta, noise=noise,
                             x0=torch.from_numpy(x0) if override else None)
    _close(out, ref)


@pytest.mark.parametrize("t,t_prev,t_last,override,zt", [
    (980, 780, 1000, False, False), (780, 580, 980, False, False), (180, -1, 380, False, False),
    (500, 250, 750, True, False), (999, 799, 1000, True, True), (199, -1, 399, True, True),
])
def test_dpmpp_2m_step_matches_jax(t, t_prev, t_last, override, zt):
    js, ps = (JS_ZT, PS_ZT) if zt else (JS, PS)
    x, eps, x0_prev, x0 = _rand(t, SHAPE, SHAPE, SHAPE, SHAPE)
    ref, ref_x0 = jax_schedule.dpmpp_2m_step(js, jnp.asarray(eps), jnp.asarray(x), jnp.int32(t), jnp.int32(t_prev),
                                             jnp.asarray(x0_prev), jnp.int32(t_last),
                                             x0=jnp.asarray(x0) if override else None)
    out, out_x0 = sched.dpmpp_2m_step(ps, torch.from_numpy(eps), torch.from_numpy(x), t, t_prev,
                                      torch.from_numpy(x0_prev), t_last, x0=torch.from_numpy(x0) if override else None)
    _close(out, ref)
    _close(out_x0, ref_x0)


@pytest.mark.parametrize("t", [0, 321, 999])
def test_v_prediction_helpers_match_jax(t):
    x, v, eps, x0 = _rand(t, SHAPE, SHAPE, SHAPE, SHAPE)
    for js, ps in ((JS, PS), (JS_ZT, PS_ZT)):
        ja, js_ = jax_schedule.alpha_sigma_at(js, jnp.int32(t))
        pa, ps_ = sched.alpha_sigma_at(ps, t)
        _close(pa, ja)
        _close(ps_, js_)
        for jfn, pfn, a, b in ((jax_schedule.eps_from_v, sched.eps_from_v, x, v),
                               (jax_schedule.x0_from_v, sched.x0_from_v, x, v),
                               (jax_schedule.v_from_eps_x0, sched.v_from_eps_x0, x0, eps)):
            _close(pfn(torch.from_numpy(a), torch.from_numpy(b), pa, ps_), jfn(jnp.asarray(a), jnp.asarray(b), ja, js_))


@pytest.mark.parametrize("sigma", [0.01, 0.0292, 0.5, 1.0, 3.7, 14.6, 20.0, 1e-3])
def test_t_from_sigma_matches_jax_interp(sigma):
    """On and off the table, and past both of its ends (held constant)."""
    ref = jax_schedule.t_from_sigma(JS, jnp.float32(sigma))
    _close(sched.t_from_sigma(PS, torch.tensor(sigma)), ref)


def test_sigma_tables_match_jax():
    _close(sched.vp_sigmas(PS), jax_schedule.vp_sigmas(JS))
    ts = [980, 490, 20, 0]
    _close(sched.table_sigmas(PS, ts), jax_schedule.table_sigmas(JS, jnp.asarray(ts)))


@pytest.mark.parametrize("n", [1, 2, 5, 10, 20, 50])
def test_karras_sigmas_match_jax(n):
    """The ramps are bit-equal (``jnp.linspace``'s iota / (n - 1)); the sigmas
    go through float32 ``pow`` twice, and the rho-th power (rho 7) multiplies
    an ulp or two by which XLA's and torch's inner power round apart: up to
    1.6e-6 relative at 50 steps (sigma_max 157), so 3e-6 relative here."""
    tab = jax_schedule.vp_sigmas(JS)
    ref = jax_schedule.karras_sigmas(tab[0], tab[-1], n)
    _close(sched.karras_sigmas(sched.vp_sigmas(PS)[0], sched.vp_sigmas(PS)[-1], n), ref, rtol=3e-6, atol=1e-7)


@pytest.mark.parametrize("noise_steps,num_steps", [
    (1000, 50), (1000, 7), (1000, 10), (20, 3), (50, 7), (1000, 999), (999, 13), (1000, 30)])
def test_spacings_match_jax(noise_steps, num_steps):
    assert sched.trailing_timesteps(noise_steps, num_steps) == [
        int(t) for t in np.asarray(jax_schedule.trailing_timesteps(noise_steps, num_steps))]
    assert sched.spaced_timesteps(noise_steps, num_steps) == [
        int(t) for t in np.asarray(jax_schedule.spaced_timesteps(noise_steps, num_steps))]
    assert sched.leading_timesteps(num_steps) == [int(t) for t in np.asarray(jax_schedule.leading_timesteps(num_steps))]


@pytest.mark.parametrize("noise_schedule", ["linear", "cosine", "cubic"])
def test_rescale_zero_terminal_snr_matches_jax(noise_schedule):
    """The cumprod inside runs in another order (XLA's associative scan,
    torch's sequential product: ~1.5e-6 relative on alpha_bar over 1000
    factors), and 1 - alpha_bar[t] / alpha_bar[t-1] cancels it into up to
    5e-6 absolute on the betas: the betas are held to 1e-5 absolute, the
    rescaled alpha_bar to 1e-5 relative, and the terminal one is exactly 0."""
    betas = np.array(jax_schedule.make_betas(noise_schedule, 1000, 1e-4, 0.02))
    ref = np.asarray(jax_schedule.rescale_zero_terminal_snr(jnp.asarray(betas)))
    out = sched.rescale_zero_terminal_snr(torch.from_numpy(betas)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    cfg = dataclasses.replace(DDPMConfig(zero_terminal_snr=True), noise_schedule=noise_schedule)
    ours = sched.make_schedule(cfg).alphas_cumprod.numpy()
    theirs = np.asarray(jax_schedule.make_schedule(jax_schedule.DDPMConfig(
        noise_schedule=noise_schedule, zero_terminal_snr=True)).alphas_cumprod)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-12)
    assert ours[-1] == 0.0 == theirs[-1]


@pytest.mark.parametrize("sigma,sigma_next,eta", [(14.6, 9.0, 1.0), (2.0, 1.2, 0.5), (0.3, 0.0, 1.0), (1.0, 1.0, 1.0)])
def test_euler_and_ancestral_match_jax(sigma, sigma_next, eta):
    x, eps = _rand(7, SHAPE, SHAPE)
    s, sn = torch.tensor(sigma), torch.tensor(sigma_next)
    down, up = sched.ancestral_sigmas(s, sn, eta)
    jdown, jup = jax_schedule.ancestral_sigmas(jnp.float32(sigma), jnp.float32(sigma_next), eta)
    _close(down, jdown)
    _close(up, jup)
    _close(sched.euler_step(torch.from_numpy(x), torch.from_numpy(eps), s, down),
           jax_schedule.euler_step(jnp.asarray(x), jnp.asarray(eps), jnp.float32(sigma), jdown))


@pytest.mark.parametrize("sigma,sigma_next,h_last,eta", [
    (14.6, 9.0, 0.0, 1.0), (9.0, 4.0, 0.48, 1.0), (4.0, 1.5, 0.81, 0.5), (0.5, 0.0, 1.1, 1.0)])
def test_dpmpp_2m_sde_step_matches_jax(sigma, sigma_next, h_last, eta):
    x, d, d_prev = _rand(8, SHAPE, SHAPE, SHAPE)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(3), SHAPE, jnp.float32))
    ref, ref_h = jax_schedule.dpmpp_2m_sde_step(jnp.asarray(x), jnp.asarray(d), jnp.asarray(d_prev), jnp.float32(sigma),
                                                jnp.float32(sigma_next), jnp.float32(h_last), jnp.asarray(noise), eta)
    out, h = sched.dpmpp_2m_sde_step(torch.from_numpy(x), torch.from_numpy(d), torch.from_numpy(d_prev),
                                     torch.tensor(sigma), torch.tensor(sigma_next), torch.tensor(h_last),
                                     torch.from_numpy(noise), eta)
    _close(out, ref)
    if sigma_next > 0:
        _close(h, ref_h)


@pytest.mark.parametrize("shape,phi", [((2, 4, 4, 4), 0.7), ((3, 2, 2, 1), 1.0), ((2, 1, 1, 2), 0.5)])
def test_rescale_cfg_matches_jax_population_std(shape, phi):
    combined, cond = _rand(9, shape, shape)
    cond = cond * np.arange(1, shape[0] + 1, dtype=np.float32).reshape((-1,) + (1,) * (len(shape) - 1))
    ref = jax_ld.rescale_cfg(jnp.asarray(combined), jnp.asarray(cond), phi)
    out = port_ld.rescale_cfg(torch.from_numpy(combined), torch.from_numpy(cond), phi)
    _close(out, ref)
    n = int(np.prod(shape[1:]))
    if n == 2:  # the std's ddof decides this case: sqrt(2) apart, so a sample std would fail it
        assert abs(torch.from_numpy(cond).std(dim=(1, 2, 3), correction=1)[0].item()
                   / torch.from_numpy(cond).std(dim=(1, 2, 3), correction=0)[0].item() - 2 ** 0.5) < 1e-6


def test_unknown_options_raise_as_jax():
    for kw in ({"sampler": "bogus"}, {"prediction_type": "x0"}, {"timestep_spacing": "linspace"}):
        with pytest.raises(ValueError):
            port_ld.make_sample_fn(None, PS, 5, **kw)
    with pytest.raises(ValueError, match="sigma=inf"):
        port_ld.make_sample_fn(None, PS_ZT, 5, sampler="euler")
    with pytest.raises(ValueError, match="v_prediction"):
        port_ld.make_sample_fn(None, PS_ZT, 5, sampler="ddim", timestep_spacing="trailing")
    # DeepCache and inpainting build as JAX's loops do, and refuse what JAX's refuse
    two_levels = type("TwoLevels", (), {"channels_list": (16, 24)})()
    for kw in ({"deep_cache_interval": 3}, {"inpaint": True}, {"inpaint": True, "sampler": "euler"}):
        p_fn, j_fn = port_ld.make_sample_fn(two_levels, PS, 5, **kw), jax_ld.make_sample_fn(two_levels, JS, 5, **kw)
        assert p_fn.start_timestep == j_fn.start_timestep
    for unet, kw in ((two_levels, {"sampler": "euler"}), (None, {}),
                     (type("OneLevel", (), {"channels_list": (16,)})(), {})):
        with pytest.raises(ValueError) as want:
            jax_ld.make_sample_fn(unet, JS, 5, deep_cache_interval=3, **kw)
        with pytest.raises(ValueError, match=str(want.value)[:40]):
            port_ld.make_sample_fn(unet, PS, 5, deep_cache_interval=3, **kw)


def test_sampling_config_fields_equal_jax():
    """The port's txt2img fields are the JAX fields, all of them: name,
    default, help and choices; ``--sampler`` offers all seven samplers."""
    jax_fields = {f.name: f for f in dataclasses.fields(jax_pipeline.SamplingConfig)}
    assert [f.name for f in dataclasses.fields(pipeline.SamplingConfig)] == list(jax_fields)
    for f in dataclasses.fields(pipeline.SamplingConfig):
        assert (f.default, dict(f.metadata)) == (jax_fields[f.name].default, dict(jax_fields[f.name].metadata)), f.name
    assert pipeline.SamplingConfig().__dataclass_fields__["sampler"].metadata["choices"] == list(jax_ld.SAMPLERS)
    assert port_ld.SAMPLERS == jax_ld.SAMPLERS and port_ld.SIGMA_SPACE_SAMPLERS == jax_ld.SIGMA_SPACE_SAMPLERS


# --------------------------------------------------------------------------- #
# loop level
# --------------------------------------------------------------------------- #


def _jax_draws(key, steps: int, shape):
    """The JAX scan's per-step draws: ``k, sub, k_blend = split(k, 3)`` and
    the normal from the second key (``sub`` of the discrete loop, ``k_noise``
    of the sigma-space one)."""
    out, k = [], key
    for _ in range(steps):
        k, sub, _ = jax.random.split(k, 3)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    return out


class _StandIn:
    """A stand-in UNet (JAX ``apply`` form) whose eps depends on x, t and the
    context, so that the CFG branches differ: it compiles in a fraction of
    the tiny UNet's time, and the loops are compared through it as well."""

    @staticmethod
    def apply(params, x, t, ctx):
        return (0.1 * x + 1e-3 * t.astype(jnp.float32)[:, None, None, None]
                + 0.05 * jnp.mean(ctx, axis=(1, 2))[:, None, None, None])


def _stand_in(x, t, ctx):
    return 0.1 * x + 1e-3 * t.float()[:, None, None, None] + 0.05 * ctx.mean(dim=(1, 2))[:, None, None, None]


LOOPS = {
    "ddim_ascending": dict(sampler="ddim", ascending_loop=True, leading_timesteps=True),
    "dpmpp": dict(sampler="dpmpp"),
    "euler": dict(sampler="euler"),
    "euler_karras": dict(sampler="euler", karras=True),
    "heun": dict(sampler="heun"),
    "heun_karras": dict(sampler="heun", karras=True),
    "dpmpp_v_trailing_zt": dict(sampler="dpmpp", prediction_type="v_prediction", timestep_spacing="trailing",
                                zero_terminal_snr=True),
    "dpmpp_guidance_rescale": dict(sampler="dpmpp", guidance_rescale=0.7),
    "ddpm": dict(sampler="ddpm"),
    "ddpm_repeat_noise": dict(sampler="ddpm", repeat_noise=True, scale_factor=0.9),
    "euler_a": dict(sampler="euler_a"),
    "dpmpp_sde_karras": dict(sampler="dpmpp_sde", karras=True),
}
# through the tiny UNet too (its JAX compiles take most of this file's time):
# a zero-terminal-SNR v loop, and a stochastic sigma-space one on fractional t
TINY_UNET_LOOPS = ("dpmpp_v_trailing_zt", "dpmpp_sde_karras")


@pytest.mark.parametrize("case,unet", [(c, "stand_in") for c in LOOPS] + [(c, "tiny") for c in TINY_UNET_LOOPS])
def test_sample_loop_matches_jax(models, case, unet):
    jax_model, port_model = models
    kw = dict(LOOPS[case])
    zt = kw.pop("zero_terminal_snr", False)
    steps = 5
    j_sched = jax_schedule.make_schedule(jax_schedule.DDPMConfig(zero_terminal_snr=zt))
    p_sched = sched.make_schedule(DDPMConfig(zero_terminal_snr=zt))
    j_unet, p_unet, params = ((jax_model.unet, port_model.unet, jax_model.unet_params) if unet == "tiny"
                              else (_StandIn(), _stand_in, None))
    j_fn = jax_ld.make_sample_fn(j_unet, j_sched, steps, guidance_scale=7.5, **kw)
    p_fn = port_ld.make_sample_fn(p_unet, p_sched, steps, guidance_scale=7.5, **kw)
    assert p_fn.start_timestep == j_fn.start_timestep
    x_T = _rand(11, (2, 8, 8, 4))[0]
    ctx = jax_model.encode_prompts(PROMPTS)
    uncond = jax_model.encode_uncond(2, "blurry")
    key = jax.random.PRNGKey(5)
    ref = jax.jit(j_fn)(params, jnp.asarray(x_T), ctx, uncond, key)
    stochastic = kw["sampler"] in ("ddpm", "euler_a", "dpmpp_sde")
    shape = ((1,) + x_T.shape[1:]) if kw.get("repeat_noise") else x_T.shape
    noise = _jax_draws(key, steps, shape) if stochastic else None
    with torch.no_grad():
        out = p_fn(torch.from_numpy(x_T), torch.from_numpy(np.array(ctx)), torch.from_numpy(np.array(uncond)),
                   noise=noise)
        # the loop a CUDA graph captures, JAX's draws laid out for it (the
        # tiny UNet's cases run the same loop code: their eager loop is held)
        body = None if unet == "tiny" else p_fn.body(
            torch.from_numpy(x_T), torch.from_numpy(np.array(ctx)), torch.from_numpy(np.array(uncond)),
            body_draws(p_fn, noise))
    assert np.isfinite(np.asarray(ref)).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOOP)
    if body is not None:
        np.testing.assert_allclose(body.numpy(), np.asarray(ref), **LOOP)


def test_latent_diffusion_sample_defaults_to_ddpm_and_reads_compat(models, monkeypatch):
    """``LatentDiffusion.sample`` names DDPM when no sampler is given, as the
    JAX package's; with ``ascending_sample_loop`` it runs the reference's
    leading, ascending DDIM loop as JAX's does (through the stand-in UNet)."""
    jax_model, port_model = models
    x_T = _rand(12, (2, 8, 8, 4))[0]
    calls, real = [], port_ld.make_sample_fn
    monkeypatch.setattr(port_ld, "make_sample_fn", lambda *a, **kw: calls.append(kw["sampler"]) or real(*a, **kw))
    port_model.sample(torch.from_numpy(x_T), port_model.encode_prompts(PROMPTS), time_steps=2)
    monkeypatch.undo()
    assert calls == ["ddpm"]
    jc, pc = jax_compat.CompatConfig(ascending_sample_loop=True), CompatConfig(ascending_sample_loop=True)
    j = jax_ld.LatentDiffusion(_StandIn(), None, jax_model.autoencoder, jax_model.autoencoder_params,
                               jax_model.text_encoder, jax_model.noise_scheduler, jc)
    p = LatentDiffusion(_stand_in, port_model.autoencoder, port_model.text_encoder, port_model.noise_scheduler,
                        compat=pc)
    ref = j.sample(jnp.asarray(x_T), j.encode_prompts(PROMPTS), time_steps=5, sampler="ddim")
    out = p.sample(torch.from_numpy(x_T), p.encode_prompts(PROMPTS), time_steps=5, sampler="ddim")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOOP)


# --------------------------------------------------------------------------- #
# pipeline
# --------------------------------------------------------------------------- #


def test_batched_row_equals_its_solo_render(models):
    """Per-row seeds: each row of a batch draws its init noise from its own
    seed, so its image has the solo render's bytes (DDIM on the CPU)."""
    _, port_model = models
    kw = dict(image_size=16, time_steps=3, guidance_scale=7.5, save_dir=None, sampler="ddim")
    batch = pipeline.sample(port_model, prompt=["a cat", "a dog", "a cat"], seed=[11, 12, 13], **kw)
    for i, (prompt, seed) in enumerate((("a cat", 11), ("a dog", 12), ("a cat", 13))):
        solo = pipeline.sample(port_model, prompt=[prompt], seed=[seed], **kw)[0]
        assert np.array_equal(batch[i], solo), f"row {i}"
    # one seed for one row is the int seed's render
    assert np.array_equal(pipeline.sample(port_model, prompt="a cat", seed=11, **kw)[0], batch[0])
    with pytest.raises(ValueError, match="one seed per image"):
        pipeline.sample(port_model, prompt=["a", "b"], seed=[1], **kw)


def test_uniform_init_noise_draws_u01(models):
    """``uniform_init_noise``: the init latents are U[0, 1) from the seed's
    generator (the reference's txt2img quirk), where N(0, 1) is the default."""
    _, port_model = models
    p = LatentDiffusion(port_model.unet, port_model.autoencoder, port_model.text_encoder,
                        port_model.noise_scheduler, compat=CompatConfig(uniform_init_noise=True))
    kw = dict(image_size=16, time_steps=2, guidance_scale=1.0, save_dir=None, sampler="ddim")
    img = pipeline.sample(p, prompt="a cat", seed=4, **kw)[0]
    x_T = torch.rand(p.latent_shape(1, 16), generator=torch.Generator().manual_seed(4), dtype=torch.float32)
    lat = p.sample(x_T, p.encode_prompts(["a cat"]), guidance_scale=1.0, time_steps=2, sampler="ddim")
    from stable_diffusion_pytorch_tpu_torch.utils.data import detransform

    assert np.array_equal(detransform(p.decode_latent(lat).numpy()[0]), img)
