"""The reverse loop as one body per signature (``SampleLoop``, the loop cache
of ``LatentDiffusion``), on the CPU: f32, stand-in UNets, tiny shapes.

- The body against JAX: ``SampleLoop.body`` fed JAX's own per-step draws
  (``split(k, 3)`` per step, laid out in the body's draw order by
  :func:`body_draws`) against the jitted JAX ``make_sample_fn``, at the loop
  bar of ``test_torch_port_samplers.py`` (rtol 1e-4, atol 2e-4): here DDIM
  at eta 0.5, inpaint in discrete and sigma space (both stochastic), a
  DeepCache stand-in and a ControlNet stand-in; every sampler, img2img and
  inpaint in the loop tests that already compile its JAX reference through
  the stand-in (``test_torch_port_samplers.py``, ``_img2img.py``: each
  loop's body beside its eager loop).
- The two routes: the pre-drawn body against the eager loop that draws each
  step's noise when it needs it, from one seeded generator, bit for bit, for
  every stochastic sampler with and without inpaint, and through the cache.
- The cache key: one signature makes one entry; each field of the JAX key,
  and each the port adds, makes another; ``attach_controlnet`` clears it;
  the trainers' one-off renders run the eager loop by rule, DreamBooth's
  class images capture.

The graph route itself (capture, replay, A-B-A, a reload, a capture that
syncs) needs a card: ``tests/test_torch_port_cuda.py``.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu.models import latent_diffusion as jax_ld  # noqa: E402
from stable_diffusion_pytorch_tpu.models import schedule as jax_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.config import DDPMConfig  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import latent_diffusion as port_ld  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import schedule as sched  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import LatentDiffusion  # noqa: E402

torch.set_num_threads(2)
LOOP = dict(rtol=1e-4, atol=2e-4)
STEPS = 5
SHAPE = (2, 8, 8, 4)
CTX = (2, 7, 16)
JS = jax_schedule.make_schedule(jax_schedule.DDPMConfig())
PS = sched.make_schedule(DDPMConfig())


def _base(x, t, ctx):
    return 0.1 * x + 1e-3 * t[:, None, None, None] + 0.05 * ctx.mean(axis=(1, 2))[:, None, None, None]


class _JaxStandIn:
    """A UNet stand-in in JAX ``apply`` form: eps depends on x, t and the
    context; DeepCache's trunk is x and t; ControlNet residuals add in."""

    channels_list = (4, 4)
    dtype = jnp.float32

    @staticmethod
    def apply(params, x, t, ctx, control=None, deep_cache=None, return_deep=False):
        t = t.astype(jnp.float32)
        if deep_cache is not None:
            return 0.1 * x + 0.2 * deep_cache + 0.05 * ctx.mean(axis=(1, 2))[:, None, None, None]
        out = _base(x, t, ctx)
        if control is not None:
            out = out + control[0][0] + control[1]
        return (out, 0.5 * x + 1e-3 * t[:, None, None, None]) if return_deep else out


class _JaxNet:
    @staticmethod
    def apply(params, x, t, ctx, hint):
        return (0.01 * x,), 0.05 * jnp.mean(hint, axis=(1, 2, 3))[:, None, None, None] + 0.0 * x


class _PortStandIn(torch.nn.Module):
    """The same stand-in in the port's form; its one parameter places the
    model (``LatentDiffusion.device`` and ``dtype``)."""

    channels_list = (4, 4)

    def __init__(self):
        super().__init__()
        self.conv_in = torch.nn.Conv2d(4, 4, 1)

    def forward(self, x, t, ctx, control=None, deep_cache=None, return_deep=False):
        t = t.float()
        if deep_cache is not None:
            return 0.1 * x + 0.2 * deep_cache + 0.05 * ctx.mean(dim=(1, 2))[:, None, None, None]
        out = 0.1 * x + 1e-3 * t[:, None, None, None] + 0.05 * ctx.mean(dim=(1, 2))[:, None, None, None]
        if control is not None:
            out = out + control[0][0] + control[1]
        return (out, 0.5 * x + 1e-3 * t[:, None, None, None]) if return_deep else out


def _port_net(x, t, ctx, hint):
    return (0.01 * x,), 0.05 * hint.mean(dim=(1, 2, 3))[:, None, None, None] + 0.0 * x


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x_T, init = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    ctx, uncond = (rng.standard_normal(CTX).astype(np.float32) for _ in range(2))
    mask = np.zeros(SHAPE[:3] + (1,), np.float32)
    mask[:, :, :4] = 1.0
    hint = rng.uniform(-1, 1, (SHAPE[0], 64, 64, 3)).astype(np.float32)
    return x_T, ctx, uncond, mask, init, hint


def body_draws(loop, step, blend=None) -> torch.Tensor:
    """Per-step draws (``step[i]``, ``blend[i]``: JAX's, say) as
    ``SampleLoop.body`` takes them: one flat tensor in the loop's draw order."""
    parts = [torch.as_tensor(np.asarray((step if kind == "step" else blend)[i])).reshape(-1)
             for i, kind in loop.draw_order]
    return torch.cat(parts) if parts else torch.zeros(0)


def _jax_draws(key, steps, shape, blend_shape):
    """The JAX scan's per-step draws: (step noise from ``sub``, blend noise
    from ``k_blend``) of ``k, sub, k_blend = split(k, 3)``."""
    step, blend, k = [], [], key
    for _ in range(steps):
        k, sub, k_blend = jax.random.split(k, 3)
        step.append(np.array(jax.random.normal(sub, shape, jnp.float32)))
        blend.append(np.array(jax.random.normal(k_blend, blend_shape, jnp.float32)))
    return step, blend


BODY_CASES = {
    "ddim_eta": dict(sampler="ddim", eta=0.5),
    "inpaint_ddpm": dict(sampler="ddpm", inpaint=True),
    "inpaint_dpmpp_sde": dict(sampler="dpmpp_sde", inpaint=True),
    "deep_cache": dict(sampler="ddim", deep_cache_interval=2),
    "controlnet": dict(sampler="dpmpp", control=True),
}


@pytest.mark.parametrize("case", list(BODY_CASES))
def test_body_matches_jax_with_jax_draws(case):
    kw = dict(BODY_CASES[case])
    control = kw.pop("control", False)
    x_T, ctx, uncond, mask, init, hint = _inputs()
    j_unet = jax_ld._ControlShim(_JaxStandIn(), [_JaxNet()], [0.8]) if control else _JaxStandIn()
    p_unet = port_ld._ControlShim(_PortStandIn(), [_port_net], [0.8], [torch.from_numpy(hint)]) if control \
        else _PortStandIn()
    j_fn = jax.jit(jax_ld.make_sample_fn(j_unet, JS, STEPS, guidance_scale=7.5, **kw))
    loop = port_ld.make_sample_fn(p_unet, PS, STEPS, guidance_scale=7.5, **kw)
    key = jax.random.PRNGKey(7)
    params = (None, (None,), (jnp.asarray(hint),)) if control else None
    extra = (jnp.asarray(mask), jnp.asarray(init)) if kw.get("inpaint") else ()
    ref = np.asarray(j_fn(params, jnp.asarray(x_T), jnp.asarray(ctx), jnp.asarray(uncond), key, *extra))
    noise_shape = ((1,) + SHAPE[1:]) if kw.get("repeat_noise") else SHAPE
    step, blend = _jax_draws(key, STEPS, noise_shape, SHAPE)
    draws = body_draws(loop, step, blend)
    stochastic = kw.get("eta", 0) > 0 or kw["sampler"] in ("ddpm", "euler_a", "dpmpp_sde") or kw.get("inpaint")
    assert bool(loop.draw_order) == bool(stochastic)
    with torch.no_grad():
        out = loop.body(torch.from_numpy(x_T), torch.from_numpy(ctx), torch.from_numpy(uncond), draws,
                        mask=torch.from_numpy(mask) if kw.get("inpaint") else None,
                        init_latents=torch.from_numpy(init) if kw.get("inpaint") else None,
                        hints=[torch.from_numpy(hint)] if control else None).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out, ref, **LOOP)


ROUTE_CASES = [dict(sampler="ddim", eta=0.7), dict(sampler="ddpm"), dict(sampler="ddpm", repeat_noise=True),
               dict(sampler="euler_a"), dict(sampler="dpmpp_sde", karras=True)]


@pytest.mark.parametrize("inpaint", [False, True], ids=["txt2img", "inpaint"])
@pytest.mark.parametrize("kw", ROUTE_CASES, ids=lambda kw: "_".join(str(v) for v in kw.values()))
def test_predrawn_body_equals_the_per_step_draws_bit_for_bit(kw, inpaint):
    """One seeded generator: every draw made before the body, in the eager
    loop's order, gives the eager loop's x_0 bit for bit, by the loop itself
    and by the cache's entry (the CPU route runs the pre-drawn body)."""
    x_T, ctx, uncond, mask, init, _ = (torch.from_numpy(a) for a in _inputs(2))
    extra = dict(mask=mask, init_latents=init) if inpaint else {}
    loop = port_ld.make_sample_fn(_PortStandIn(), PS, STEPS, guidance_scale=7.5, inpaint=inpaint, **kw)
    with torch.no_grad():
        eager = loop(x_T, ctx, uncond, torch.Generator().manual_seed(3), **extra)
        draws = loop.predraw(torch.Generator().manual_seed(3), x_T.shape)
        pre = loop.body(x_T, ctx, uncond, draws, **extra)
        model = LatentDiffusion(_PortStandIn(), None, None, PS)
        cached = model.sample_loop(x_T, ctx, STEPS, guidance_scale=7.5, inpaint=inpaint, **kw)
        via_cache = cached(x_T, ctx, uncond, torch.Generator().manual_seed(3), **extra)
    assert draws.numel() == sum(int(np.prod(s)) for s in loop.draw_shapes(x_T.shape)) > 0
    assert torch.equal(pre, eager) and torch.equal(via_cache, eager)
    with pytest.raises(ValueError, match="pre-drawn values"):
        loop.body(x_T, ctx, uncond, draws[1:], **extra)


def test_cache_key_holds_every_signature_field():
    """One entry per signature (a repeat returns the same entry); every
    field of the JAX package's key makes a new one, and so does each field
    the port fixes besides (dtype, strength, inpaint, the compat flags);
    ``attach_controlnet`` clears the cache, as JAX's clears its ``_jit_cache``."""
    x, ctx, *_ = (torch.from_numpy(a) for a in _inputs(3))
    hint = torch.zeros(SHAPE[0], 64, 64, 3)
    model = LatentDiffusion(_PortStandIn(), None, None, PS)
    model.controlnet = [_port_net]
    base = dict(sampler="ddim", guidance_scale=7.5)

    def entry(x=x, ctx=ctx, steps=STEPS, hints=None, scale=1.0, **kw):
        return model.sample_loop(x, ctx, steps, hints, scale, **{**base, **kw})

    first = entry()
    assert entry() is first and len(model._loops) == 1
    variants = [
        dict(steps=STEPS + 1), dict(sampler="dpmpp"), dict(guidance_scale=5.0), dict(eta=0.5),
        dict(repeat_noise=True), dict(scale_factor=0.9), dict(karras=True), dict(prediction_type="v_prediction"),
        dict(timestep_spacing="trailing"), dict(guidance_rescale=0.7), dict(x=torch.zeros(1, 8, 8, 4)),
        dict(ctx=torch.zeros(2, 14, 16)), dict(hints=hint), dict(hints=torch.zeros(SHAPE[0], 32, 32, 3)),
        dict(hints=hint, scale=0.5), dict(deep_cache_interval=2),
        # the port's own fields
        dict(x=x.double()), dict(ctx=ctx.double()), dict(strength=0.6), dict(inpaint=True),
        dict(reference_cfg_formula=True), dict(ascending_loop=True), dict(leading_timesteps=True),
    ]
    for i, kw in enumerate(variants, start=2):
        e = entry(**kw)
        assert e is not first and len(model._loops) == i, kw
        assert entry(**kw) is e
    model.attach_controlnet(_port_net)
    assert len(model._loops) == 0
    assert entry() is not first and len(model._loops) == 1


def test_sample_goes_through_the_cache_and_the_trainers_render_eagerly():
    """``LatentDiffusion.sample`` makes one entry per signature and returns
    the eager loop's x_0; a model captures on a card unless it was built
    with ``capture=False``, as ``sampling_model`` (the trainers' one-off
    renders) builds by rule unless asked to capture."""
    from stable_diffusion_pytorch_tpu_torch.models.build import sampling_model

    x, ctx, *_ = (torch.from_numpy(a) for a in _inputs(4))
    model = LatentDiffusion(_PortStandIn(), None, None, PS)
    a = model.sample(x, ctx, guidance_scale=1.0, time_steps=STEPS, sampler="ddpm",
                     generator=torch.Generator().manual_seed(5))
    b = model.sample(x, ctx, guidance_scale=1.0, time_steps=STEPS, sampler="ddpm",
                     generator=torch.Generator().manual_seed(5))
    ref = port_ld.make_sample_fn(_PortStandIn(), PS, STEPS, sampler="ddpm", guidance_scale=1.0)(
        x, ctx, torch.zeros_like(ctx), torch.Generator().manual_seed(5))
    assert len(model._loops) == 1 and torch.equal(a, ref) and torch.equal(b, ref)
    assert model.capture and not LatentDiffusion(_PortStandIn(), None, None, PS, capture=False).capture
    trained = LatentDiffusion(_PortStandIn(), None, None, PS, compute_dtype=torch.float32)
    assert sampling_model(trained).capture is False and sampling_model(trained, capture=True).capture


def test_dreambooth_class_images_capture(tmp_path, monkeypatch):
    """DreamBooth's class images, many batches of one signature, sample
    with a model that captures its loop on a card (``sampling_model(...,
    capture=True)``): every batch goes to that one model."""
    import logging
    from types import SimpleNamespace

    from stable_diffusion_pytorch_tpu_torch import pipeline
    from stable_diffusion_pytorch_tpu_torch.scripts import train_dreambooth

    seen = []

    def fake_sample(model, prompt, seed, **kw):
        seen.append((model, len(prompt), seed))
        return [np.zeros((8, 8, 3), np.uint8)] * len(prompt)

    monkeypatch.setattr(pipeline, "sample", fake_sample)
    cfg = SimpleNamespace(class_data_dir=str(tmp_path / "class"), num_class_images=6, class_prompt="a dog",
                          class_sampling_steps=3, guidance_scale=7.5, seed=4)
    trained = LatentDiffusion(_PortStandIn(), None, None, PS, compute_dtype=torch.float32)
    made = train_dreambooth.ensure_class_images(trained, cfg, 8, logging.getLogger("class_images"))
    assert made == 6 and [(n, s) for _, n, s in seen] == [(4, [4, 5, 6, 7]), (2, [8, 9])]
    assert seen[0][0] is seen[1][0] and seen[0][0].capture
    assert len(list((tmp_path / "class").iterdir())) == 6
