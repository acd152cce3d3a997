"""LoRA merge, DeepCache and ControlNet: the port vs the JAX package, on the
CPU (f32), through the tiny models of ``test_torch_port_slice.py`` (one JAX
model for the module) and one tiny JAX ControlNet per hint depth.

Held: ``merge_lora`` at 1e-6 relative on the merged weights, for both target
sets (the port's target rule picks the JAX set's weights, name for name);
one UNet call with ``return_deep`` and one on the returned trunk
(``deep_cache``), one with ControlNet residuals, one ControlNet forward
(hint depth 3, the original's ``input_hint_block`` indices) at 1e-4; 5-step
loops at the slice's bar (rtol 1e-4, atol 2e-4): DeepCache at interval 2
(ddim), ControlNet with one net and with two (summed, per-net scales); the
JAX ``ValueError``s of DeepCache. Then the port's txt2img CLI with the seven
new flags, once with all of them in a process without jax.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu.models import controlnet as jax_cn  # noqa: E402
from stable_diffusion_pytorch_tpu.models import latent_diffusion as jax_ld  # noqa: E402
from stable_diffusion_pytorch_tpu.models import lora as jax_lora  # noqa: E402
from stable_diffusion_pytorch_tpu.models import schedule as jax_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu.models import unet as jax_unet  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.config import DDPMConfig, UnetConfig  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import latent_diffusion as port_ld  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import lora as port_lora  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import schedule as sched  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.controlnet import ControlNet, init_controlnet_from_unet  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import convert  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.data import encode_png, read_image  # noqa: E402
from test_torch_port_slice import PROMPTS, UNET_KW, models, random_params  # noqa: E402,F401

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP = dict(rtol=1e-4, atol=2e-4)
CALL = dict(rtol=1e-4, atol=1e-4)
JS = jax_schedule.make_schedule(jax_schedule.DDPMConfig())
PS = sched.make_schedule(DDPMConfig())
J_CFG = jax_unet.UnetConfig(**UNET_KW)


def _inputs(seed: int, batch: int = 2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 8, 8, 4)).astype(np.float32)
    t = np.array([7, 400][:batch], np.int32)
    ctx = (0.5 * rng.standard_normal((batch, 77, 32))).astype(np.float32)
    return x, t, ctx


@pytest.fixture(scope="module")
def nets():
    """Tiny JAX ControlNets (every parameter random, the zero convs
    included) and their port copies: {hint depth: [(jax module, params, port net)] x 2}."""
    out = {}
    x, t, ctx = _inputs(0, 1)
    for depth in (1, 3):
        j_mod = jax_cn.ControlNet.from_unet_config(4, 4, J_CFG, hint_downsamples=depth)
        hint = jnp.zeros((1, 8 * 2 ** depth, 8 * 2 ** depth, 3))
        pairs = []
        for seed in (10, 11)[: 2 if depth == 1 else 1]:
            params = random_params(j_mod, seed, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), hint)
            net = ControlNet(4, 4, UnetConfig(**UNET_KW), hint_downsamples=depth)
            net.load_state_dict(convert.to_torch(convert.controlnet_state_dict(params, J_CFG)), strict=True)
            pairs.append((j_mod, params, net.eval()))
        out[depth] = pairs
    return out


def _hint(seed: int, depth: int, batch: int = 2):
    side = 8 * 2 ** depth
    return np.random.default_rng(seed).uniform(-1, 1, (batch, side, side, 3)).astype(np.float32)


# --------------------------------------------------------------------------- #
# LoRA
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("targets", port_lora.TARGET_SETS)
def test_merge_lora_matches_jax(models, targets):
    jax_model, port_model = models
    lora = jax_lora.init_lora(jax.random.PRNGKey(1), jax_model.unet_params, rank=3, targets=targets)
    # a trained B: random, so the merge changes every targeted weight
    leaves, tree = jax.tree_util.tree_flatten(lora)
    rng = np.random.default_rng(2)
    lora = jax.tree_util.tree_unflatten(tree, [np.asarray(v) if np.asarray(v).any()
                                               else rng.standard_normal(v.shape).astype(np.float32) for v in leaves])
    merged = convert.unet_state_dict(jax_lora.merge_lora(jax_model.unet_params, lora, 0.7), J_CFG)
    p_lora = convert.to_torch(convert.lora_state_dict(lora, J_CFG))
    base = port_model.unet.state_dict()
    # the port's target rule picks exactly the weights the JAX tree factors
    picked = {n[: -len(".weight")] for n, w in base.items() if port_lora.is_lora_target(n, w, targets)}
    assert picked == {k.rsplit(".", 1)[0] for k in p_lora}
    out = port_lora.merge_lora(base, p_lora, 0.7)
    changed = 0
    for name, value in out.items():
        np.testing.assert_allclose(value.numpy(), merged[name], rtol=1e-6, atol=1e-6 * np.abs(merged[name]).max())
        changed += not torch.equal(value, base[name])
    assert changed == len(picked)


def test_init_lora_and_bad_factors(models):
    _, port_model = models
    base = port_model.unet.state_dict()
    fresh = port_lora.init_lora(base, 4, "attn_mlp", torch.Generator().manual_seed(0))
    merged = port_lora.merge_lora(base, fresh, 1.0)  # B = 0: the base model
    assert all(torch.equal(merged[n], base[n]) for n in base)
    name = next(iter(fresh)).rsplit(".", 1)[0]
    with pytest.raises(ValueError, match="does not fit"):
        port_lora.merge_lora(base, {f"{name}.lora_a": torch.zeros(3, 2), f"{name}.lora_b": torch.zeros(2, 5)}, 1.0)
    with pytest.raises(ValueError, match="no UNet weight"):
        port_lora.merge_lora(base, {"nowhere.lora_a": torch.zeros(1, 1), "nowhere.lora_b": torch.zeros(1, 1)}, 1.0)
    with pytest.raises(ValueError, match="unknown lora targets"):
        port_lora.init_lora(base, 4, "all")


# --------------------------------------------------------------------------- #
# the UNet's DeepCache and ControlNet inputs, the ControlNet itself
# --------------------------------------------------------------------------- #


def test_unet_deep_cache_calls_match_jax(models):
    jax_model, port_model = models
    x, t, ctx = _inputs(3)
    apply = jax_model.unet.apply  # jitted: one compile costs less than eager dispatch's first call
    x2 = x + 0.1  # a later step: only the level-0 blocks run, on the cached trunk

    def both(p, x, t, ctx, x2, t2):
        out, deep = apply(p, x, t, ctx, return_deep=True)
        return out, deep, apply(p, x2, t2, ctx, deep_cache=deep)

    ref, ref_deep, ref2 = jax.jit(both)(jax_model.unet_params, x, t, ctx, x2, t - 5)
    with torch.no_grad():
        out, deep = port_model.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), return_deep=True)
        out2 = port_model.unet(torch.from_numpy(x2), torch.from_numpy(t - 5), torch.from_numpy(ctx), deep_cache=deep)
    assert deep.shape == (2, 8, 8, UNET_KW["channels_list"][1])
    for o, r in ((out, ref), (deep, ref_deep), (out2, ref2)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **CALL)
    with pytest.raises(ValueError, match="mutually exclusive"):
        port_model.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), deep_cache=deep,
                        control=((), deep))


def test_controlnet_and_controlled_unet_match_jax(models, nets):
    """The hint block at depth 3 (indices 0-14), the residuals, and the UNet
    that adds them."""
    jax_model, port_model = models
    x, t, ctx = _inputs(4)
    j_mod, params, net = nets[3][0]
    hint = _hint(5, 3)
    def both(cn_params, unet_params, x, t, ctx, hint):
        control = j_mod.apply(cn_params, x, t, ctx, hint)
        return control, jax_model.unet.apply(unet_params, x, t, ctx, control=control)

    (ref_skips, ref_mid), ref = jax.jit(both)(params, jax_model.unet_params, x, t, ctx, hint)
    with torch.no_grad():
        skips, mid = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), torch.from_numpy(hint))
        out = port_model.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), control=(skips, mid))
    assert len(skips) == len(ref_skips) and sorted(k for k in net.state_dict() if k.startswith("input_hint")) == \
        sorted(f"input_hint_block.{i}.{p}" for i in range(0, 15, 2) for p in ("weight", "bias"))
    for o, r in zip((*skips, mid, out), (*ref_skips, ref_mid, ref)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **CALL)


def test_controlnet_from_unet_and_zero_init_is_a_no_op(models):
    """A ControlNet copied from the UNet with its zero convs at zero leaves
    the UNet's output as it is (JAX's ``init_controlnet_from_unet``)."""
    _, port_model = models
    net = init_controlnet_from_unet(port_model.unet, ControlNet(4, 4, UnetConfig(**UNET_KW), hint_downsamples=1))
    own = net.state_dict()
    assert all(torch.equal(own[n], v) for n, v in port_model.unet.state_dict().items() if n in own)
    net.zero_init()
    x, t, ctx = (torch.from_numpy(a) for a in _inputs(6))
    with torch.no_grad():
        controlled = port_ld._ControlShim(port_model.unet, [net], [1.0], [torch.from_numpy(_hint(1, 1))])(x, t, ctx)
        assert torch.equal(controlled, port_model.unet(x, t, ctx))


# --------------------------------------------------------------------------- #
# loops
# --------------------------------------------------------------------------- #


def _ctx(jax_model):
    ctx, uncond = jax_model.encode_prompts(PROMPTS), jax_model.encode_uncond(2, "blurry")
    return ctx, uncond, torch.from_numpy(np.array(ctx)), torch.from_numpy(np.array(uncond))


def test_deep_cache_loop_matches_jax(models):
    jax_model, port_model = models
    j_fn = jax_ld.make_sample_fn(jax_model.unet, JS, 5, sampler="ddim", guidance_scale=7.5, deep_cache_interval=2)
    p_fn = port_ld.make_sample_fn(port_model.unet, PS, 5, sampler="ddim", guidance_scale=7.5, deep_cache_interval=2)
    x_T = np.random.default_rng(7).standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx, uncond, p_ctx, p_uncond = _ctx(jax_model)
    ref = jax.jit(j_fn)(jax_model.unet_params, jnp.asarray(x_T), ctx, uncond, jax.random.PRNGKey(0))
    calls = []
    hook = port_model.unet.register_forward_pre_hook(lambda m, a, kw: calls.append("deep_cache" in kw),
                                                     with_kwargs=True)
    try:
        with torch.no_grad():
            out = p_fn(torch.from_numpy(x_T), p_ctx, p_uncond)
    finally:
        hook.remove()
    assert calls == [False, True, False, True, False]  # refresh on steps 0, 2, 4
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOOP)


def test_deep_cache_refusals_are_jax_s(models, nets):
    _, port_model = models
    with pytest.raises(ValueError, match="discrete samplers"):
        port_ld.make_sample_fn(port_model.unet, PS, 5, sampler="euler", deep_cache_interval=2)
    shim = port_ld._ControlShim(port_model.unet, [nets[1][0][2]], [1.0], [torch.zeros(1, 16, 16, 3)])
    with pytest.raises(ValueError, match="plain UNetModel"):
        port_ld.make_sample_fn(shim, PS, 5, sampler="ddim", deep_cache_interval=2)
    one_level = type("OneLevel", (), {"channels_list": (16,)})()
    with pytest.raises(ValueError, match=">=2-level"):
        port_ld.make_sample_fn(one_level, PS, 5, sampler="ddim", deep_cache_interval=2)


@pytest.mark.parametrize("n_nets", [1, 2])
def test_controlnet_loop_matches_jax(models, nets, n_nets):
    """Hints at batch 1, tiled to CFG's doubled batch of 2, as JAX tiles them."""
    jax_model, port_model = models
    pairs = nets[1][:n_nets]
    scales = [0.7, 1.3][:n_nets]
    hints = [_hint(20 + i, 1, batch=1) for i in range(n_nets)]
    x_T = np.random.default_rng(8).standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx, uncond = jax_model.encode_prompts(PROMPTS[:1]), jax_model.encode_uncond(1, "blurry")
    j_shim = jax_ld._ControlShim(jax_model.unet, [p[0] for p in pairs], scales)
    j_fn = jax_ld.make_sample_fn(j_shim, JS, 5, sampler="ddim", guidance_scale=7.5)
    packed = (jax_model.unet_params, tuple(p[1] for p in pairs), tuple(jnp.asarray(h) for h in hints))
    ref = jax.jit(j_fn)(packed, jnp.asarray(x_T), ctx, uncond, jax.random.PRNGKey(0))
    port_model.attach_controlnet([p[2] for p in pairs])
    try:
        shim = port_model.denoiser([torch.from_numpy(h) for h in hints], scales)
        p_fn = port_ld.make_sample_fn(shim, PS, 5, sampler="ddim", guidance_scale=7.5)
        with torch.no_grad():
            out = p_fn(torch.from_numpy(x_T), torch.from_numpy(np.array(ctx)), torch.from_numpy(np.array(uncond)))
    finally:
        port_model.controlnet = None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOOP)


# --------------------------------------------------------------------------- #
# the txt2img CLI with the new flags
# --------------------------------------------------------------------------- #

_NO_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import torch
torch.set_num_threads(2)
from stable_diffusion_pytorch_tpu_torch.scripts.txt2img import main
main(sys.argv[1:])
"""
TINY_FLAGS = ("--image-size 16 --sampling-steps 4 --channels-list 16,32 --n-heads 4 --time-emb-dim 32 "
              "--n-layers 1 --autoencoder-channels-list 8,16 --groups 4 --noise-steps 50 --device cpu").split()
TINY_CFG = UnetConfig(channels_list=[16, 32], n_heads=4, time_emb_dim=32, n_layers=1)


def _ckpt(path, params):
    save_checkpoint(str(path / "checkpoint-3"), {"step": 3, "params": params, "ema_params": None})
    return str(path)


def test_txt2img_cli_serves_the_new_flags(tmp_path):
    """``--lora-checkpoint``/``--lora-scale``, ``--textual-inversion``,
    ``--controlnet-checkpoint`` (two nets, a comma list), ``--control-image``,
    ``--control-scale`` and ``--deep-cache-interval``, each from a checkpoint
    in the port's layout, over a ``--unet-checkpoint`` with no weight at zero
    (random init zeroes each transformer's proj_out, which would hide an
    attention LoRA); each feature's image differs from the one without it.
    The run with every flag is a process of its own without jax; the others
    go through ``main`` in this process."""
    from stable_diffusion_pytorch_tpu_torch.models.build import build_controlnet
    from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel
    from stable_diffusion_pytorch_tpu_torch.scripts import txt2img

    gen = torch.Generator().manual_seed(0)
    unet = UNetModel(4, 4, TINY_CFG)  # torch's default init: no weight at zero
    base = ["--unet-checkpoint", _ckpt(tmp_path / "unet", unet.state_dict())]
    lora = port_lora.init_lora(unet.state_dict(), 2, "attn", gen)
    lora = {k: torch.randn(v.shape, generator=gen) for k, v in lora.items()}
    net = build_controlnet(TINY_CFG, type("V", (), {"latent_channels": 4, "groups": 4,
                                                    "autoencoder_channels_list": [8, 16]})(), device="cpu")
    for p in net.parameters():  # a trained net: no zero conv left at zero
        p.data.normal_(0.0, 0.05, generator=gen)
    hint = (np.random.default_rng(9).random((16, 16, 3)) * 255).astype(np.uint8)
    (tmp_path / "hint.png").write_bytes(encode_png(hint))
    ti = tmp_path / "ti"
    _ckpt(ti, {"ti": torch.randn(2, 768, generator=gen)})
    (ti / "textual_inversion.json").write_text(json.dumps({"placeholder_token": "<sks>", "num_vectors": 2}))
    runs = {
        "plain": [],
        "lora": ["--lora-checkpoint", _ckpt(tmp_path / "lora", lora), "--lora-scale", "0.8"],
        "all": ["--lora-checkpoint", str(tmp_path / "lora"), "--textual-inversion", str(ti),
                "--controlnet-checkpoint", ",".join([_ckpt(tmp_path / "cn", net.state_dict())] * 2),
                "--control-image", f"{tmp_path / 'hint.png'},{tmp_path / 'hint.png'}", "--control-scale", "0.5",
                "--deep-cache-interval", "0"],
        "deep_cache": ["--deep-cache-interval", "2"],
    }
    images = {}
    for name, flags in runs.items():
        argv = ["--prompt", "a <sks> (cube:1.2)", "--output-dir", str(tmp_path / "out"), "--output-name", name,
                *base, *flags, *TINY_FLAGS]
        if name == "all":  # every flag at once, in a process of its own without jax
            proc = subprocess.run([sys.executable, "-c", _NO_JAX, *argv], cwd=REPO, capture_output=True, text=True,
                                  timeout=300, env={**os.environ, "PYTHONPATH": REPO})
            assert proc.returncode == 0, proc.stderr[-3000:]
        else:
            txt2img.main(argv)
        images[name] = read_image(str(tmp_path / "out" / f"{name}.png"))
        assert images[name].shape == (16, 16, 3)
    assert not np.array_equal(images["lora"], images["plain"])
    assert not np.array_equal(images["all"], images["lora"])
    assert not np.array_equal(images["deep_cache"], images["plain"])
