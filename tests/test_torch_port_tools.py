"""The port's evaluation and interop tools (``stable_diffusion_pytorch_tpu_torch/scripts/``) against
the JAX package's (``tools/``), on the CPU at tiny sizes.

- ``export_torch``: a port checkpoint whose weights are the converter's
  (``convert.unet_state_dict`` / ``autoencoder_state_dict`` of JAX params),
  the EMA weights preferred where the checkpoint has them, exports key for
  key and tensor for tensor what JAX's ``export_reference_unet`` /
  ``export_reference_autoencoder`` writes.
- ``convert_inception``: the ``.npz`` from a synthetic torchvision state dict,
  ``.pth`` and ``.safetensors``, holds JAX ``convert_torchvision_inception``'s
  tree flattened as ``tools/convert_inception.py`` writes it, key for key
  (in order) and byte for byte; it loads bit-equal to the ``.pth``.
- ``stage_check``: on one staged directory (the JAX test's recipes for the
  tokenizer, a tiny HF text encoder, a diffusers-layout VAE, InceptionV3
  and a tiny HF CLIPModel; a tiny reference-named ``unet.pt`` with its
  ``unet_config.json`` from the port's UNet, since the original reference
  repository is absent), JAX's ``main`` and the port's give the same status
  per artifact, the same missing and failed lists and the same exit code,
  also for an empty directory (2) and a truncated text encoder (1); the
  UNet probe forward equals JAX's within 1e-4.
- ``full_scale_parity``: the reference's default UNet ([160, 320], 8 heads,
  ctx 768) forward on a 16x16 latent in place of the tool's 64x64 (for
  time) equals JAX's on the same weights within 1e-4; the 5-step
  reference-compat loop equals JAX ``make_sample_fn``'s within 2e-3.
- ``fid_eval`` at FID_N=16, FID_STEPS=4: the default (DDIM) set and the
  compat (DDPM) set, with JAX's initial and per-step noise passed in, equal
  JAX's (latents at the sampler tests' bar, decoded images within 1e-4);
  FIDs from the same features agree to 1e-4 relative; fid(compat, default)
  exceeds 3x the compat floor.
- ``fid_samplers``: DDIM and DPM++ latents at 4 and 8 steps equal JAX's from
  the same weights and noise; the pooled-latent FID and RMSE equal JAX's
  arithmetic on the same latents.
"""

import importlib.util
import json
import os
import pathlib
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu import config as jax_config  # noqa: E402
from stable_diffusion_pytorch_tpu.models import autoencoder as jax_vae  # noqa: E402
from stable_diffusion_pytorch_tpu.models import inception as jax_inception  # noqa: E402
from stable_diffusion_pytorch_tpu.models import latent_diffusion as jax_ld  # noqa: E402
from stable_diffusion_pytorch_tpu.models import schedule as jax_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu.models import unet as jax_unet  # noqa: E402
from stable_diffusion_pytorch_tpu.utils import compat as jax_compat  # noqa: E402
from stable_diffusion_pytorch_tpu.utils import fid as jax_fid  # noqa: E402
from stable_diffusion_pytorch_tpu.utils import torch_port  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.config import UnetConfig  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import presets  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.build import init_weights, without_default_init  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.inception import load_inception_state  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.scripts import (  # noqa: E402
    convert_inception,
    export_torch,
    fid_eval,
    fid_samplers,
    full_scale_parity,
    stage_check,
)
from stable_diffusion_pytorch_tpu_torch.utils import convert  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.fid import fid_from_features  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.safetensors import save_file  # noqa: E402
from test_torch_port_slice import random_params  # noqa: E402

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
LOOP = dict(rtol=1e-4, atol=2e-4)  # the sampler tests' bar on a loop's latents
TINY_FLAGS = ("--channels-list 32,64 --n-heads 4 --time-emb-dim 64 --n-layers 1 "
              "--autoencoder-channels-list 16,32 --groups 8").split()
UNET_FIELDS = ("num_res_blocks", "n_heads", "attention_resolutions", "channels_list", "time_emb_dim", "dropout",
               "n_layers", "context_dim")


def _jax_cfg(cfg) -> jax_unet.UnetConfig:
    """The JAX UnetConfig of a port config or a dict of its fields."""
    return jax_unet.UnetConfig(**{f: cfg[f] if isinstance(cfg, dict) else getattr(cfg, f) for f in UNET_FIELDS})


def _jax_params(unet: torch.nn.Module, cfg) -> dict:
    """A port UNet's weights (the reference's names) as JAX params."""
    return torch_port.convert_reference_unet({k: v.numpy() for k, v in unet.state_dict().items()}, _jax_cfg(cfg), 4)


def _jax_draws(key, steps: int, shape):
    """The JAX loop's per-step normals (``k, sub, _ = split(k, 3)``; the draw from ``sub``)."""
    out, k = [], key
    for _ in range(steps):
        k, sub, _ = jax.random.split(k, 3)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    return out


# --------------------------------------------------------------------------- #
# export_torch, convert_inception
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["unet", "vae"])
def test_export_torch_writes_the_jax_export(tmp_path, kind):
    _, cfg = jax_config.load_config(TINY_FLAGS)
    vae_cfg = cfg.model.autoencoder
    if kind == "unet":
        module = jax_unet.UNetModel.from_config(vae_cfg.latent_channels, vae_cfg.groups, cfg.model.unet)
        params = random_params(module, 0, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 768)))
        ours = convert.unet_state_dict(params, cfg.model.unet)
        ref = torch_port.export_reference_unet(params, cfg.model.unet)
    else:
        module = jax_vae.AutoEncoderKL.from_config(vae_cfg)
        params = random_params(module, 1, jnp.zeros((1, 16, 16, 3)))
        ours, ref = (convert.autoencoder_state_dict(params, vae_cfg),
                     torch_port.export_reference_autoencoder(params, vae_cfg))
    weights = convert.to_torch(ours)
    # the UNet run kept EMA weights, which the export takes over the trained ones
    trained = {k: v + 1.0 for k, v in weights.items()} if kind == "unet" else weights
    save_checkpoint(str(tmp_path / "ckpt" / "checkpoint-3"),
                    {"step": 3, "params": trained, "opt_state": {}, "ema_params": weights if kind == "unet" else None})
    out = tmp_path / f"{kind}.pt"
    line = export_torch.main(["--checkpoint", str(tmp_path / "ckpt"), "--export-model", kind, "--output", str(out),
                              "--device", "cpu", *TINY_FLAGS])
    got = torch.load(out, weights_only=True)
    assert line["exported"] == len(ref) and line["checkpoint"].endswith("checkpoint-3")
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)


def _torchvision_inception_state() -> dict:
    """The JAX tests' torchvision-named InceptionV3 with non-trivial BatchNorm statistics."""
    import test_inception as ti

    torch.manual_seed(3)
    model = ti.TorchInceptionPool3()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
    return {k: v.contiguous() for k, v in model.state_dict().items()}


def test_convert_inception_writes_the_jax_tree(tmp_path):
    state = _torchvision_inception_state()
    flat = {}

    def walk(node, prefix):  # tools/convert_inception.py's flattening
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                flat[path] = np.asarray(v)

    walk(jax_inception.convert_torchvision_inception(state)["params"], "")
    torch.save(state, tmp_path / "inception_v3.pth")
    save_file(state, str(tmp_path / "inception_v3.safetensors"))
    for src in ("inception_v3.pth", "inception_v3.safetensors"):
        dst = tmp_path / src.replace(".", "_") / "inception" / "inception_v3.npz"
        line = convert_inception.main([str(tmp_path / src), str(dst)])
        assert line["arrays"] == len(flat)
        with np.load(dst) as f:
            assert f.files == list(flat)
            for k, v in flat.items():
                assert f[k].dtype == v.dtype and f[k].shape == v.shape and f[k].tobytes() == v.tobytes(), k
    staged = load_inception_state(str(tmp_path / "inception_v3_pth"))
    (tmp_path / "pth_only" / "inception").mkdir(parents=True)
    os.replace(tmp_path / "inception_v3.pth", tmp_path / "pth_only" / "inception" / "inception_v3.pth")
    direct = load_inception_state(str(tmp_path / "pth_only"))
    assert sorted(staged) == sorted(direct) and all(torch.equal(staged[k], direct[k]) for k in direct)


# --------------------------------------------------------------------------- #
# stage_check
# --------------------------------------------------------------------------- #

STAGED_UNET = dict(num_res_blocks=1, n_heads=2, attention_resolutions=[1], channels_list=[8, 16], time_emb_dim=16,
                   dropout=0.0, n_layers=1, context_dim=24)


def _jax_stage_check():
    spec = importlib.util.spec_from_file_location("jax_stage_check", REPO / "tools" / "stage_check.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """One staged directory of every artifact, without the reference repository."""
    import test_stage_check as recipes

    model_dir = str(tmp_path_factory.mktemp("staged"))
    for stage in (recipes._stage_tokenizer, recipes._stage_text_encoder, recipes._stage_vae,
                  recipes._stage_inception, recipes._stage_clip_full):
        stage(model_dir)
    with without_default_init():
        unet = UNetModel(4, 4, UnetConfig(**STAGED_UNET))
    with torch.no_grad():
        init_weights(unet, torch.Generator().manual_seed(2))
        full_scale_parity.seeded(unet, 2)
    torch.save(unet.state_dict(), os.path.join(model_dir, "unet.pt"))
    with open(os.path.join(model_dir, "unet_config.json"), "w") as f:
        json.dump(STAGED_UNET, f)
    return model_dir


def _run(main, argv, capsys):
    """(exit code, the printed JSON line) of a stage_check ``main``."""
    try:
        main(argv)
        code = 0
    except SystemExit as exc:
        code = exc.code
    return code, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_stage_check_reports_as_jax_on_a_staged_directory(staged, capsys):
    jax_code, jax_report = _run(_jax_stage_check().main, ["--model-dir", staged], capsys)
    code, report = _run(stage_check.main, ["--model-dir", staged, "--device", "cpu"], capsys)
    assert (code, report["missing"], report["failed"]) == (jax_code, jax_report["missing"], jax_report["failed"])
    assert {k: r["status"] for k, r in report["checks"].items()} == {
        k: r["status"] for k, r in jax_report["checks"].items()}
    assert code == 0 and set(report["checks"]) == set(stage_check.CHECKS)
    checks = report["checks"]
    assert checks["tokenizer"]["mode"] == "hf-parity"
    assert checks["text_encoder"]["mode"] == "hf-parity" and checks["text_encoder"]["max_abs_delta"] <= 1e-3
    assert checks["unet"]["channels_list"] == [8, 16] and checks["unet"]["mode"] == "load+forward only (--device cpu)"
    assert checks["clip_vision"]["pretrained"] is True

    # the UNet probe: the port's forward equals JAX's on the converted weights
    unet = UNetModel(4, 4, UnetConfig(**STAGED_UNET), flipped_time_embedding=True, bottleneck_default_groups=True)
    unet.load_state_dict(torch.load(os.path.join(staged, "unet.pt"), weights_only=True), strict=True)
    ours = stage_check.unet_probe(unet.eval(), 24)
    compat = jax_compat.CompatConfig(flipped_time_embedding=True, bottleneck_default_groups=True)
    j_unet = jax_unet.UNetModel.from_config(4, 4, _jax_cfg(STAGED_UNET), compat=compat)
    x, t, ctx = stage_check.unet_probe_inputs(24)
    ref = j_unet.apply(_jax_params(unet, STAGED_UNET), jnp.asarray(x), jnp.asarray(t, jnp.int32), jnp.asarray(ctx))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=1e-4)


def test_stage_check_exits_as_jax_when_missing_or_failing(staged, tmp_path, capsys):
    import shutil

    empty = tmp_path / "empty"
    empty.mkdir()
    bad = tmp_path / "bad"
    shutil.copytree(os.path.join(staged, "text_encoder"), bad / "text_encoder")
    st = bad / "text_encoder" / "model.safetensors"
    st.write_bytes(st.read_bytes()[: len(st.read_bytes()) // 2])
    jax_main = _jax_stage_check().main
    for argv, want in ((["--model-dir", str(empty)], 2), (["--model-dir", str(bad), "--only", "text_encoder"], 1)):
        jax_code, jax_report = _run(jax_main, argv, capsys)
        code, report = _run(stage_check.main, [*argv, "--device", "cpu"], capsys)
        assert code == jax_code == want
        assert (sorted(report["missing"]), report["failed"]) == (sorted(jax_report["missing"]), jax_report["failed"])
    assert report["failed"] == ["text_encoder"]
    code, report = _run(stage_check.main, ["--model-dir", str(empty), "--device", "cpu"], capsys)
    assert sorted(report["missing"]) == sorted(stage_check.CHECKS)
    assert all("stage" in r for r in report["checks"].values())


# --------------------------------------------------------------------------- #
# full_scale_parity
# --------------------------------------------------------------------------- #


def test_full_scale_reference_unet_forward_and_compat_loop_match_jax():
    cfg = presets.reference_unet_config()
    j_cfg = _jax_cfg(cfg)
    unet = full_scale_parity.build_unet(cfg, 0)
    x, t, ctx = full_scale_parity.unet_inputs(cfg, 0, latent=16)
    with torch.no_grad():
        ours = unet(x, t, ctx).numpy()
    ref = jax.jit(jax_unet.UNetModel.from_config(4, 4, j_cfg).apply)(
        _jax_params(unet, cfg), jnp.asarray(x.numpy()), jnp.asarray(t.numpy(), jnp.int32), jnp.asarray(ctx.numpy()))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=full_scale_parity.F32_TOL)

    unet = full_scale_parity.build_unet(cfg, 0, compat=True)
    x_T, ctx, uncond = full_scale_parity.loop_inputs(0, latent=16)
    key = jax.random.PRNGKey(0)
    with torch.no_grad():
        ours = full_scale_parity.compat_sample_fn(unet)(x_T, ctx, uncond,
                                                        noise=_jax_draws(key, full_scale_parity.LOOP_STEPS, x_T.shape))
    compat = jax_compat.CompatConfig(reference_compat=True).resolved()
    j_unet = jax_unet.UNetModel.from_config(4, 4, j_cfg, compat=compat)
    j_fn = jax_ld.make_sample_fn(j_unet, jax_schedule.make_schedule(jax_schedule.DDPMConfig(noise_steps=1000)),
                                 num_steps=full_scale_parity.LOOP_STEPS, sampler="ddpm", guidance_scale=7.5,
                                 scale_factor=0.0, reference_cfg_formula=True, ascending_loop=True,
                                 leading_timesteps=True)
    ref = jax.jit(j_fn)(_jax_params(unet, cfg), *(jnp.asarray(a.numpy()) for a in (x_T, ctx, uncond)), key)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=full_scale_parity.LOOP_TOL)
    assert full_scale_parity.bpe_parity()["bpe_hf_parity_fixture"] is True


# --------------------------------------------------------------------------- #
# fid_eval, fid_samplers
# --------------------------------------------------------------------------- #

FID_N, FID_STEPS, FID_RES = 16, 4, 32


@pytest.fixture(scope="module")
def fid_models():
    """The port's tiny stack from a seed and the JAX modules and params of the same weights."""
    with without_default_init():
        unet = UNetModel(4, 4, UnetConfig(**fid_eval.UNET_KW))
    # seeded with the zero output convs filled: every path counts
    stack = fid_eval.Stack(full_scale_parity.seeded(unet, 5).state_dict(), fid_eval.Stack.seeded(0).vae.state_dict())
    j_cfg = _jax_cfg(fid_eval.UNET_KW)
    vae_cfg = jax_vae.AutoencoderConfig(**fid_eval.VAE_KW)
    j_vae = jax_vae.AutoEncoderKL.from_config(vae_cfg)
    v_params = torch_port.convert_reference_autoencoder({k: v.numpy() for k, v in stack.vae.state_dict().items()},
                                                        vae_cfg)
    compat = jax_compat.CompatConfig(reference_compat=True).resolved()
    j_unets = {False: jax_unet.UNetModel.from_config(4, 4, j_cfg),
               True: jax_unet.UNetModel.from_config(4, 4, j_cfg, compat=compat)}
    decode = jax.jit(lambda p, z: j_vae.apply(p, z, method=j_vae.decode))
    return stack, j_unets, _jax_params(stack.unet, fid_eval.UNET_KW), v_params, decode


def test_fid_eval_sets_and_fids_match_jax(fid_models):
    stack, j_unets, u_params, v_params, decode = fid_models
    rng = np.random.default_rng(0)
    ctx_bank = rng.standard_normal((FID_N, fid_eval.CTX_TOKENS, 24)).astype(np.float32)
    uncond = rng.standard_normal((1, fid_eval.CTX_TOKENS, 24)).astype(np.float32)
    schedule = jax_schedule.make_schedule(jax_schedule.DDPMConfig(noise_steps=fid_eval.NOISE_STEPS))
    lat = FID_RES // 2
    sets = {}
    for compat in (False, True):
        kw = (dict(sampler="ddpm", reference_cfg_formula=True, ascending_loop=True, leading_timesteps=True) if compat
              else dict(sampler="ddim"))
        j_fn = jax.jit(jax_ld.make_sample_fn(j_unets[compat], schedule, num_steps=FID_STEPS, guidance_scale=7.5, **kw))
        keys = [jax.random.fold_in(jax.random.PRNGKey(42), i) for i in range(0, FID_N, fid_eval.BATCH)]
        draw = jax.random.uniform if compat else jax.random.normal
        x_Ts = [torch.from_numpy(np.array(draw(k, (fid_eval.BATCH, lat, lat, 4)))) for k in keys]
        noise = [_jax_draws(k, FID_STEPS, x.shape) for k, x in zip(keys, x_Ts)] if compat else None
        images, latents = fid_eval.sample_set(stack, stack.sample_fn(compat, FID_STEPS), ctx_bank, uncond, x_Ts,
                                              step_noise=noise)
        ref_lat, ref_img = [], []
        for j, (k, x) in enumerate(zip(keys, x_Ts)):
            ctx = jnp.asarray(ctx_bank[j * fid_eval.BATCH: (j + 1) * fid_eval.BATCH])
            z = j_fn(u_params, jnp.asarray(x.numpy()), ctx, jnp.broadcast_to(jnp.asarray(uncond), ctx.shape), k)
            ref_lat.append(np.asarray(z))
            ref_img.append(np.asarray(decode(v_params, z)))
        np.testing.assert_allclose(latents, np.concatenate(ref_lat), **LOOP)
        np.testing.assert_allclose(images, np.concatenate(ref_img), rtol=0, atol=1e-4)
        sets[compat] = images, latents

    img_fid = fid_eval.ImageFID("random_inception", stack, "cpu", towers=1)
    (c_img, c_lat), (d_img, d_lat) = sets[True], sets[False]
    ours = img_fid(c_img, d_img)
    theirs = jax_fid.fid_from_features(img_fid.features(0, c_img), img_fid.features(0, d_img))
    assert abs(ours - theirs) <= 1e-4 * abs(theirs)
    pooled = [fid_eval.latent_features(z) for z in (c_lat, d_lat)]
    assert abs(fid_from_features(*pooled) - jax_fid.fid_from_features(*pooled)) <= 1e-4 * abs(
        jax_fid.fid_from_features(*pooled))

    # the tool's own run: the ordering the smoke run holds on the card
    result = fid_eval.run(stack, FID_N, FID_STEPS, FID_RES, [3], fid_eval.ImageFID("vae", stack, "cpu"))
    assert result["ref"] == "unavailable"
    assert result["fid_latent_compat_vs_default"] > 3 * result["fid_latent_compat_vs_compat"]
    assert {"fid_exact_vs_dc3", "fid_latent_exact_vs_dc3", "rmse_latent_exact_vs_dc3"} <= set(result)
    assert 0 < result["rmse_latent_exact_vs_dc3"]


def test_fid_samplers_latents_and_scores_match_jax():
    res, n = 8, fid_samplers.BATCH
    unet = fid_samplers.build_unet(0)
    fid_samplers.perturb(unet, 0.02)
    unet.eval().requires_grad_(False)
    params = _jax_params(unet, fid_samplers.UNET_KW)
    j_unet = jax_unet.UNetModel.from_config(4, 4, _jax_cfg(fid_samplers.UNET_KW))
    schedule = fid_samplers.make_schedule(fid_samplers.DDPMConfig(noise_steps=1000))
    j_schedule = jax_schedule.make_schedule(jax_schedule.DDPMConfig(noise_steps=1000))
    ctx_bank = fid_samplers.make_batch(fid_samplers.make_basis(res), torch.Generator().manual_seed(1234), n)[1].numpy()
    x_Ts = fid_samplers.initial_noise(42, n, res)
    ctx = jnp.asarray(ctx_bank)
    latents = {}
    for sampler in ("ddim", "dpmpp"):
        for steps in (4, 8):
            ours = fid_samplers.sample_set(unet, schedule, sampler, steps, ctx_bank, x_Ts, 2.0)
            j_fn = jax_ld.make_sample_fn(j_unet, j_schedule, num_steps=steps, sampler=sampler, guidance_scale=2.0)
            ref = jax.jit(j_fn)(params, jnp.asarray(x_Ts[0].numpy()), ctx, jnp.zeros_like(ctx), jax.random.PRNGKey(0))
            np.testing.assert_allclose(ours, np.asarray(ref), **LOOP)
            latents[sampler, steps] = ours
    target, s = latents["ddim", 8], latents["dpmpp", 4]
    ours = fid_from_features(fid_samplers.latent_features(target, 4), fid_samplers.latent_features(s, 4))

    def pooled(z, pool=4):  # tools/fid_samplers.py's latent_features
        z = z.astype(np.float64)
        k, hh, ww, cc = z.shape
        return z.reshape(k, hh // pool, pool, ww // pool, pool, cc).mean(axis=(2, 4)).reshape(k, -1)

    theirs = jax_fid.fid_from_features(pooled(target), pooled(s))
    assert abs(ours - theirs) <= 1e-6 * max(1.0, abs(theirs))
    assert fid_samplers.rmse(s, target) == float(np.sqrt(np.mean((s.astype(np.float64) - target) ** 2)))
    assert fid_samplers.parse_grid("ddim:4,8;dpmpp:4") == [("ddim", 4), ("ddim", 8), ("dpmpp", 4)]


def test_tools_refuse_the_card_they_do_not_have(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((stage_check.main, []), (full_scale_parity.main, []), (fid_eval.main, []),
                       (fid_samplers.main, []), (export_torch.main, ["--checkpoint", "x"])):
        with pytest.raises(SystemExit, match="--device cpu"):
            main(argv)
    assert sys.modules["stable_diffusion_pytorch_tpu_torch.scripts.convert_inception"] is convert_inception
