"""Staged pretrained weights: the port's readers and loaders vs the JAX package's (CPU, tiny sizes).

One staged directory (a module fixture) holds what a user stages under
``--model-dir``: a reference-format ``unet.pt`` exported from a JAX tiny UNet
by ``utils/torch_port.py``, a diffusers ``vae/`` (``config.json`` +
safetensors) and an HF ``text_encoder/model.safetensors`` at the text tower's
full size (the port always builds that tower at full size). The JAX package's
``build_models`` and the port's load the same directory; the port's modules
must compute what the JAX modules compute.

Bars, each on f32 outputs of order one: the text tower 1e-5 absolute (12
pre-norm layers, sums in another order); the VAEs and the UNet 1e-4 of the
output's scale (~20-30 conv layers); loaded tensors bit for bit.
"""

import logging
import os
import shutil
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")
st_numpy = pytest.importorskip("safetensors.numpy")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu.config import load_config as jax_load_config  # noqa: E402
from stable_diffusion_pytorch_tpu.models import build as jax_build  # noqa: E402
from stable_diffusion_pytorch_tpu.models import clip as jax_clip  # noqa: E402
from stable_diffusion_pytorch_tpu.models import diffusers_vae as jax_dvae  # noqa: E402
from stable_diffusion_pytorch_tpu.utils.torch_port import (  # noqa: E402
    export_reference_autoencoder,
    export_reference_unet,
    save_torch_state_dict,
)
from stable_diffusion_pytorch_tpu_torch import config as port_config  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import build as port_build  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import clip as port_clip  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import diffusers_vae as port_dvae  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.autoencoder import AutoEncoderKL  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.blocks import GroupNorm  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import convert  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import safetensors as port_st  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import load_reference_checkpoint  # noqa: E402

torch.set_num_threads(2)

# the CLI's tiny model (context 768: the full-size text tower's width)
TINY_FLAGS = ("--channels-list 32,64 --n-heads 4 --time-emb-dim 64 --n-layers 1 --num-res-blocks 1 "
              "--autoencoder-channels-list 16,32 --groups 8").split()
DVAE_CFG = dict(in_channels=3, out_channels=3, latent_channels=4, block_out_channels=(16, 32), layers_per_block=1,
                groups=8)
TINY_TEXT = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, intermediate=64, max_positions=16)


def _jax_cfg(model_dir):
    return jax_load_config([*TINY_FLAGS, "--model-dir", str(model_dir)])[1]


def _port_cfgs(model_dir, **vae):
    _, cfg = jax_load_config([*TINY_FLAGS, "--model-dir", str(model_dir)])
    m = cfg.model
    return (port_config.UnetConfig(**m.unet.to_dict()),
            port_config.AutoencoderConfig(**{**m.autoencoder.to_dict(), **vae}),
            port_config.ClipConfig(**m.clip.to_dict()), port_config.DDPMConfig(**m.ddpm.to_dict()))


def _random_params(module, seed, *args):
    """Seeded random parameters of a flax module (shapes from eval_shape):
    unit-centred norm scales, small biases, fan-in-scaled kernels."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", None)
        n = rng.standard_normal(s.shape).astype(np.float32)
        if name == "scale":
            n = 1.0 + 0.1 * n
        elif name == "bias":
            n = 0.1 * n
        else:
            n = n / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _random_state(module: torch.nn.Module, seed: int) -> dict:
    """Seeded random values for every parameter of a port module, by name:
    norm weights near 1, biases small, others fan-in scaled."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in module.state_dict().items():
        n = torch.randn(p.shape, generator=gen)
        if name.endswith("bias"):
            n = 0.1 * n
        elif p.dim() == 1:
            n = 1.0 + 0.1 * n
        else:
            n = n / max(1, p[0].numel()) ** 0.5
        out[name] = n
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _old_names(state: dict) -> dict:
    """A diffusers VAE state in the pre-0.15 names: query/key/value/proj_attn
    as 1x1 convs, ``norm`` for ``group_norm``."""
    out = {}
    for k, v in state.items():
        if ".mid_block.attentions.0." in k:
            head, tail = k.split(".mid_block.attentions.0.")
            name, kind = tail.rsplit(".", 1)
            name = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn",
                    "group_norm": "norm"}[name]
            if v.dim() == 2:
                v = v[:, :, None, None]
            k = f"{head}.mid_block.attentions.0.{name}.{kind}"
        out[k] = v
    return out


def _write_vae_dir(path, state, cfg, fmt: str) -> None:
    import json

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"in_channels": cfg["in_channels"], "out_channels": cfg["out_channels"],
                   "latent_channels": cfg["latent_channels"], "block_out_channels": list(cfg["block_out_channels"]),
                   "layers_per_block": cfg["layers_per_block"], "norm_num_groups": cfg["groups"]}, f)
    if fmt == "safetensors":
        port_st.save_file(state, os.path.join(path, "diffusion_pytorch_model.safetensors"))
    else:
        torch.save(state, os.path.join(path, "diffusion_pytorch_model.bin"))


def _hf_text_state(module, seed) -> dict:
    """An HF CLIPTextModel state dict of ``module``'s shapes (with the
    ``position_ids`` buffer HF saves)."""
    state = _random_state(module, seed)
    n_pos = state["text_model.embeddings.position_embedding.weight"].shape[0]
    state["text_model.embeddings.position_ids"] = torch.arange(n_pos)[None]
    return state


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """{"dir": the staged directory, "unet_tree": the JAX UNet params,
    "vae_state": the diffusers state, "text_state": the HF text state}."""
    root = tmp_path_factory.mktemp("pretrained")
    cfg = _jax_cfg(root)
    jax_unet = jax_build.UNetModel.from_config(4, 8, cfg.model.unet)
    tree = _random_params(jax_unet, 1, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 768)))
    save_torch_state_dict(export_reference_unet(tree, cfg.model.unet), str(root / "unet.pt"))
    vae_state = _random_state(port_dvae.DiffusersAutoencoderKL(**DVAE_CFG), 2)
    _write_vae_dir(root / "vae", vae_state, DVAE_CFG, "safetensors")
    with port_build.without_default_init():
        text = port_clip.CLIPTextTransformer()
    text_state = _hf_text_state(text, 3)
    del text
    os.makedirs(root / "text_encoder")
    port_st.save_file(text_state, str(root / "text_encoder" / "model.safetensors"))
    yield {"dir": root, "unet_tree": tree, "vae_state": vae_state, "text_state": text_state}
    shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------- #
# safetensors
# --------------------------------------------------------------------------- #


def _arrays(kind: str) -> dict:
    rng = np.random.default_rng(7)
    f32 = {"w.a": rng.standard_normal((3, 5)).astype(np.float32), "s": np.array(2.5, np.float32)}
    table = {
        "F32": f32,
        "F16": {"x": rng.standard_normal((4, 2)).astype(np.float16), "empty": np.zeros((0, 3), np.float16)},
        "BF16": {"b": rng.standard_normal((2, 7)).astype(ml_dtypes.bfloat16)},
        "I64": {"ids": np.arange(-3, 9, dtype=np.int64).reshape(3, 4)},
    }
    if kind == "mixed":
        return {k: v for d in table.values() for k, v in d.items()}
    return table[kind]


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("kind", ["F32", "F16", "BF16", "I64", "mixed"])
def test_safetensors_matches_the_package(kind, tmp_path):
    """The port's writer gives the package's bytes; its reader gives the
    package's arrays back, bit for bit, from a file the package wrote."""
    arrays = _arrays(kind)
    metadata = {"format": "pt"} if kind == "mixed" else None  # HF's files carry it; the reader skips it
    path = str(tmp_path / "x.safetensors")
    port_st.save_file({k: _to_torch(v) for k, v in arrays.items()}, path)
    with open(path, "rb") as f:
        assert f.read() == st_numpy.save(arrays)
    ref_path = str(tmp_path / "ref.safetensors")
    st_numpy.save_file(arrays, ref_path, metadata=metadata)
    back = port_st.load_file(ref_path)
    assert back.keys() == arrays.keys()
    for k, a in arrays.items():
        t = back[k]
        assert tuple(t.shape) == a.shape
        got = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        want = a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a
        assert got.dtype == want.dtype and np.array_equal(got, want), k


# --------------------------------------------------------------------------- #
# reference checkpoints
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("wrapped", [False, True], ids=["plain", "state_dict"])
def test_reference_vae_checkpoint_loads_strict(wrapped, tmp_path):
    """vae.pt from the JAX export loads into the port's AutoEncoderKL by name,
    equal to utils/convert.py's state bit for bit, and decodes as JAX does."""
    _, cfg = jax_load_config(TINY_FLAGS)
    vcfg = cfg.model.autoencoder
    module = jax_build.AutoEncoderKL.from_config(vcfg)
    tree = _random_params(module, 4, jnp.zeros((1, 16, 16, 3)))
    sd = export_reference_autoencoder(tree, vcfg)
    path = str(tmp_path / "vae.pt")
    if wrapped:
        torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}}, path)
    else:
        save_torch_state_dict(sd, path)
    state = load_reference_checkpoint(path)
    ours = convert.autoencoder_state_dict(tree, vcfg)
    assert state.keys() == ours.keys() and all(np.array_equal(state[k].numpy(), ours[k]) for k in ours)
    vae = AutoEncoderKL(port_config.AutoencoderConfig(**vcfg.to_dict())).eval()
    vae.load_state_dict(state, strict=True)
    z = np.random.default_rng(5).standard_normal((1, 4, 4, 4)).astype(np.float32)
    ref = jax.jit(lambda p, z: module.apply(p, z, method=module.decode))(tree, jnp.asarray(z))
    with torch.no_grad():
        out = vae.decode(torch.from_numpy(z))
    assert _rel(out, ref) <= 1e-4


@pytest.fixture(scope="module")
def jax_unet_ref(staged):
    """The JAX UNet of the staged unet.pt (the JAX package's own loader,
    ``_try_load_pretrained_unet``) on seeded inputs -> (x, t, ctx, output)."""
    cfg = _jax_cfg(staged["dir"]).model
    params = jax_build._try_load_pretrained_unet(str(staged["dir"]), cfg.unet, 4, None)
    module = jax_build.UNetModel.from_config(4, 8, cfg.unet)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    t = np.array([500], np.int32)
    ctx = rng.standard_normal((1, 77, 768)).astype(np.float32)
    out = jax.jit(module.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    return x, t, ctx, np.asarray(out)


def _port_unet_out(unet, ref):
    x, t, ctx, _ = ref
    with torch.no_grad():
        return unet(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(ctx))


def test_reference_unet_checkpoint_loads_strict(staged, jax_unet_ref):
    """unet.pt (the JAX export) loads by name, equal to utils/convert.py's
    state bit for bit, and the port's UNet computes what JAX's computes."""
    from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel

    cfg = _jax_cfg(staged["dir"])
    state = load_reference_checkpoint(str(staged["dir"] / "unet.pt"))
    ours = convert.unet_state_dict(staged["unet_tree"], cfg.model.unet)
    assert state.keys() == ours.keys() and all(np.array_equal(state[k].numpy(), ours[k]) for k in ours)
    unet = UNetModel(4, 8, port_config.UnetConfig(**cfg.model.unet.to_dict())).eval()
    unet.load_state_dict(state, strict=True)
    assert _rel(_port_unet_out(unet, jax_unet_ref), jax_unet_ref[3]) <= 1e-4


# --------------------------------------------------------------------------- #
# the HF text encoder
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("fmt", ["safetensors", "bin", "none"])
def test_text_encoder_from_hf_checkpoint_matches_jax(fmt, tmp_path):
    """A tiny HF-named text tower staged as model.safetensors or
    pytorch_model.bin: the port loads it by name (position_ids dropped) and
    encodes as JAX's load_clip_params + CLIPTextTransformer, to 1e-5; with
    none staged it warns as JAX does and keeps its weights."""
    module = port_clip.CLIPTextTransformer(**TINY_TEXT)
    if fmt == "none":
        before = {k: v.clone() for k, v in module.state_dict().items()}
        with pytest.warns(UserWarning, match="CLIP FALLBACK"):
            assert not port_clip.load_text_encoder(module, str(tmp_path))
        assert all(torch.equal(v, before[k]) for k, v in module.state_dict().items())
        return
    state = _hf_text_state(module, 6)
    os.makedirs(tmp_path / "text_encoder")
    if fmt == "safetensors":
        port_st.save_file(state, str(tmp_path / "text_encoder" / "model.safetensors"))
    else:
        torch.save(state, str(tmp_path / "text_encoder" / "pytorch_model.bin"))
    assert port_clip.load_text_encoder(module, str(tmp_path))
    ids = np.random.default_rng(8).integers(0, TINY_TEXT["vocab_size"], (2, TINY_TEXT["max_positions"]))
    jax_params = jax_clip.load_clip_params(str(tmp_path))
    ref = jax_clip.CLIPTextTransformer(**TINY_TEXT).apply(jax_params, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        out = module(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_clip_attention_routes_unmasked_to_the_kernel_wrapper(monkeypatch):
    """The JAX CLIPEncoderLayer calls multi_head_attention: unmasked attention
    (the vision tower's) reaches the flash-attention wrapper, the causal text
    tower's does not."""
    from stable_diffusion_pytorch_tpu_torch.ops import flash_attention as fa

    calls = []
    plain = fa.flash_attention

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(fa, "flash_attention", counting)
    layer = port_clip.CLIPEncoderLayer(16, 2, 32)
    x = torch.randn(1, 5, 16)
    with torch.no_grad():
        layer(x, torch.triu(torch.ones(5, 5, dtype=torch.bool), 1)[None, None])
        assert not calls
        layer(x)
    assert calls == [(1, 5, 2, 8)]


# --------------------------------------------------------------------------- #
# the diffusers VAE
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def jax_dvae_ref(staged):
    """JAX DiffusersAutoencoderKL from the staged vae/ -> (image, noise-free
    posterior moments, decode of a latent)."""
    module, params = jax_dvae.load_diffusers_vae(str(staged["dir"] / "vae"))
    rng = np.random.default_rng(9)
    img = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    mean, log_var = jax.jit(lambda p, x: (lambda d: (d.mean, d.log_var))(
        module.apply(p, x, method=module.encode).latent_dist))(params, jnp.asarray(img))
    dec = jax.jit(lambda p, z: module.apply(p, z, method=module.decode))(params, jnp.asarray(z))
    return img, z, np.asarray(mean), np.asarray(log_var), np.asarray(dec)


@pytest.mark.parametrize("names,fmt", [("today", "safetensors"), ("pre-0.15", "bin")])
def test_diffusers_vae_matches_jax(names, fmt, staged, jax_dvae_ref, tmp_path):
    """Both attention namings and both file formats, with config.json: the
    port's encode (mean, clamped log-variance) and decode match JAX to 1e-4
    of scale."""
    state = staged["vae_state"] if names == "today" else _old_names(staged["vae_state"])
    _write_vae_dir(tmp_path / "vae", state, DVAE_CFG, fmt)
    vae = port_dvae.load_diffusers_vae(str(tmp_path / "vae"))
    assert port_dvae.read_vae_config(str(tmp_path / "vae")) == {**DVAE_CFG, "block_out_channels": (16, 32)}
    img, z, mean, log_var, dec = jax_dvae_ref
    with torch.no_grad():
        post = vae.encode(torch.from_numpy(img))
        out = vae.decode(torch.from_numpy(z))
    assert _rel(post.mean, mean) <= 1e-4 and _rel(post.log_var, log_var) <= 1e-4
    assert _rel(out, dec) <= 1e-4
    assert vae.downsample_factor == 2 and vae.channels_list == [16, 32] and vae.latent_channels == 4
    assert all(isinstance(m, GroupNorm) and m.eps == 1e-6 for m in vae.modules() if isinstance(m, GroupNorm))


# --------------------------------------------------------------------------- #
# build_models and the entry points
# --------------------------------------------------------------------------- #


def _log_lines(caplog, name):
    return [r.getMessage() for r in caplog.records if r.name == name and "pretrained weights" in r.getMessage()]


def test_build_models_loads_the_staged_directory_as_jax(staged, jax_unet_ref, jax_dvae_ref, caplog):
    """unet.pt, vae/ and text_encoder/ load from one directory, the log says
    so in the JAX package's words, and the port's UNet and VAE compute what
    the JAX package's loaders give (``_try_load_pretrained_unet`` and
    ``load_diffusers_vae``, which its ``build_models`` calls)."""
    root = staged["dir"]
    caplog.set_level(logging.INFO)
    model = port_build.build_models(*_port_cfgs(root), device="cpu", logger=logging.getLogger("port_build"))
    assert _log_lines(caplog, "port_build") == [
        f"pretrained weights loaded: ['unet', 'vae', 'clip'] (diffusers AutoencoderKL from {root / 'vae'})"]
    assert isinstance(model.autoencoder, port_dvae.DiffusersAutoencoderKL) and model.text_encoder.pretrained
    text = dict(model.text_encoder.module.state_dict())
    assert all(torch.equal(text[k], v) for k, v in port_clip.tower_state(staged["text_state"]).items())
    assert _rel(_port_unet_out(model.unet, jax_unet_ref), jax_unet_ref[3]) <= 1e-4
    _, z, _, _, dec = jax_dvae_ref
    with torch.no_grad():
        assert _rel(model.autoencoder.decode(torch.from_numpy(z)), dec) <= 1e-4


def test_build_models_dtype_rules_after_a_load(staged):
    """bf16 inference: the loaded f32 weights cast once, GroupNorm affine kept
    f32 (bit for bit the file's); for_training keeps the UNet f32."""
    root = staged["dir"]
    unet_file = load_reference_checkpoint(str(root / "unet.pt"))
    model = port_build.build_models(*_port_cfgs(root), dtype=torch.bfloat16, device="cpu")
    for module, written in ((model.unet, unet_file), (model.autoencoder, staged["vae_state"])):
        gn = {f"{n}.{k}" for n, m in module.named_modules() if isinstance(m, GroupNorm) for k in ("weight", "bias")}
        assert gn
        for name, p in module.state_dict().items():
            assert p.dtype == (torch.float32 if name in gn else torch.bfloat16), name
            assert torch.equal(p, written[name].to(p.dtype)), name
    train = port_build.build_models(*_port_cfgs(root), dtype=torch.bfloat16, device="cpu", for_training=True)
    assert all(torch.equal(p, unet_file[k]) for k, p in train.unet.state_dict().items())


def test_build_models_pretrained_dir_none_and_nothing_staged(staged, tmp_path, caplog):
    """pretrained_dir=None: the UNet and VAE stay random while the text
    encoder follows the CLIP config's model_dir, as in the JAX package's
    build_models; an empty directory loads nothing; the log lines are the
    JAX package's."""
    caplog.set_level(logging.INFO)
    model = port_build.build_models(*_port_cfgs(staged["dir"]), device="cpu", logger=logging.getLogger("port_build"),
                                    pretrained_dir=None)
    assert _log_lines(caplog, "port_build") == [
        "pretrained weights loaded: ['clip']",
        "pretrained weights NOT found for ['unet', 'vae'] under None — these components are randomly initialized"]
    assert isinstance(model.autoencoder, AutoEncoderKL) and model.text_encoder.pretrained
    unet_file = load_reference_checkpoint(str(staged["dir"] / "unet.pt"))
    assert not any(torch.equal(p, unet_file[k]) for k, p in model.unet.state_dict().items() if p.dim() > 1)
    caplog.clear()
    empty = str(tmp_path)
    with pytest.warns(UserWarning, match="CLIP FALLBACK"):
        model = port_build.build_models(*_port_cfgs(empty), device="cpu", logger=logging.getLogger("port_build"))
    assert not model.text_encoder.pretrained and isinstance(model.autoencoder, AutoEncoderKL)
    assert _log_lines(caplog, "port_build") == [
        "pretrained weights loaded: NONE",
        f"pretrained weights NOT found for ['unet', 'vae', 'clip'] under {empty!r} — these components are "
        "randomly initialized"]


def test_build_models_reference_vae_pt_and_latent_override(staged, tmp_path, caplog):
    """vae.pt is taken where no vae/ is staged; a staged diffusers VAE whose
    latent channels differ from the config's warns."""
    caplog.set_level(logging.INFO)
    _, cfg = jax_load_config(TINY_FLAGS)
    vcfg = cfg.model.autoencoder
    module = jax_build.AutoEncoderKL.from_config(vcfg)
    tree = _random_params(module, 11, jnp.zeros((1, 16, 16, 3)))
    save_torch_state_dict(export_reference_autoencoder(tree, vcfg), str(tmp_path / "vae.pt"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = port_build.build_models(*_port_cfgs(tmp_path), device="cpu", logger=logging.getLogger("port_build"))
    assert isinstance(model.autoencoder, AutoEncoderKL)
    assert _log_lines(caplog, "port_build")[0] == (
        f"pretrained weights loaded: ['vae'] (reference-format AutoEncoderKL from {tmp_path / 'vae.pt'})")
    ours = convert.autoencoder_state_dict(tree, vcfg)
    assert all(np.array_equal(p.numpy(), ours[k]) for k, p in model.autoencoder.state_dict().items())
    caplog.clear()
    only_vae = tmp_path / "only_vae"
    shutil.copytree(staged["dir"] / "vae", only_vae / "vae")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port_build.build_models(*_port_cfgs(only_vae, latent_channels=8), device="cpu",
                                logger=logging.getLogger("port_build"))
    assert any("pretrained VAE latent_channels=4 overrides --latent-channels=8" in r.getMessage()
               for r in caplog.records)


def test_txt2img_cli_samples_from_the_staged_directory(staged, tmp_path, caplog):
    """The port's txt2img with --model-dir loads all three and writes its PNG."""
    from stable_diffusion_pytorch_tpu_torch.scripts import txt2img

    caplog.set_level(logging.INFO)
    model = txt2img.main(["--prompt", "a cat", "--image-size", "16", "--sampling-steps", "2", "--device", "cpu",
                          "--model-dir", str(staged["dir"]), "--output-dir", str(tmp_path), "--output-name", "c.png",
                          *TINY_FLAGS])
    assert any("pretrained weights loaded: ['unet', 'vae', 'clip']" in r.getMessage() for r in caplog.records)
    assert os.path.exists(tmp_path / "c.png") and isinstance(model.autoencoder, port_dvae.DiffusersAutoencoderKL)


class _Built(Exception):
    pass


@pytest.mark.parametrize("entry", ["txt2img", "img2img", "serve", "train_unet", "train_dreambooth",
                                   "train_textual_inversion", "train_controlnet"])
def test_every_entry_point_passes_the_model_dir(entry, monkeypatch, tmp_path):
    """Each entry point hands --model-dir to build_models as pretrained_dir
    (and its logger), as the JAX entry points do."""
    from stable_diffusion_pytorch_tpu_torch.scripts import img2img, serve, train_unet, txt2img

    seen = {}

    def fake_build(*args, **kw):
        seen.update(kw)
        raise _Built

    module = {"txt2img": txt2img, "img2img": txt2img, "serve": serve}.get(entry, train_unet)
    monkeypatch.setattr(module, "build_models", fake_build)
    model_dir = str(tmp_path / "staged")
    common = ["--device", "cpu", "--model-dir", model_dir]
    with pytest.raises(_Built):
        if entry == "txt2img":
            txt2img.main([*common, "--prompt", "x"])
        elif entry == "img2img":
            img2img.main([*common, "--prompt", "x", "--init-image", "missing.png"])
        elif entry == "serve":
            serve.build_service([*common])
        else:
            import importlib

            extra = {"train_dreambooth": ["--instance-data-dir", str(tmp_path), "--instance-prompt", "a sks dog"],
                     "train_textual_inversion": ["--placeholder-token", "<c>", "--initializer-token", "toy"]}
            importlib.import_module(f"stable_diffusion_pytorch_tpu_torch.scripts.{entry}").build_trainer(
                [*common, "--dataset", "synthetic", *extra.get(entry, [])])
    assert seen["pretrained_dir"] == model_dir and seen["logger"] is not None
