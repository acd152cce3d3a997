"""Evaluation: Inception pool3 and FID, the CLIP vision tower and the CLIP score, port vs JAX (CPU).

Weights are seeded random values written in the real on-disk layouts (a
torchvision ``inception_v3`` state dict; an HF ``CLIPModel`` safetensors file
at a tiny width), read by both packages' loaders.

Bars: Inception features 1e-4 of their scale (~95 convs in f32, sums in
another order); the FID math 1e-10 relative (the same float64 numpy code);
the CLIP embeddings 1e-5 absolute on unit vectors and the score 1e-3 (in
score units of 0-100); ``preprocess_images`` 1e-5 absolute on normalized
pixels (the same float32 weight matrices, contracted in another order).
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu.models import clip_vision as jax_cv  # noqa: E402
from stable_diffusion_pytorch_tpu.models import inception as jax_inception  # noqa: E402
from stable_diffusion_pytorch_tpu.utils import fid as jax_fid  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import clip_vision as port_cv  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import inception as port_inception  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.bpe import CLIPBPETokenizer  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import fid as port_fid  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import safetensors as port_st  # noqa: E402

torch.set_num_threads(2)

TINY_TEXT = dict(d_model=32, n_layers=2, n_heads=4, intermediate=64)  # CLIP's vocabulary and 77 positions
TINY_VISION = dict(image_size=28, patch_size=7, d_model=48, n_layers=2, n_heads=4, intermediate=96)
PROJ = 24


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def torchvision_state(seed: int) -> dict:
    """A seeded torchvision ``inception_v3`` state dict: every BasicConv2d's
    conv weight and BatchNorm (positive running variances), plus AuxLogits
    and fc entries the pool3 tower leaves out."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, m in port_inception.InceptionV3Pool3().named_modules():
        if isinstance(m, port_inception.BasicConv2d):
            w = m.conv.weight
            c = w.shape[0]
            state[f"{name}.conv.weight"] = torch.randn(w.shape, generator=gen) * (2.0 / w[0].numel()) ** 0.5
            state[f"{name}.bn.weight"] = 1.0 + 0.1 * torch.randn(c, generator=gen)
            state[f"{name}.bn.bias"] = 0.1 * torch.randn(c, generator=gen)
            state[f"{name}.bn.running_mean"] = 0.1 * torch.randn(c, generator=gen)
            state[f"{name}.bn.running_var"] = 0.5 + torch.rand(c, generator=gen)
            state[f"{name}.bn.num_batches_tracked"] = torch.tensor(0)
    state["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    state["AuxLogits.conv0.bn.running_var"] = torch.ones(128)
    state["fc.weight"], state["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    return state


@pytest.fixture(scope="module")
def inception():
    """(torchvision state, JAX params converted from it)."""
    state = torchvision_state(0)
    return state, jax_inception.convert_torchvision_inception(state)


def _flat_tree(params: dict) -> dict:
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                flat[path] = np.asarray(v)

    walk(params["params"], "")
    return flat


def test_inception_pool3_matches_jax_at_75px(inception):
    """The converter folds BatchNorm to the JAX package's bits, the npz tree
    loads as the same state, and pool3 at 75x75, batch 2 (the smallest input)
    matches the JAX tower to 1e-4 of scale."""
    state, params = inception
    ours = port_inception.convert_torchvision_inception(state)
    assert ours.keys() == port_inception.InceptionV3Pool3().state_dict().keys()
    from_tree = port_inception.inception_state_from_tree(_flat_tree(params))
    assert from_tree.keys() == ours.keys() and all(torch.equal(from_tree[k], ours[k]) for k in ours)
    model = port_inception.InceptionV3Pool3().eval()
    model.load_state_dict(ours, strict=True)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    ref = jax.jit(jax_inception.InceptionV3Pool3().apply)(params, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.shape == (2, 2048) and _rel(out, ref) <= 1e-4


def test_inception_weights_precedence(inception, tmp_path):
    """npz, then safetensors, then pth, for both packages' loaders."""
    state, params = inception
    root = tmp_path / "inception"
    os.makedirs(root)
    marks = {}
    for i, fmt in enumerate(("pth", "safetensors", "npz")):
        s = dict(state)
        s["Conv2d_1a_3x3.conv.weight"] = torch.full_like(state["Conv2d_1a_3x3.conv.weight"], float(i))
        marks[fmt] = float(i)
        if fmt == "pth":
            torch.save(s, root / "inception_v3.pth")
        elif fmt == "safetensors":
            port_st.save_file(s, str(root / "inception_v3.safetensors"))
        else:
            np.savez(root / "inception_v3.npz", **_flat_tree(jax_inception.convert_torchvision_inception(s)))
        ours = port_inception.load_inception_state(str(tmp_path))["Conv2d_1a_3x3.conv.weight"]
        theirs = jax_inception.load_inception_params(str(tmp_path))["params"]["Conv2d_1a_3x3"]["conv"]["kernel"]
        assert float(ours.flatten()[0]) == float(np.asarray(theirs).flatten()[0]) == marks[fmt]
    assert port_inception.load_inception_state(str(tmp_path / "none")) is None


def test_canonical_extractor_matches_jax(inception):
    """512 -> 299 bilinear without antialiasing, transform_input, pool3: the
    port's extractor (CPU) against the JAX package's Flax extractor."""
    state, params = inception
    images = np.random.default_rng(2).uniform(-1, 1, (1, 512, 512, 3)).astype(np.float32)
    ref = jax_fid.FlaxInceptionFeatureExtractor(params=params)(images)
    ext = port_fid.InceptionFeatureExtractor(port_inception.convert_torchvision_inception(state), device="cpu")
    out = ext(images)
    assert ext.name == jax_fid.FlaxInceptionFeatureExtractor.name == "fid_inception"
    assert out.dtype == np.float64 and _rel(out, ref) <= 1e-4
    resized = port_fid.resize_299(torch.from_numpy(images)).numpy()
    want = jax.image.resize(jnp.asarray(images), (1, 299, 299, 3), method="bilinear", antialias=False)
    assert np.abs(resized - np.asarray(want)).max() <= 1e-6


def test_random_inception_extractor_is_seeded():
    a = port_fid.RandomInceptionFeatureExtractor(seed=3, feat_dim=64, device="cpu")
    b = port_fid.RandomInceptionFeatureExtractor(seed=3, feat_dim=64, device="cpu")
    x = np.random.default_rng(4).uniform(-1, 1, (2, 80, 80, 3)).astype(np.float32)
    fa, fb = a(x), b(x)
    assert fa.shape == (2, 64) and np.array_equal(fa, fb) and np.isfinite(fa).all() and fa.std() > 0
    assert a.name == jax_fid.RandomInceptionFeatureExtractor.name


def test_fid_math_matches_jax():
    """compute_statistics, frechet_distance, fid_from_features and
    fid_between on the same features: 1e-10 relative."""
    rng = np.random.default_rng(5)
    fa, fb = rng.standard_normal((40, 16)), rng.standard_normal((36, 16)) * 1.3 + 0.2
    for x in (fa, fb):
        for ours, theirs in zip(port_fid.compute_statistics(x), jax_fid.compute_statistics(x)):
            np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=0)
    s = port_fid.compute_statistics(fa) + port_fid.compute_statistics(fb)
    np.testing.assert_allclose(port_fid.frechet_distance(*s), jax_fid.frechet_distance(*s), rtol=1e-10)
    np.testing.assert_allclose(port_fid.fid_from_features(fa, fb), jax_fid.fid_from_features(fa, fb), rtol=1e-10)
    np.testing.assert_allclose(port_fid._sqrtm_psd(s[1]), jax_fid._sqrtm_psd(s[1]), rtol=1e-10, atol=1e-14)
    images_a, images_b = list(rng.uniform(-1, 1, (5, 4, 4, 3))), list(rng.uniform(-1, 1, (6, 4, 4, 3)))

    def extractor(x):
        return np.asarray(x).reshape(len(x), -1)[:, :6]

    np.testing.assert_allclose(port_fid.fid_between(extractor, images_a, images_b, batch_size=2),
                               jax_fid.fid_between(extractor, images_a, images_b, batch_size=2), rtol=1e-10)
    assert port_fid.fid_from_features(fa, fa) < 1e-3 * port_fid.fid_from_features(fa, fb)


def test_vae_feature_extractor_matches_jax(tmp_path):
    """fid_vae features: the tiny diffusers VAE's pooled posterior means."""
    from stable_diffusion_pytorch_tpu.models import diffusers_vae as jax_dvae
    from stable_diffusion_pytorch_tpu_torch.models import diffusers_vae as port_dvae

    cfg = dict(block_out_channels=(8, 16), layers_per_block=1, groups=4)
    vae = port_dvae.DiffusersAutoencoderKL(**cfg)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in vae.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.3 if p.dim() == 1 else p[0].numel() ** -0.5)
                    + (1.0 if p.dim() == 1 else 0.0))
    os.makedirs(tmp_path / "vae")
    port_st.save_file(vae.state_dict(), str(tmp_path / "vae" / "diffusion_pytorch_model.safetensors"))
    with open(tmp_path / "vae" / "config.json", "w") as f:
        json.dump({"block_out_channels": [8, 16], "layers_per_block": 1, "norm_num_groups": 4}, f)
    module, params = jax_dvae.load_diffusers_vae(str(tmp_path / "vae"))
    x = np.random.default_rng(7).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    ref = jax_fid.VAEFeatureExtractor(module, params, pool=4)(x)
    out = port_fid.VAEFeatureExtractor(port_dvae.load_diffusers_vae(str(tmp_path / "vae")), pool=4)(x)
    assert out.shape == ref.shape == (2, 64) and _rel(out, ref) <= 1e-4


# --------------------------------------------------------------------------- #
# CLIP vision and the CLIP score
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def full_clip(tmp_path_factory):
    """A tiny HF CLIPModel state dict (both towers, both projections,
    position_ids, logit_scale) staged at clip_full/model.safetensors."""
    root = tmp_path_factory.mktemp("clip")
    text = port_cv.CLIPTextTransformer(**TINY_TEXT)
    vision = port_cv.CLIPVisionTransformer(**TINY_VISION)
    gen = torch.Generator().manual_seed(8)
    state = {}
    for tower in (text, vision):
        for name, p in tower.state_dict().items():
            n = torch.randn(p.shape, generator=gen)
            if p.dim() == 1:
                n = 1.0 + 0.1 * n if "norm" in name and name.endswith("weight") else 0.1 * n
            else:
                n = n * p[0].numel() ** -0.5
            state[name] = n
    state["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    state["vision_model.embeddings.position_ids"] = torch.arange(17)[None]
    state["text_projection.weight"] = torch.randn(PROJ, 32, generator=gen) * 32 ** -0.5
    state["visual_projection.weight"] = torch.randn(PROJ, 48, generator=gen) * 48 ** -0.5
    state["logit_scale"] = torch.tensor(2.6592)
    os.makedirs(root / "clip_full")
    port_st.save_file(state, str(root / "clip_full" / "model.safetensors"))
    return root


def _images(n, size, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def test_preprocess_images_matches_jax_antialiased_resize():
    """512 -> 224 with JAX's antialiased bilinear resize, then CLIP's
    normalization: 1e-5 absolute."""
    images = _images(2, 512, 9)
    ours = port_cv.preprocess_images(images, 224).numpy()
    ref = jax_cv.preprocess_images(images, 224)
    assert ours.shape == ref.shape == (2, 224, 224, 3)
    assert np.abs(ours - ref).max() <= 1e-5
    same = _images(1, 224, 10)
    np.testing.assert_array_equal(port_cv.preprocess_images(same, 224).numpy(), jax_cv.preprocess_images(same, 224))


def test_clip_scorer_matches_jax(full_clip):
    """Both scorers load the same staged CLIPModel (the vision tower
    unmasked, the text tower pooled at EOT) and agree on every pair's
    similarity and on the score."""
    tok = CLIPBPETokenizer()
    images = _images(3, 40, 11)
    prompts = ["a red cube", "two cats on a mat", "a photograph of an astronaut riding a horse"]
    theirs = jax_cv.CLIPScorer(tok, model_dir=str(full_clip), text_cfg=TINY_TEXT, vision_cfg=TINY_VISION)
    ours = port_cv.CLIPScorer(tok, model_dir=str(full_clip), text_cfg=TINY_TEXT, vision_cfg=TINY_VISION,
                              device="cpu")
    assert ours.pretrained and theirs.pretrained
    ids = np.asarray(tok(prompts, max_length=77, padding="max_length", truncation=True).input_ids, np.int32)
    px = port_cv.preprocess_images(images, 28)
    np.testing.assert_allclose(ours.embed_text(ids).numpy(), np.asarray(theirs._embed_text(ids)), atol=1e-5)
    np.testing.assert_allclose(ours.embed_images(px).numpy(), np.asarray(theirs._embed_image(px.numpy())), atol=1e-5)
    assert abs(ours.score(images, prompts, batch=2) - theirs.score(images, prompts, batch=2)) <= 1e-3


def test_clip_scorer_falls_back_loudly(tmp_path):
    with pytest.warns(UserWarning, match="CLIP-SCORE FALLBACK"):
        scorer = port_cv.CLIPScorer(CLIPBPETokenizer(), model_dir=str(tmp_path), text_cfg=TINY_TEXT,
                                    vision_cfg=TINY_VISION, device="cpu")
    assert not scorer.pretrained
    assert 0.0 <= scorer.score(_images(2, 28, 12), ["a", "b"]) <= 100.0


def test_clip_score_cli_prints_its_json_line(full_clip, tmp_path, monkeypatch, capsys):
    """The CLI over 2 PNGs (read through read_image) with the staged tiny
    CLIP prints the JAX CLI's JSON keys and the scorer's value."""
    from PIL import Image

    import functools

    from stable_diffusion_pytorch_tpu_torch.scripts import clip_score

    monkeypatch.setattr(clip_score, "CLIPScorer",
                        functools.partial(port_cv.CLIPScorer, text_cfg=TINY_TEXT, vision_cfg=TINY_VISION))
    images = _images(2, 40, 13)
    for i, im in enumerate(images):
        Image.fromarray(im).save(tmp_path / f"img_{i}.png")
    out = clip_score.main(["--images-dir", str(tmp_path), "--prompt", "a cat", "--model-dir", str(full_clip),
                           "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and set(line) == {"metric", "value", "unit", "num_images", "pretrained"}
    assert line["metric"] == "clip_score" and line["num_images"] == 2 and line["pretrained"] is True
    scorer = port_cv.CLIPScorer(CLIPBPETokenizer(), model_dir=str(full_clip), text_cfg=TINY_TEXT,
                                vision_cfg=TINY_VISION, device="cpu")
    assert line["value"] == round(scorer.score(images, ["a cat"] * 2), 4)
