"""The trainers' data options and their plumbing, port vs the JAX package, on the CPU.

- ``device_preprocess``: uint8 rows, non-square (short side shrunk or grown),
  the center crop and a random crop with flips (the JAX draws handed in),
  against the JAX function: 1e-6 absolute on [-1, 1] (the two antialiased
  bilinear resizes agree to 4e-7 on the CPU). On the card, whose resize
  kernel sums its taps in another order, ``chip_smoke.py`` holds it to its
  CPU run within 1e-4 (about 1/80 of a uint8 step; 2.4e-5 measured).
- The latent cache: built by the port (a one-level VAE and a one-layer CLIP
  tower on seeded weights) and read by the JAX ``LatentCacheDataset``
  and ``collate_latents``, and built by the JAX package and read by the
  port's: the same arrays. The two builds' moments agree within 1e-4 absolute
  (f32 encoders, sums in another order) and their f16 context within 2e-3
  (an f16 step at the embeddings' size).
- Hugging Face datasets on an imagefolder built here (``datasets`` is
  imported only when a dataset is loaded; no hub name is ever passed): the
  reference's windows, the columns, the captions and token ids equal JAX's;
  the pixels within 2e-2 (the port resizes with torch's antialiased bilinear
  filter, the JAX package with PIL's), the uint8 rows within 3 levels; the
  fallback when loading fails (``load_dataset`` replaced by one that raises)
  gives JAX's synthetic rows, tagged, and JAX's banner.
- Rows under ``--device-preprocess``: the synthetic rows, their batches and
  the test images equal JAX's; ``ControlNetDataset`` refuses them.
- ``--with-tracking``: JAX's ``ImportError`` without wandb, and
  ``NotImplementedError`` for another platform; the persistent fields of a
  record. ``utils/errors.py:record``: the crash report, and no report for
  ``SystemExit``.
"""

import json
import os
import sys
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu.models import autoencoder as jax_vae  # noqa: E402
from stable_diffusion_pytorch_tpu.models import clip as jax_clip  # noqa: E402
from stable_diffusion_pytorch_tpu.models.bpe import CLIPBPETokenizer as JaxBPE  # noqa: E402
from stable_diffusion_pytorch_tpu.utils import data as jax_data  # noqa: E402
from stable_diffusion_pytorch_tpu.utils import latent_cache as jax_cache  # noqa: E402
from stable_diffusion_pytorch_tpu.utils import preprocess as jax_pre  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig, ClipConfig  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.autoencoder import AutoEncoderKL  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.bpe import CLIPBPETokenizer  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.clip import CLIPModel, CLIPTextTransformer  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.args import LogConfig  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import convert  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import data as port_data  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import latent_cache as port_cache  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import preprocess as port_pre  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.errors import record  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.tracking import Tracker  # noqa: E402
from test_torch_port_train_step import random_params  # noqa: E402

torch.set_num_threads(2)


def _cfgs(**kw):
    return port_data.DatasetConfig(**kw), jax_data.DatasetConfig(**kw)


@pytest.mark.parametrize("shape,res", [((2, 24, 40, 3), 16), ((2, 37, 29, 3), 17), ((3, 10, 13, 3), 16)],
                         ids=["shrink_wide", "shrink_tall", "grow"])
def test_device_preprocess_matches_jax(shape, res):
    raw = np.random.default_rng(res).integers(0, 256, shape).astype(np.uint8)
    center = port_pre.device_preprocess(torch.from_numpy(raw), res)
    np.testing.assert_allclose(center.numpy(), np.asarray(jax_pre.device_preprocess(jnp.asarray(raw), res)),
                               rtol=0, atol=1e-6)
    key = jax.random.PRNGKey(shape[1])
    ref = jax_pre.device_preprocess(jnp.asarray(raw), res, center_crop=False, random_flip=True, key=key)
    k_top, k_left, k_flip = jax.random.split(key, 3)
    new_h, new_w = port_pre.resized_size(shape[1], shape[2], res)
    crop = tuple(int(jax.random.randint(k, (), 0, n - res + 1)) for k, n in ((k_top, new_h), (k_left, new_w)))
    flip = torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.5, (shape[0], 1, 1, 1))).reshape(-1))
    out = port_pre.device_preprocess(torch.from_numpy(raw), res, center_crop=False, random_flip=True, crop=crop,
                                     flip=flip)
    assert out.shape == (shape[0], res, res, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    drawn = port_pre.make_preprocess_fn(res, False, True)(torch.from_numpy(raw), torch.Generator().manual_seed(0))
    assert drawn.shape == out.shape and drawn.abs().max() <= 1.0


# a one-level VAE (f = 1) and a one-layer CLIP tower: the cache's arrays at the
# least compile time (the encoders' own parity is held elsewhere)
VAE_KW = dict(in_channels=3, latent_channels=4, out_channels=3, autoencoder_channels_list=[8],
              autoencoder_num_res_blocks=1, groups=4, kl_weight=1.0)
CLIP_KW = dict(d_model=16, n_layers=1, n_heads=2, intermediate=32, max_positions=77)


def encoders():
    """(JAX VAE module, its params, JAX text encoder), (port VAE, port text encoder), the same weights."""
    vae_cfg = jax_vae.AutoencoderConfig(**VAE_KW)
    j_vae, j_clip = jax_vae.AutoEncoderKL.from_config(vae_cfg), jax_clip.CLIPTextTransformer(**CLIP_KW)
    v = random_params(j_vae, 1, jnp.zeros((1, 8, 8, 3)))
    c = random_params(j_clip, 2, jnp.zeros((1, 77), jnp.int32))
    te = jax_clip.CLIPModel.__new__(jax_clip.CLIPModel)  # the facade around the tiny tower, offline BPE
    te.cfg, te.max_seq_len, te.module, te.params, te._ti = jax_clip.ClipConfig(model_dir=None), 77, j_clip, c, None
    te.tokenizer = JaxBPE(max_seq_len=77)
    te._encode = jax.jit(j_clip.apply)
    p_vae = AutoEncoderKL(AutoencoderConfig(**VAE_KW))
    p_vae.load_state_dict(convert.to_torch(convert.autoencoder_state_dict(v, vae_cfg)), strict=True)
    p_clip = CLIPTextTransformer(**CLIP_KW)
    p_clip.load_state_dict(convert.to_torch(convert.clip_state_dict(c)), strict=True)
    return (j_vae, v, te), (p_vae.eval(), CLIPModel(ClipConfig(model_dir=None), p_clip.eval()))


def test_latent_cache_written_by_the_port_reads_in_jax_and_back(tmp_path):
    (j_vae, v, j_te), (p_vae, p_te) = encoders()
    pc, jc = _cfgs(dataset="synthetic", resolution=8, max_train_samples=4)
    ours = tmp_path / "port.npz"
    port_cache.build_latent_cache(p_vae, port_data.get_dataset(pc, "train", CLIPBPETokenizer()), str(ours),
                                  batch_size=3, text_encoder=p_te)
    theirs = tmp_path / "jax.npz"
    jax_cache.build_latent_cache(j_vae, v, jax_data.get_dataset(jc, "train", JaxBPE()), str(theirs), batch_size=3,
                                 text_encoder=j_te)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a) == sorted(b) == ["context_emb", "input_ids", "moments", "uncond_emb"]
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_allclose(a["moments"], b["moments"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(a["context_emb"].astype(np.float32), b["context_emb"].astype(np.float32),
                                   rtol=0, atol=2e-3)
        np.testing.assert_allclose(a["uncond_emb"], b["uncond_emb"], rtol=0, atol=1e-4)
        assert a["moments"].shape == (4, 8, 8, 8)
    for written, reader, other in ((ours, jax_cache, port_cache), (theirs, port_cache, jax_cache)):
        read, own = reader.LatentCacheDataset(str(written)), other.LatentCacheDataset(str(written))
        assert len(read) == len(own) == 4 and read.has_text_cache
        np.testing.assert_array_equal(read.uncond_emb, own.uncond_emb)
        rows = [read[i] for i in (2, 0)]
        for x, y in zip(rows, [own[i] for i in (2, 0)]):
            assert sorted(x) == sorted(y) == ["context_emb", "input_ids", "moments"]
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
        got, want = reader.collate_latents(rows), other.collate_latents(rows)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


N_ROWS = 8


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    pytest.importorskip("datasets")
    from PIL import Image

    root = tmp_path_factory.mktemp("hf_images")
    d = root / "train"
    d.mkdir()
    rows = []
    for i in range(N_ROWS):
        img = (np.random.default_rng(i).random((24, 32, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(d / f"img_{i}.png")
        rows.append(f"img_{i}.png,a synthetic prompt {i}")
    (d / "metadata.csv").write_text("file_name,text\n" + "\n".join(rows) + "\n")
    return str(root)


def _hf_cfgs(hf_dir, tmp_path, **kw):
    return _cfgs(dataset=hf_dir, data_dir=str(tmp_path / "cache"), resolution=16, max_train_samples=5,
                 max_val_samples=2, max_test_samples=1, **kw)


def test_hf_windows_and_rows_match_jax(hf_dir, tmp_path):
    pc, jc = _hf_cfgs(hf_dir, tmp_path)
    ours_tok, jax_tok = CLIPBPETokenizer(), JaxBPE()
    for split, n in (("train", 5), ("validation", 2), ("test", N_ROWS)):  # test: the reference's window quirk
        ours, theirs = port_data.get_dataset(pc, split, ours_tok), jax_data.get_dataset(jc, split, jax_tok)
        assert isinstance(ours, port_data.HFImageTextDataset) and not ours.synthetic_fallback
        assert len(ours) == len(theirs) == n
        assert (ours.image_column, ours.caption_column) == (theirs.image_column, theirs.caption_column)
        for i in range(n):
            a, b = ours[i], theirs[i]
            assert a["text"] == b["text"] and sorted(a) == sorted(b)
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
            assert a["pixel_values"].shape == (16, 16, 3)
            np.testing.assert_allclose(a["pixel_values"], b["pixel_values"], rtol=0, atol=2e-2)
    assert port_data.get_dataset(pc, "validation", ours_tok)[0]["text"] == "a synthetic prompt 5"
    batch = next(iter(port_data.DataLoader(port_data.get_dataset(pc, "train", ours_tok), batch_size=2)))
    assert batch["pixel_values"].shape == (2, 16, 16, 3) and batch["input_ids"].shape == (2, 77)


def test_hf_device_preprocess_rows_match_jax(hf_dir, tmp_path):
    pc, jc = _hf_cfgs(hf_dir, tmp_path, device_preprocess=True)
    ours, theirs = port_data.get_dataset(pc, "train", CLIPBPETokenizer()), jax_data.get_dataset(jc, "train", JaxBPE())
    for i in range(3):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b) == ["input_ids", "raw_image", "text"]
        assert a["raw_image"].dtype == np.uint8 and a["raw_image"].shape == (16, 16, 3)
        assert np.abs(a["raw_image"].astype(int) - b["raw_image"].astype(int)).max() <= 3
    batch = port_data.collate_fn([ours[0], ours[1]])
    assert sorted(batch) == ["input_ids", "raw_images"] and batch["raw_images"].dtype == np.uint8


def test_hf_load_failure_falls_back_to_tagged_synthetic_rows_as_jax(tmp_path, monkeypatch):
    datasets = pytest.importorskip("datasets")

    def refuse(*args, **kwargs):
        raise FileNotFoundError(f"no dataset {args[0]!r} here")

    monkeypatch.setattr(datasets, "load_dataset", refuse)
    pc, jc = _cfgs(dataset="some/dataset", data_dir=str(tmp_path), resolution=16, max_train_samples=6)
    banners = []
    for get, cfg, tok in ((port_data.get_dataset, pc, CLIPBPETokenizer()), (jax_data.get_dataset, jc, JaxBPE())):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ds = get(cfg, "train", tok)
        banners.append([str(w.message) for w in caught if "DATASET FALLBACK" in str(w.message)])
        assert ds.synthetic_fallback and len(ds) == 6
        if get is port_data.get_dataset:
            ours = ds
    assert banners[0] == banners[1] and len(banners[0]) == 1
    assert "could not load 'some/dataset' (FileNotFoundError: no dataset 'some/dataset' here)" in banners[0][0]
    for i in (0, 5):
        a, b = ours[i], ds[i]
        np.testing.assert_array_equal(a["pixel_values"], b["pixel_values"])
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    for wrap in (port_data.ControlNetDataset(ours), port_data.TextualInversionDataset(ours, "<c>", None)):
        assert wrap.synthetic_fallback


def test_device_preprocess_synthetic_rows_batches_and_test_images_match_jax():
    pc, jc = _cfgs(dataset="synthetic", resolution=16, max_train_samples=4, max_test_samples=3,
                   device_preprocess=True, random_flip=True)
    ours, theirs = port_data.get_dataset(pc, "train", CLIPBPETokenizer()), jax_data.get_dataset(jc, "train", JaxBPE())
    rows = [(ours[i], theirs[i]) for i in range(3)]
    for a, b in rows:
        assert sorted(a) == sorted(b) == ["input_ids", "raw_image", "text"]
        np.testing.assert_array_equal(a["raw_image"], b["raw_image"])
    got = port_data.collate_fn([a for a, _ in rows])
    want = jax_data.collate_fn([b for _, b in rows])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    tests = port_data.sample_test_image(pc, "test", CLIPBPETokenizer(), num=3)
    for a, b in zip(tests, jax_data.sample_test_image(jc, "test", JaxBPE(), num=3)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="device_preprocess unsupported"):
        port_data.ControlNetDataset(ours)[0]


def test_tracking_without_wandb_and_persistent_fields(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # absent, whatever is installed
    with pytest.raises(ImportError, match="You passed with_tracking and report_to `wandb`; wandb is not installed"):
        Tracker(LogConfig(logging_dir=str(tmp_path), with_tracking=True), "run")
    with pytest.raises(NotImplementedError, match="Currently only support wandb"):
        Tracker(LogConfig(logging_dir=str(tmp_path), with_tracking=True, report_to="tensorboard"), "run")
    tracker = Tracker(LogConfig(logging_dir=str(tmp_path)), "run")
    tracker.set_persistent(synthetic_fallback=True)
    tracker.log({"train_loss": 0.5}, step=3)
    tracker.log_images({"sampled image": np.zeros((4, 4, 3), np.uint8)}, step=3)  # no sink: nothing to do
    tracker.finish()
    with open(tracker.jsonl_path) as f:
        rec = json.loads(f.read())
    assert rec["step"] == 3 and rec["synthetic_fallback"] is True and rec["train_loss"] == 0.5


def test_record_writes_a_crash_report_and_reraises(tmp_path):
    crash_dir = str(tmp_path / "crashes")

    def broken(x):
        raise RuntimeError(f"bad {x}")

    with pytest.raises(RuntimeError, match="bad 3"):
        record(broken, crash_dir=crash_dir)(3)
    (name,) = os.listdir(crash_dir)
    assert name.startswith("host0_") and name.endswith(".json")
    with open(os.path.join(crash_dir, name)) as f:
        report = json.load(f)
    assert report["host"] == 0 and report["fn"] == "broken" and report["exception"] == "RuntimeError: bad 3"
    assert "raise RuntimeError" in report["traceback"] and isinstance(report["argv"], list)
    with pytest.raises(SystemExit):
        record(lambda: sys.exit(2), crash_dir=crash_dir)()
    assert len(os.listdir(crash_dir)) == 1
    assert record(lambda x: x + 1, crash_dir=crash_dir)(1) == 2
