"""Data pipeline and image output (port of stable_diffusion_pytorch_tpu/utils/data.py).

Training input: ``DatasetConfig`` (the JAX package's fields), the host-side
transforms, caption tokenization, ``collate_fn``, the offline
``SyntheticTextImageDataset`` (rows are a pure function of their index, equal
to the JAX package's), the synthetic branch of ``get_dataset`` and the
deterministic ``DataLoader`` with its optional prefetch thread. Batches are
numpy, NHWC float32 pixels in [-1, 1], or under ``--device-preprocess``
uint8 ``raw_images`` the train step normalizes on the device
(``utils/preprocess.py``); the trainer moves them to the device. Any other
``--dataset`` loads through Hugging Face ``datasets`` (imported when used)
into ``HFImageTextDataset`` with the reference's train/validation/test
windows (``_split_window``), and falls back, loudly, to the synthetic rows
tagged ``synthetic_fallback`` when loading fails. The personalization datasets:
``TextualInversionDataset`` (template captions with the placeholder),
``FolderPromptDataset`` and ``DreamBoothDataset`` with ``dreambooth_collate``
(instance and class rows interleaved), and ``ControlNetDataset`` with its
default hint, ``edge_hint``; each row equals the JAX package's.

Image output without PIL: ``detransform`` ([-1, 1] -> uint8) and a stdlib PNG
writer (``zlib`` and ``struct``; 8-bit grayscale, RGB or RGBA, filter type 0
on every row). Unlike the JAX package's ``to_img``, a name that already ends
in ``.png`` is not given a second suffix. Image input (img2img, inpaint,
ControlNet hints): ``read_image``, through PIL, as the JAX package reads them.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence

import numpy as np

from stable_diffusion_pytorch_tpu_torch.config import BaseConfig

_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type


@dataclass
class DatasetConfig(BaseConfig):
    """The JAX package's dataset flags (the reference's utils/prepare_dataset.py:26-61)."""

    dataset: str = field(
        default="poloclub/diffusiondb",
        metadata={"help": "name of the dataset to use. Use 'synthetic' for the offline procedural dataset."},
    )
    subset: Optional[str] = field(
        default=None,
        metadata={"help": "subset of the dataset to use."},
    )
    data_dir: str = field(
        default="data/dataset",
        metadata={"help": "Cache directory to store loaded dataset."},
    )
    dataloader_num_workers: int = field(
        default=4,
        metadata={
            "help": "number of workers for the dataloaders. >0 decodes rows "
            "on a thread pool: the dataset's __getitem__ must be thread-safe "
            "(the built-in HF/synthetic/latent-cache datasets are; pass 0 to "
            "serialize access for custom datasets that share file handles or "
            "decoders across calls)."
        },
    )
    resolution: int = field(default=64, metadata={"help": "resolution of the images."})
    center_crop: bool = field(
        default=True, metadata={"help": "whether to apply center cropping."}
    )
    random_flip: bool = field(
        default=False, metadata={"help": "whether to apply random flipping."}
    )
    max_train_samples: Optional[int] = field(
        default=9000, metadata={"help": "max number of training samples to load."}
    )
    max_val_samples: Optional[int] = field(
        default=500, metadata={"help": "max number of validation samples to load."}
    )
    max_test_samples: Optional[int] = field(
        default=500, metadata={"help": "max number of test samples to load."}
    )
    latent_cache: Optional[str] = field(
        default=None,
        metadata={
            "help": "Path to a VAE-latent cache (.npz). train_unet builds it on "
            "first use and then trains from cached latents instead of pixels."
        },
    )
    device_preprocess: bool = field(
        default=False,
        metadata={
            "help": "Ship raw uint8 images to the accelerator and run "
            "normalize/flip inside the jitted train step (4x less host->device "
            "bandwidth; pod-scale input path)."
        },
    )


# --------------------------------------------------------------------------- #
# transforms
# --------------------------------------------------------------------------- #


def resize_image(img: np.ndarray, resolution: int) -> np.ndarray:
    """Resize so the SHORT side == resolution. img: [H, W, C] uint8.

    An image already at that size is returned unchanged (PIL's resize, which
    the JAX package calls, is then a copy). Other sizes use torch's bilinear
    resize with antialiasing, close to PIL's but not bit-equal."""
    h, w = img.shape[:2]
    if h < w:
        new_h, new_w = resolution, max(resolution, round(w * resolution / h))
    else:
        new_h, new_w = max(resolution, round(h * resolution / w)), resolution
    if (new_h, new_w) == (h, w):
        return img
    import torch
    import torch.nn.functional as F

    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(new_h, new_w), mode="bilinear", antialias=True, align_corners=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def center_crop_image(img: np.ndarray, resolution: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = (h - resolution) // 2
    left = (w - resolution) // 2
    return img[top : top + resolution, left : left + resolution]


def random_crop_image(img: np.ndarray, resolution: int, rng: np.random.Generator) -> np.ndarray:
    h, w = img.shape[:2]
    top = int(rng.integers(0, h - resolution + 1))
    left = int(rng.integers(0, w - resolution + 1))
    return img[top : top + resolution, left : left + resolution]


def transform_image(
    img: np.ndarray,
    resolution: int,
    center_crop: bool = True,
    random_flip: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Resize -> crop -> (flip) -> [-1, 1] float32 HWC (prepare_dataset.py:127-142)."""
    rng = rng or np.random.default_rng(0)
    img = resize_image(img, resolution)
    img = center_crop_image(img, resolution) if center_crop else random_crop_image(img, resolution, rng)
    if random_flip and rng.random() < 0.5:
        img = img[:, ::-1]
    img = img.astype(np.float32) / 255.0
    return (img - 0.5) / 0.5


def tokenize_captions(
    captions: Sequence, tokenizer, is_train: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Token ids [N, 77] int32; a multi-caption row picks one caption with
    ``rng`` when training, its first otherwise (prepare_dataset.py:105-124)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    chosen: List[str] = []
    for caption in captions:
        if isinstance(caption, str):
            chosen.append(caption)
        elif isinstance(caption, (list, np.ndarray)):
            chosen.append(caption[int(rng.integers(len(caption)))] if is_train else caption[0])
        else:
            raise ValueError("Caption column should contain either strings or lists of strings.")
    out = tokenizer(
        chosen,
        max_length=getattr(tokenizer, "model_max_length", 77),
        padding="max_length",
        truncation=True,
    )
    return np.asarray(out.input_ids, dtype=np.int32)


def collate_fn(examples: Sequence[dict]) -> dict:
    """Stack rows into {"pixel_values": [B,H,W,3] f32, "input_ids": [B,77] int32}
    (uint8 ``raw_image`` rows into "raw_images" [B,H,W,3] uint8), and
    ``hint`` [B,H,W,C] f32 when the rows carry one (ControlNet)."""
    out = {"input_ids": np.stack([e["input_ids"] for e in examples]).astype(np.int32)}
    if "raw_image" in examples[0]:
        out["raw_images"] = np.stack([e["raw_image"] for e in examples])
    else:
        out["pixel_values"] = np.stack([e["pixel_values"] for e in examples]).astype(np.float32)
    if "hint" in examples[0]:
        out["hint"] = np.stack([e["hint"] for e in examples]).astype(np.float32)
    return out


# --------------------------------------------------------------------------- #
# datasets
# --------------------------------------------------------------------------- #


class SyntheticTextImageDataset:
    """Deterministic procedural text-image dataset for offline runs.

    Each row is a colored gradient with a circle, square or stripes and a
    matching caption; a row is a pure function of its index, split and epoch,
    drawn with the same numpy generators as the JAX package's, so both give
    the same rows. Under ``--device-preprocess`` a row carries the rendered
    uint8 image (``raw_image``) in place of ``pixel_values``."""

    _COLORS = [
        ("red", (220, 60, 50)),
        ("green", (70, 180, 90)),
        ("blue", (60, 90, 210)),
        ("yellow", (230, 200, 60)),
        ("purple", (150, 70, 190)),
        ("orange", (240, 140, 40)),
    ]
    _SHAPES = ["circle", "square", "stripes"]
    _SPLIT_OFFSET = {"train": 0, "validation": 10**6, "test": 2 * 10**6}

    def __init__(self, cfg: DatasetConfig, split: str, tokenizer, num_rows: int):
        self.cfg = cfg
        self.split = split
        self.tokenizer = tokenizer
        self.num_rows = num_rows
        self.resolution = cfg.resolution
        self.epoch = 0
        self.synthetic_fallback = False  # True where it stands in for a dataset that failed to load

    def set_epoch(self, epoch: int) -> None:
        """Vary augmentation randomness across epochs (DataLoader forwards this)."""
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_rows

    def _render(self, idx: int) -> np.ndarray:
        res = self.resolution
        rng = np.random.default_rng(idx + self._SPLIT_OFFSET[self.split])
        _, rgb = self._COLORS[idx % len(self._COLORS)]
        shape = self._SHAPES[(idx // len(self._COLORS)) % len(self._SHAPES)]
        yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res
        img = np.stack([yy * c / 255.0 for c in rgb], axis=-1) * 0.6 + 0.2
        cx, cy = rng.uniform(0.3, 0.7, size=2)
        r = rng.uniform(0.15, 0.3)
        if shape == "circle":
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r**2
        elif shape == "square":
            mask = (np.abs(yy - cy) < r) & (np.abs(xx - cx) < r)
        else:
            freq = rng.uniform(12, 28)
            phase = rng.uniform(0, 2 * np.pi)
            mask = (np.sin(xx * freq + phase) > 0.3) & (yy > 0.2) & (yy < 0.8)
        img[mask] = np.array(rgb, np.float32) / 255.0
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    def __getitem__(self, idx: int) -> dict:
        color_name = self._COLORS[idx % len(self._COLORS)][0]
        shape = self._SHAPES[(idx // len(self._COLORS)) % len(self._SHAPES)]
        caption = f"a {color_name} {shape} on a gradient background"
        img = self._render(idx)
        input_ids = tokenize_captions([caption], self.tokenizer)[0]
        if self.cfg.device_preprocess:
            return {"raw_image": img, "input_ids": input_ids, "text": caption}
        pixel_values = transform_image(
            img,
            self.cfg.resolution,
            center_crop=self.cfg.center_crop,
            random_flip=self.cfg.random_flip,
            rng=np.random.default_rng(np.random.SeedSequence([self.epoch, idx])),
        )
        return {"pixel_values": pixel_values, "input_ids": input_ids, "text": caption}


class HFImageTextDataset:
    """Rows of a Hugging Face dataset split, transformed when read
    (prepare_dataset.py:159-236): the image column (``image`` or ``img``)
    converted to RGB and transformed, the caption column (``text``,
    ``caption`` or ``prompt``; a list picks one per row and epoch in
    training, its first otherwise) tokenized. Under ``--device-preprocess``
    the host only resizes (short side) and center-crops to a uint8
    ``raw_image``."""

    def __init__(self, hf_dataset, cfg: DatasetConfig, tokenizer, is_train: bool):
        self.ds = hf_dataset
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.is_train = is_train
        self.epoch = 0
        self.synthetic_fallback = False
        cols = hf_dataset.column_names
        self.image_column = [c for c in ["image", "img"] if c in cols][0]
        self.caption_column = [c for c in ["text", "caption", "prompt"] if c in cols][0]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, idx: int) -> dict:
        row = self.ds[int(idx)]
        img = np.asarray(row[self.image_column].convert("RGB"))
        caption = row[self.caption_column]
        rng = np.random.default_rng(np.random.SeedSequence([self.epoch, idx]))
        input_ids = tokenize_captions([caption], self.tokenizer, self.is_train, rng=rng)[0]
        text = caption if isinstance(caption, str) else caption[0]
        if self.cfg.device_preprocess:
            raw = center_crop_image(resize_image(img, self.cfg.resolution), self.cfg.resolution)
            return {"raw_image": raw.astype(np.uint8), "input_ids": input_ids, "text": text}
        pixel_values = transform_image(
            img,
            self.cfg.resolution,
            center_crop=self.cfg.center_crop,
            random_flip=self.cfg.random_flip and self.is_train,
            rng=rng,
        )
        return {"pixel_values": pixel_values, "input_ids": input_ids, "text": text}


# --------------------------------------------------------------------------- #
# personalization datasets: textual inversion, DreamBooth, ControlNet
# --------------------------------------------------------------------------- #

# the textual-inversion paper's prompt templates (Gal et al. 2022,
# "imagenet_templates_small"), the JAX package's list
TI_TEMPLATES = [
    "a photo of a {}",
    "a rendering of a {}",
    "the photo of a {}",
    "a photo of a clean {}",
    "a photo of a dirty {}",
    "a dark photo of the {}",
    "a photo of my {}",
    "a photo of the cool {}",
    "a close-up photo of a {}",
    "a bright photo of the {}",
    "a cropped photo of a {}",
    "a photo of the {}",
    "a good photo of the {}",
    "a photo of one {}",
    "a rendition of the {}",
    "a photo of a nice {}",
    "a photo of a small {}",
]


class TextualInversionDataset:
    """Any image dataset's pixels with every caption replaced by a template
    holding the placeholder ("a photo of a <concept>"), tokenized by
    ``tokenize`` (the textual-inversion-aware ``CLIPModel.tokenize``, which
    expands the placeholder into its sentinel ids). The template is drawn
    per row and epoch from ``SeedSequence([epoch, idx, 7])``, as in the JAX
    package."""

    def __init__(self, base, placeholder_token: str, tokenize):
        self.base = base
        self.placeholder_token = placeholder_token
        self.tokenize = tokenize
        self.epoch = 0
        self.synthetic_fallback = bool(getattr(base, "synthetic_fallback", False))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, idx: int) -> dict:
        row = dict(self.base[int(idx)])
        rng = np.random.default_rng(np.random.SeedSequence([self.epoch, idx, 7]))
        text = TI_TEMPLATES[int(rng.integers(len(TI_TEMPLATES)))].format(self.placeholder_token)
        row["text"] = text
        row["input_ids"] = np.asarray(self.tokenize([text]).input_ids, dtype=np.int32)[0]
        return row


class FolderPromptDataset:
    """The images of a folder, every row captioned with one prompt (the
    DreamBooth instance and class sets). ``read(path)`` -> HWC uint8 RGB
    pixels; :func:`read_image` (Pillow) unless given another reader."""

    EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")

    def __init__(self, folder: str, prompt: str, cfg: DatasetConfig, tokenizer, read=None):
        self.folder = folder
        self.prompt = prompt
        self.cfg = cfg
        self.read = read or read_image
        self.paths = sorted(os.path.join(folder, f) for f in os.listdir(folder) if f.lower().endswith(self.EXTS))
        if not self.paths:
            raise ValueError(f"no images found under {folder!r}")
        self.input_ids = tokenize_captions([prompt], tokenizer)[0]
        self.epoch = 0
        self.synthetic_fallback = False

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        pixel_values = transform_image(
            self.read(self.paths[int(idx)]),
            self.cfg.resolution,
            center_crop=self.cfg.center_crop,
            random_flip=self.cfg.random_flip,
            rng=np.random.default_rng(np.random.SeedSequence([self.epoch, idx])),
        )
        return {"pixel_values": pixel_values, "input_ids": self.input_ids, "text": self.prompt}


class DreamBoothDataset:
    """Each instance row paired with a class (prior) row; the pairing shifts
    every epoch by a draw from ``SeedSequence([epoch])``. :func:`dreambooth_collate`
    interleaves the pairs."""

    def __init__(self, instance_ds, class_ds):
        self.instance_ds = instance_ds
        self.class_ds = class_ds
        self.epoch = 0
        self.synthetic_fallback = bool(getattr(instance_ds, "synthetic_fallback", False))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        for ds in (self.instance_ds, self.class_ds):
            if hasattr(ds, "set_epoch"):
                ds.set_epoch(epoch)

    def __len__(self) -> int:
        return max(len(self.instance_ds), len(self.class_ds))

    def __getitem__(self, idx: int) -> dict:
        inst = self.instance_ds[int(idx) % len(self.instance_ds)]
        shift = int(np.random.default_rng(np.random.SeedSequence([self.epoch])).integers(1 << 30))
        cls = self.class_ds[(int(idx) + shift) % len(self.class_ds)]
        return {"pixel_values": inst["pixel_values"], "input_ids": inst["input_ids"],
                "class_pixel_values": cls["pixel_values"], "class_input_ids": cls["input_ids"]}


def dreambooth_collate(examples: Sequence[dict]) -> dict:
    """B pairs -> one batch of 2B rows: instance rows at the even indices,
    class rows at the odd ones (the prior-preservation loss splits them so)."""
    pixels = np.empty((2 * len(examples),) + np.asarray(examples[0]["pixel_values"]).shape, np.float32)
    ids = np.empty((2 * len(examples),) + np.asarray(examples[0]["input_ids"]).shape, np.int32)
    for i, e in enumerate(examples):
        pixels[2 * i], pixels[2 * i + 1] = e["pixel_values"], e["class_pixel_values"]
        ids[2 * i], ids[2 * i + 1] = e["input_ids"], e["class_input_ids"]
    return {"pixel_values": pixels, "input_ids": ids}


def edge_hint(pixel_values: np.ndarray, threshold: float = 0.15) -> np.ndarray:
    """The default ControlNet hint: the Sobel-style edge map of a [-1, 1] HWC
    image (central differences of the channel mean, magnitude above
    ``threshold``), as a [-1, 1] 3-channel image."""
    gray = np.asarray(pixel_values, np.float32).mean(axis=-1)
    gy = np.zeros_like(gray)
    gx = np.zeros_like(gray)
    gy[1:-1, :] = gray[2:, :] - gray[:-2, :]
    gx[:, 1:-1] = gray[:, 2:] - gray[:, :-2]
    edges = (np.sqrt(gx * gx + gy * gy) > threshold).astype(np.float32)
    return np.repeat((edges * 2.0 - 1.0)[..., None], 3, axis=-1)


class ControlNetDataset:
    """An image-text dataset's rows with a ``hint``: ``hint_fn(pixel_values)``
    -> [H, W, C] in [-1, 1] (default :func:`edge_hint`). The hint needs pixel
    rows: ``--device-preprocess`` rows raise."""

    def __init__(self, base, hint_fn=None):
        self.base = base
        self.hint_fn = hint_fn or edge_hint
        self.synthetic_fallback = bool(getattr(base, "synthetic_fallback", False))

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, idx: int) -> dict:
        row = dict(self.base[int(idx)])
        if "pixel_values" not in row:
            raise ValueError("ControlNetDataset needs pixel rows (device_preprocess unsupported)")
        row["hint"] = self.hint_fn(row["pixel_values"])
        return row


def _split_window(cfg: DatasetConfig, split: str, total: int, logger=None) -> range:
    """The reference's windows over the one "train" split
    (prepare_dataset.py:181-215): train [0, max_train), validation the next
    max_val rows, test the next max_test; a window applies only when it ends
    strictly inside the dataset, else the split is the whole dataset."""
    mtr, mva, mte = cfg.max_train_samples, cfg.max_val_samples, cfg.max_test_samples
    if split == "train" and mtr is not None:
        if mtr < total:
            return range(0, mtr)
        if logger:
            logger.info(f"max_train_samples({mtr}) is larger than the dataset({total})")
    if split == "validation" and mva is not None:
        if mtr + mva < total:
            return range(mtr, mtr + mva)
        if logger:
            logger.info(f"max_val_samples({mva}) is larger than the dataset({total})")
    if split == "test" and mte is not None:
        if mtr + mva + mte < total:
            return range(mtr + mva, mtr + mva + mte)
        if logger:
            logger.info(f"max_test_samples({mte}) is larger than the dataset({total})")
    return range(total)


def _synthetic(args: DatasetConfig, split: str, tokenizer) -> SyntheticTextImageDataset:
    sizes = {
        "train": args.max_train_samples or 9000,
        "validation": args.max_val_samples or 500,
        "test": args.max_test_samples or 500,
    }
    return SyntheticTextImageDataset(args, split, tokenizer, sizes[split])


def get_dataset(args: DatasetConfig, split: str = "train", tokenizer=None, logger=None):
    """``--dataset synthetic``: the offline rows, ``max_{train,val,test}_samples``
    of them (9000/500/500 when unset). Any other name: ``datasets.load_dataset(
    name, subset, cache_dir=data_dir/name)["train"]`` windowed by
    :func:`_split_window` into :class:`HFImageTextDataset`; when loading
    fails, a warning banner and the synthetic rows, tagged
    ``synthetic_fallback`` (the trainer stamps it on every metrics record)."""
    if tokenizer is None:
        raise ValueError("you need to specify a tokenizer")
    if split not in {"train", "validation", "test"}:
        raise ValueError(f"unknown split {split!r}")
    if args.dataset == "synthetic":
        ds = _synthetic(args, split, tokenizer)
        if logger:
            logger.info(f"synthetic {split} dataset: {len(ds)} rows at {args.resolution}px")
        return ds
    try:
        from datasets import load_dataset

        hf = load_dataset(args.dataset, args.subset, cache_dir=os.path.join(args.data_dir, args.dataset))["train"]
    except Exception as e:  # not cached and no network: degrade to synthetic, loudly
        import warnings

        banner = (
            "\n" + "!" * 78 + "\n"
            f"!! DATASET FALLBACK: could not load {args.dataset!r} "
            f"({type(e).__name__}: {e});\n"
            "!! training will run on the SYNTHETIC offline dataset. If you "
            "expected real data,\n!! fix the dataset path/cache — this run's "
            "metrics are tagged synthetic_fallback.\n" + "!" * 78
        )
        warnings.warn(banner, stacklevel=2)
        if logger:
            logger.warning(banner)
        ds = _synthetic(args, split, tokenizer)
        ds.synthetic_fallback = True
        return ds
    window = _split_window(args, split, len(hf), logger)
    if len(window) < len(hf):
        hf = hf.select(window)
    if logger:
        logger.info(f"Loaded {len(hf)} {split} samples from dataset:{args.dataset}")
    return HFImageTextDataset(hf, args, tokenizer, is_train=split == "train")


def sample_test_image(args: DatasetConfig, split: str, tokenizer, logger=None, num: int = 10) -> List[np.ndarray]:
    """``num`` [-1, 1] HWC f32 images of ``split``, rows drawn with a numpy
    generator seeded 0 (the JAX package's ``sample_test_image``: the same
    rows); a ``--device-preprocess`` row's uint8 image is normalized here."""
    test_data = get_dataset(args, split=split, tokenizer=tokenizer, logger=logger)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(num):
        row = test_data[int(rng.integers(0, len(test_data)))]
        if "pixel_values" in row:
            out.append(row["pixel_values"])
        else:
            out.append((row["raw_image"].astype(np.float32) / 255.0 - 0.5) / 0.5)
    return out


class DataLoader:
    """Deterministic batcher with fixed shapes (drop_last), optionally with a
    prefetch thread.

    The order of an epoch is ``np.random.default_rng(seed + epoch)`` shuffling
    ``arange(len(dataset))``, then every ``num_shards``-th row from
    ``shard_id``: the JAX package's order. ``num_workers > 0`` decodes rows on
    a thread pool in a background producer that keeps ``prefetch`` collated
    batches queued; the batches are the same as the synchronous path's, in
    the same order. The dataset's ``__getitem__`` must then be thread-safe
    (the synthetic dataset is)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 42,
        drop_last: bool = True,
        shard_id: int = 0,
        num_shards: int = 1,
        collate=None,
        num_workers: int = 0,
        prefetch: int = 2,
    ):
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.collate = collate or collate_fn
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> List[np.ndarray]:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(indices)
        indices = indices[self.shard_id :: self.num_shards]
        return [indices[b * self.batch_size : (b + 1) * self.batch_size] for b in range(len(self))]

    def __iter__(self) -> Iterator[dict]:
        batches = self._batch_indices()
        if self.num_workers <= 0:
            for bidx in batches:
                rows = [self.dataset[int(i)] for i in bidx]
                if not rows:
                    return
                yield self.collate(rows)
            return
        yield from self._iter_async(batches)

    def _iter_async(self, batches: List[np.ndarray]) -> Iterator[dict]:
        import queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            # a bounded put that notices when the consumer has gone
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def _produce() -> None:
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    for bidx in batches:
                        if stop.is_set():
                            return
                        rows = list(ex.map(lambda i: self.dataset[int(i)], bidx))
                        if not rows:
                            break
                        if not _put(("batch", self.collate(rows))):
                            return
                _put(("done", None))
            except BaseException as exc:  # handed to the consumer, which raises it
                _put(("error", exc))

        producer = threading.Thread(target=_produce, name="dataloader-prefetch", daemon=True)
        producer.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "batch":
                    yield payload
                elif kind == "error":
                    raise payload
                else:
                    return
        finally:
            stop.set()
            try:  # drain so a blocked producer sees the stop flag and exits
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            producer.join(timeout=5.0)


# --------------------------------------------------------------------------- #
# image output
# --------------------------------------------------------------------------- #


def detransform(image) -> np.ndarray:
    """[B?, H, W, C] in [-1, 1] -> HWC uint8; drops a leading batch dim of 1."""
    arr = np.asarray(image, dtype=np.float32)
    if arr.ndim == 4 and arr.shape[0] == 1:
        arr = arr[0]
    arr = np.clip((arr + 1.0) / 2.0, 0.0, 1.0)
    return (arr * 255.0).astype(np.uint8)


def encode_png(pixels: np.ndarray) -> bytes:
    """HW, HW1, HW3 or HW4 uint8 -> PNG file bytes."""
    arr = np.asarray(pixels)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in _COLOR_TYPES:
        raise ValueError(f"expected uint8 HW/HWC with 1, 3 or 4 channels, got {arr.dtype} {arr.shape}")
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
        )

    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


def to_img(digit_img: np.ndarray, output_path: str = "", name: str = "sample") -> str:
    """Save HWC uint8 to ``{output_path}/{name}`` with a ``.png`` suffix added
    only when ``name`` lacks one. Returns the path written."""
    if output_path:
        os.makedirs(output_path, exist_ok=True)
    filename = name if name.lower().endswith(".png") else f"{name}.png"
    path = os.path.join(output_path, filename)
    with open(path, "wb") as f:
        f.write(encode_png(digit_img))
    return path


# --------------------------------------------------------------------------- #
# image input
# --------------------------------------------------------------------------- #


def read_image(path: str, mode: str = "RGB") -> np.ndarray:
    """An image file as uint8 through PIL's ``convert(mode)``: "RGB" gives
    [H, W, 3], "L" [H, W]. PIL is imported here, so the port runs without it
    until an image is read from a file."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert(mode))
