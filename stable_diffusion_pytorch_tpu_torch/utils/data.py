"""Data pipeline and image output (port of stable_diffusion_pytorch_tpu/utils/data.py).

Training input: ``DatasetConfig`` (the JAX package's fields), the host-side
transforms, caption tokenization, ``collate_fn``, the offline
``SyntheticTextImageDataset`` (rows are a pure function of their index, equal
to the JAX package's), the synthetic branch of ``get_dataset`` and the
deterministic ``DataLoader`` with its optional prefetch thread. Batches are
numpy, NHWC float32 pixels in [-1, 1]; the trainer moves them to the device.
The Hugging Face ``datasets`` branch, the latent cache and on-device
preprocessing are not ported yet and raise.

Image output without PIL: ``detransform`` ([-1, 1] -> uint8) and a stdlib PNG
writer (``zlib`` and ``struct``; 8-bit grayscale, RGB or RGBA, filter type 0
on every row). Unlike the JAX package's ``to_img``, a name that already ends
in ``.png`` is not given a second suffix.
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
    """Stack rows into {"pixel_values": [B,H,W,3] f32, "input_ids": [B,77] int32}."""
    return {
        "pixel_values": np.stack([e["pixel_values"] for e in examples]).astype(np.float32),
        "input_ids": np.stack([e["input_ids"] for e in examples]).astype(np.int32),
    }


# --------------------------------------------------------------------------- #
# datasets
# --------------------------------------------------------------------------- #


class SyntheticTextImageDataset:
    """Deterministic procedural text-image dataset for offline runs.

    Each row is a colored gradient with a circle, square or stripes and a
    matching caption; a row is a pure function of its index, split and epoch,
    drawn with the same numpy generators as the JAX package's, so both give
    the same rows."""

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
        pixel_values = transform_image(
            self._render(idx),
            self.cfg.resolution,
            center_crop=self.cfg.center_crop,
            random_flip=self.cfg.random_flip,
            rng=np.random.default_rng(np.random.SeedSequence([self.epoch, idx])),
        )
        return {
            "pixel_values": pixel_values,
            "input_ids": tokenize_captions([caption], self.tokenizer)[0],
            "text": caption,
        }


def get_dataset(args: DatasetConfig, split: str = "train", tokenizer=None, logger=None):
    """The offline synthetic dataset, ``max_{train,val,test}_samples`` rows
    (9000/500/500 when unset). Any other ``--dataset`` raises: loading Hugging
    Face datasets is not ported (ROADMAP queue 1, slice 2 follow-ups)."""
    if tokenizer is None:
        raise ValueError("you need to specify a tokenizer")
    if split not in {"train", "validation", "test"}:
        raise ValueError(f"unknown split {split!r}")
    if args.dataset != "synthetic":
        raise NotImplementedError(
            f"--dataset {args.dataset!r}: the port loads only --dataset synthetic; "
            "Hugging Face datasets are not ported (ROADMAP queue 1, slice 2 follow-ups)"
        )
    sizes = {
        "train": args.max_train_samples or 9000,
        "validation": args.max_val_samples or 500,
        "test": args.max_test_samples or 500,
    }
    if logger:
        logger.info(f"synthetic {split} dataset: {sizes[split]} rows at {args.resolution}px")
    return SyntheticTextImageDataset(args, split, tokenizer, sizes[split])


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
