"""Fréchet distance (FID) and its feature extractors (port of stable_diffusion_pytorch_tpu/utils/fid.py).

The statistics and the distance are the JAX package's numpy code, copied
(the port imports nothing of that package): |mu1 - mu2|^2 + Tr(S1 + S2 -
2 (S1^(1/2) S2 S1^(1/2))^(1/2)), each square root by eigendecomposition of
the symmetrized matrix with its eigenvalues clipped at 0 and 1e-10 added.
With fewer samples than dimensions the covariances are rank-deficient, so
that eps leaves FID of a set with itself a little above 0.

Extractors take images [B, H, W, 3] in [-1, 1] (numpy or tensors) and
return float64 numpy features:

- :class:`InceptionFeatureExtractor` (``fid_inception``), the canonical
  metric: InceptionV3 pool3 (``models/inception.py``) from staged weights,
  ``transform_input`` on, the images resized to 299x299 bilinearly with
  half-pixel centres and no antialiasing (``F.interpolate(...,
  align_corners=False)``, which the JAX package's extractor matches with
  ``antialias=False``). It stands in for both of the JAX package's
  ``fid_inception`` extractors: its Flax tower and its torchvision one
  compute the same features, and the card's machine has no torchvision.
- :class:`RandomInceptionFeatureExtractor` (``fid_inception_random``): the
  same tower with He-normal conv weights from a seeded torch generator and
  identity affines; a proxy, not comparable to canonical numbers.
- :class:`VAEFeatureExtractor` (``fid_vae``): the VAE posterior means, pooled.

Every extractor computes in full float32 (``utils/precision.py``: no TF32
inside its call), so features do not move with the process's TF32 switches;
card and CPU then differ only by summation order. On a CUDA device each
extractor's features are one CUDA graph per batch signature (the JAX
package's jitted ``_extract``), its graphs in one pool
(``utils/graphs.py``); ``capture=False`` runs them eagerly.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stable_diffusion_pytorch_tpu_torch.utils.graphs import GraphPool, module_tensors, replayed
from stable_diffusion_pytorch_tpu_torch.utils.precision import full_float32


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """features [N, D] -> (mean [D], covariance [D, D])."""
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_psd(mat: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix via eigh."""
    sym = (mat + mat.T) / 2.0
    vals, vecs = np.linalg.eigh(sym)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals + eps)) @ vecs.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """FID between N(mu1, S1) and N(mu2, S2); Tr((S1 S2)^(1/2)) as
    Tr((S1^(1/2) S2 S1^(1/2))^(1/2)), which is symmetric PSD."""
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    covmean = _sqrtm_psd(s1_half @ sigma2 @ s1_half)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(covmean))


def fid_from_features(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    return frechet_distance(*compute_statistics(feats_a), *compute_statistics(feats_b))


def _images(images, device) -> torch.Tensor:
    if not torch.is_tensor(images):
        images = torch.from_numpy(np.asarray(images, np.float32))
    return images.to(device=device, dtype=torch.float32)


def resize_299(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> [B, 299, 299, 3]: bilinear, half-pixel centres, no antialiasing."""
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(299, 299), mode="bilinear", align_corners=False,
                      antialias=False)
    return x.permute(0, 2, 3, 1)


def _device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


class VAEFeatureExtractor:
    """Offline proxy features: the VAE posterior means, average-pooled to
    ``pool`` x ``pool`` and flattened -> [B, latent_ch * pool * pool]."""

    name = "fid_vae"

    def __init__(self, vae: torch.nn.Module, pool: int = 4, capture: bool = True):
        self.vae = vae
        self.pool = pool
        self.capture = capture
        self._graphs = GraphPool()

    def _features(self, images: torch.Tensor) -> torch.Tensor:
        with full_float32():
            mean = self.vae.encode(images).mean.float()
        b, h, w, c = mean.shape
        pool = self.pool
        ph = max(h // pool, 1)
        mean = mean[:, : ph * pool, : ph * pool, :]
        return mean.reshape(b, pool, ph, pool, ph, c).mean(dim=(2, 4)).reshape(b, -1)

    @torch.no_grad()
    def __call__(self, images) -> np.ndarray:
        x = _images(images, _device(self.vae))
        feats = replayed(self._graphs, self._features, x, what=f"the VAE features ({list(x.shape)})",
                         pinned=module_tensors(self.vae), capture=self.capture)
        return feats.cpu().numpy().astype(np.float64)


class _TowerExtractor:
    """InceptionV3 pool3 features of images resized to 299x299, in full f32."""

    def __init__(self, model, feat_dim: int = 0, capture: bool = True):
        self.model = model.eval().requires_grad_(False)
        self.feat_dim = feat_dim
        self.capture = capture
        self._graphs = GraphPool()

    def _features(self, images: torch.Tensor) -> torch.Tensor:
        with full_float32():
            feats = self.model(resize_299(images))
        return feats[:, : self.feat_dim] if self.feat_dim else feats

    @torch.no_grad()
    def __call__(self, images) -> np.ndarray:
        x = _images(images, _device(self.model))
        feats = replayed(self._graphs, self._features, x, what=f"the Inception features ({list(x.shape)})",
                         pinned=module_tensors(self.model), capture=self.capture)
        return feats.cpu().numpy().astype(np.float64)


class InceptionFeatureExtractor(_TowerExtractor):
    """Canonical InceptionV3 pool3 features from staged weights
    (``{model_dir}/inception/inception_v3.{npz,safetensors,pth}``, or
    ``state``: :class:`InceptionV3Pool3`'s state dict), ``transform_input``
    on, on ``device`` (the card unless the caller asks for the CPU);
    ``capture`` as the other extractors'."""

    name = "fid_inception"

    def __init__(self, state: Optional[dict] = None, model_dir: str = "data/pretrained", device="cuda",
                 capture: bool = True):
        from stable_diffusion_pytorch_tpu_torch.models.build import require_device
        from stable_diffusion_pytorch_tpu_torch.models.inception import InceptionV3Pool3, load_inception_state

        device = require_device(device)
        if state is None:
            state = load_inception_state(model_dir)
        if state is None:
            raise FileNotFoundError(
                f"no InceptionV3 weights staged: expected {model_dir}/inception/inception_v3.npz|.safetensors|.pth "
                "(a torchvision inception_v3 state dict or the JAX package's converted params)")
        with torch.device(device):
            model = InceptionV3Pool3(transform_input=True)
        model.load_state_dict(state, strict=True)
        super().__init__(model, capture=capture)


class RandomInceptionFeatureExtractor(_TowerExtractor):
    """Proxy features of a fixed-seed random InceptionV3: conv weights
    N(0, 2 / fan_in) from a torch generator seeded with ``seed`` (drawn on the
    CPU, so every device gets the same tower), folded-BN affines at identity;
    ``feat_dim`` > 0 keeps that many pool3 channels (a random projection, the
    channels of a random tower being exchangeable)."""

    name = "fid_inception_random"

    def __init__(self, seed: int = 0, feat_dim: int = 0, device="cuda", capture: bool = True):
        from stable_diffusion_pytorch_tpu_torch.models.build import require_device
        from stable_diffusion_pytorch_tpu_torch.models.inception import InceptionV3Pool3

        device = require_device(device)
        model = InceptionV3Pool3()
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("conv.weight"):
                    p.normal_(0.0, float(np.sqrt(2.0 / p[0].numel())), generator=gen)
        super().__init__(model.to(device), feat_dim, capture=capture)


def fid_between(
    extractor: Callable[[np.ndarray], np.ndarray],
    images_a: Iterable[np.ndarray],
    images_b: Iterable[np.ndarray],
    batch_size: int = 16,
) -> float:
    """FID between two image collections ([H, W, 3] arrays in [-1, 1])."""

    def featurize(images) -> np.ndarray:
        images = list(images)
        return np.concatenate([extractor(np.stack(images[i: i + batch_size]))
                               for i in range(0, len(images), batch_size)])

    return fid_from_features(featurize(images_a), featurize(images_b))
