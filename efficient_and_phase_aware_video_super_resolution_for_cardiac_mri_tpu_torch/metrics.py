"""Evaluation metrics (PyTorch), on denormalized [0, 255] images.

The port's counterpart of the JAX package's ``metrics.py``, which reproduces
the reference definitions (``src/model/metrics.py``):

* PSNR: ``10*log10(max² / (MSE + 1e-10))`` per sample over non-batch dims.
* SSIM: the reference's 11-tap window ``exp(-((x-m)/(2σ))²)`` (σ=1.5),
  normalized, separable product kernel, depthwise *valid* convolution, then
  the mean over the valid region.
* CardiacPSNR / CardiacSSIM: the same scores restricted to the per-patient
  motion bbox of ``coordinates.pkl``, as masks rather than crops: the masked
  mean equals the cropped score, and shapes stay fixed.

Inputs are channel-last, (N, H, W, C) for 2D and (N, D, H, W, C) for 3D,
as in the JAX package.  The filter runs in full fp32: the caller keeps
cuDNN's TF32 off (``main.py``), as the JAX package runs it at
``Precision.HIGHEST``.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch
import torch.nn.functional as F

from .config import METRICS


def _reference_gaussian_kernel(dim: int, kernel_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The reference's separable window (``metrics.py:67-77``); its profile
    is ``exp(-((x - size//2) / (2σ))²)``, not the standard gaussian."""
    xs = np.arange(kernel_size, dtype=np.float32)
    mean = kernel_size // 2
    g1 = 1.0 / (sigma * math.sqrt(2 * math.pi)) * np.exp(-(((xs - mean) / (2 * sigma)) ** 2))
    kernel = g1
    for _ in range(dim - 1):
        kernel = np.multiply.outer(kernel, g1)
    kernel = kernel / kernel.sum()
    return kernel.astype(np.float32)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Per-sample mean over non-batch dims, restricted to ``mask``."""
    reduced = tuple(range(1, x.dim()))
    if mask is None:
        return x.mean(dim=reduced)
    mask = mask.to(x.dtype).expand(x.shape)
    return (x * mask).sum(dim=reduced) / mask.sum(dim=reduced).clamp_min(1.0)


class Metric:
    """Base: a named metric callable.  ``per_sample`` gives one value per
    leading-axis sample; ``__call__`` averages them when ``size_average``."""

    requires_name = False  # Cardiac metrics need the patient name

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def per_sample(self, output, target, mask=None) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, output, target, mask=None):
        values = self.per_sample(output, target, mask)
        return values.mean() if self.size_average else values

    @property
    def name(self) -> str:
        return self.__class__.__name__


@METRICS.register()
class PSNR(Metric):
    """Reference ``src/model/metrics.py:9-36``."""

    def __init__(self, size_average: bool = True, max_value: int = 255):
        super().__init__(size_average)
        self.max_value = max_value

    def per_sample(self, output, target, mask=None):
        mse = _masked_mean(torch.square(output - target), mask)
        return 10.0 * torch.log10(self.max_value**2 / (mse + 1e-10))


@METRICS.register()
class SSIM(Metric):
    """Reference ``src/model/metrics.py:39-113`` (valid depthwise conv)."""

    def __init__(self, dim: int = 2, channels: int = 1, size_average: bool = True,
                 value_range: int = 255):
        if dim not in (2, 3):
            raise ValueError(f"SSIM supports dim=2 or dim=3; got dim={dim}.")
        super().__init__(size_average)
        self.dim = dim
        self.channels = channels
        self.value_range = value_range
        self.c1 = (0.01 * value_range) ** 2
        self.c2 = (0.03 * value_range) ** 2
        k = torch.from_numpy(_reference_gaussian_kernel(dim))
        # depthwise weight (C, 1, *window)
        self.kernel = k.expand(channels, 1, *k.shape).contiguous()

    def _filter(self, x: torch.Tensor) -> torch.Tensor:
        # channel-last in and out; NC(D)HW for the conv
        to_first = (0, x.dim() - 1, *range(1, x.dim() - 1))
        to_last = (0, *range(2, x.dim()), 1)
        conv = F.conv2d if self.dim == 2 else F.conv3d
        kernel = self.kernel.to(device=x.device, dtype=x.dtype)
        y = conv(x.permute(to_first), kernel, groups=self.channels)
        return y.permute(to_last)

    def ssim_map(self, output, target):
        mu1 = self._filter(output)
        mu2 = self._filter(target)
        sigma1_sq = self._filter(output * output) - mu1 * mu1
        sigma2_sq = self._filter(target * target) - mu2 * mu2
        sigma12 = self._filter(output * target) - mu1 * mu2
        return ((2 * mu1 * mu2 + self.c1) * (2.0 * sigma12 + self.c2)) / (
            (mu1 * mu1 + mu2 * mu2 + self.c1) * (sigma1_sq + sigma2_sq + self.c2)
        )

    def per_sample(self, output, target, mask=None):
        return _masked_mean(self.ssim_map(output, target), mask)


class _CardiacMixin:
    """Shared bbox → mask machinery for the cardiac metrics."""

    requires_name = True
    #: shrink of the valid-conv output per spatial edge (0 for PSNR, 10 for SSIM)
    _valid_shrink = 0

    def __init__(self, coordinates_path: str):
        with open(coordinates_path, "rb") as f:
            self.coordinates = pickle.load(f)
        self._mask_cache: dict[tuple, np.ndarray] = {}

    def mask_for(self, name: str, spatial_shape: tuple[int, int]) -> np.ndarray:
        """(1, H', W', 1) float mask for the patient bbox (cached)."""
        h0, hn, w0, wn = self.coordinates[name]
        s = self._valid_shrink
        H, W = spatial_shape[0] - s, spatial_shape[1] - s
        key = (name, H, W)
        if key not in self._mask_cache:
            mask = np.zeros((1, H, W, 1), np.float32)
            mask[:, h0 : max(h0, hn - s), w0 : max(w0, wn - s), :] = 1.0
            self._mask_cache[key] = mask
        return self._mask_cache[key]

    def _mask(self, output, name, mask):
        if mask is None:
            # (H, W) are the last spatial dims for any rank (reference crops
            # output[..., h0:hn, w0:wn], metrics.py:138)
            mask = torch.from_numpy(self.mask_for(name, tuple(output.shape[-3:-1])))
        return mask.to(output.device)


@METRICS.register()
class CardiacPSNR(_CardiacMixin, PSNR):
    """Reference ``src/model/metrics.py:116-139``."""

    _valid_shrink = 0

    def __init__(self, coordinates_path: str, **kwargs):
        PSNR.__init__(self, **kwargs)
        _CardiacMixin.__init__(self, coordinates_path)

    def __call__(self, output, target, name=None, mask=None):
        return PSNR.__call__(self, output, target, mask=self._mask(output, name, mask))


@METRICS.register()
class CardiacSSIM(_CardiacMixin, SSIM):
    """Reference ``src/model/metrics.py:142-165``."""

    _valid_shrink = 10  # 11-tap valid conv shrinks each spatial dim by 10

    def __init__(self, coordinates_path: str, **kwargs):
        SSIM.__init__(self, **kwargs)
        _CardiacMixin.__init__(self, coordinates_path)

    def __call__(self, output, target, name=None, mask=None):
        return SSIM.__call__(self, output, target, mask=self._mask(output, name, mask))
