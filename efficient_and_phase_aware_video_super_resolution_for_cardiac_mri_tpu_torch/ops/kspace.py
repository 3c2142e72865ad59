"""MRI-realistic k-space degradation, the port's copy of the JAX package's
``ops/kspace.py`` (reference ``src/acdc_preprocess.py:102-180``).

LR generation: FFT, a centred rectangle of k-space kept by the downscale
factor, inverse FFT, magnitude rounded, bicubic resize down
(``ops/resize.resize_bicubic_np``), clip to [0, 255].  numpy only: the
offline preprocessing CLIs run it on the host.
"""
from __future__ import annotations

import numpy as np
from numpy.fft import fftn, fftshift, ifftn, ifftshift

from .resize import resize_bicubic_np


def img_to_kspace(img: np.ndarray) -> np.ndarray:
    """Spatial → frequency domain (reference ``:138-148``)."""
    return fftshift(fftn(ifftshift(img), norm="ortho"))


def truncate_kspace(kspace: np.ndarray, downscale_factor: int) -> np.ndarray:
    """Centred rectangular low-pass by the downscale factor (reference ``:150-167``)."""
    rect = np.zeros_like(kspace)
    kx_max, ky_max = kspace.shape[0] // 2, kspace.shape[1] // 2
    lx, ly = kspace.shape[0] // downscale_factor, kspace.shape[1] // downscale_factor
    rect[
        kx_max - lx // 2 : kx_max + (lx - lx // 2),
        ky_max - ly // 2 : ky_max + (ly - ly // 2),
    ] = 1
    return rect * kspace


def kspace_to_img(kspace: np.ndarray) -> np.ndarray:
    """Frequency → spatial domain, magnitude, rounded (reference ``:169-180``)."""
    img = fftshift(ifftn(ifftshift(kspace), norm="ortho"))
    return np.around(np.abs(img))


class Downscale:
    """The whole degradation (reference ``Downscale``, ``:102-136``): call
    with (H, W, C) images; returns the k-space-truncated, bicubic-
    downscaled, clipped LR images."""

    def __init__(self, downscale_factor: int):
        self.downscale_factor = downscale_factor

    def __call__(self, *imgs: np.ndarray) -> tuple[np.ndarray, ...]:
        if not all(isinstance(img, np.ndarray) for img in imgs):
            raise TypeError("every image entering the k-space degradation must be a numpy.ndarray")
        if not all(img.ndim == 3 for img in imgs):
            raise ValueError("k-space degradation expects 2D images as (H, W, C) arrays (got a different rank).")
        out = []
        for img in imgs:
            low = kspace_to_img(truncate_kspace(img_to_kspace(img), self.downscale_factor))
            h, w, _ = low.shape
            small = resize_bicubic_np(
                low.astype(np.float32),
                (h // self.downscale_factor, w // self.downscale_factor),
            )
            if small.ndim == 2:
                small = small[..., None]
            out.append(np.clip(np.round(small), 0, 255))
        return tuple(out)
