"""Bicubic and bilinear resize with the JAX package's dense matrices.

The port's copy of the JAX package's ``ops/resize.py``.  Two kernels of the
reference are reproduced exactly:

* ``nn.Upsample(mode='bicubic', align_corners=True)``, the Bicubic baseline;
* ``F.interpolate(mode='bilinear', align_corners=False)``, SRFB's global
  skip;

and, on the host in numpy (:func:`resize_bicubic_np`), OpenCV's
``cv2.resize(..., INTER_CUBIC)`` of the reference's k-space degradation
(half-pixel mapping).

Both use a convolution kernel over source taps (Keys cubic with A = -0.75,
or the triangle), and differ in the source-coordinate mapping:

    align_corners=True:  src = dst * (in-1)/(out-1)
    half-pixel:          src = (dst + 0.5) * in/out - 0.5

Each 1-D resize is a dense (out, in) matrix built on the host with numpy, in
which out-of-range taps are clamped to the border and their weights
accumulated into the edge column; the 2-D resize is two matrix products.
Those matrices are the oracle: ``F.interpolate`` rounds and treats the
border on its own terms, and its last rows differ.

Under a spatial axis (``parallel/halo.py``) each rank holds a band of a
frame's rows and computes the band of output rows they scale to: the
rows of the **global** height matrix for that band, against the rank's
rows with the halo those rows reach attached (:func:`band_plan`).  The
zero halo rows past the frame's border meet zero columns, since a clamped
tap's weight sits in the edge column.  Where the halo would exceed a band
(a few rows a rank under bicubic, a pyramid's coarsest level), the frame
is gathered whole instead (``parallel/halo.gather_frame``, whose backward
returns each rank its rows' gradient).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..parallel.halo import SpatialAxis, gather_frame, halo


def _cubic_kernel(x: np.ndarray, A: float = -0.75) -> np.ndarray:
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    return np.where(
        x <= 1,
        (A + 2) * x3 - (A + 3) * x2 + 1,
        np.where(x < 2, A * x3 - 5 * A * x2 + 8 * A * x - 4 * A, 0.0),
    )


@functools.lru_cache(maxsize=256)
def resize_matrix(
    in_size: int, out_size: int, align_corners: bool = False, kind: str = "cubic"
) -> np.ndarray:
    """Dense (out_size, in_size) interpolation matrix (float32).

    ``kind``: 'cubic' (Keys A=-0.75, 4 taps) or 'linear' (triangle, 2 taps).
    Out-of-range taps are clamped to the border by accumulating the weights
    of the clamped indices.  Cached: callers must not write to the result.
    """
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = dst * scale
    else:
        src = (dst + 0.5) * (in_size / out_size) - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    if kind == "cubic":
        taps, kernel = range(-1, 3), _cubic_kernel
    elif kind == "linear":
        taps, kernel = range(0, 2), lambda x: np.maximum(0.0, 1.0 - np.abs(x))
    else:
        raise ValueError(f"Unknown resize kind {kind!r}.")
    for tap in taps:
        idx = np.clip(base + tap, 0, in_size - 1)
        w = kernel(tap - frac)
        np.add.at(mat, (np.arange(out_size), idx), w)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_matrix(in_size: int, out_size: int, align_corners: bool, kind: str,
                   device: torch.device) -> torch.Tensor:
    """:func:`resize_matrix` on ``device``, uploaded once per shape.  Made
    outside inference mode even when first asked for inside it (a serving
    run, a valid epoch), so that a later training step may save it for its
    backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(resize_matrix(in_size, out_size, align_corners, kind)).to(device)


@functools.lru_cache(maxsize=64)
def band_plan(in_size: int, out_size: int, align_corners: bool, kind: str,
              parts: int) -> tuple[int | None, tuple[np.ndarray, ...]]:
    """The height resize of a frame of ``in_size`` rows held in ``parts``
    equal bands → (halo, one matrix a band).  ``halo`` is the most rows any
    band's output rows reach past its own input rows, from the nonzero
    columns of the global matrix's rows for that band; each band's matrix
    is those rows over its ``in/parts + 2·halo`` halo'd input rows (zero
    columns past the border).  When the halo exceeds a band, ``halo`` is
    None and each band's matrix spans the whole gathered frame.  Cached:
    callers must not write to the result."""
    mat = resize_matrix(in_size, out_size, align_corners, kind)
    n_in, n_out = in_size // parts, out_size // parts
    need = 0
    for i in range(parts):
        cols = np.flatnonzero(np.any(mat[i * n_out:(i + 1) * n_out] != 0, axis=0))
        need = max(need, i * n_in - cols[0], cols[-1] + 1 - (i + 1) * n_in)
    if need > n_in:
        return None, tuple(mat[i * n_out:(i + 1) * n_out] for i in range(parts))
    padded = np.zeros((out_size, in_size + 2 * need), np.float32)
    padded[:, need:need + in_size] = mat
    return need, tuple(padded[i * n_out:(i + 1) * n_out, i * n_in:(i + 1) * n_in + 2 * need]
                       for i in range(parts))


@functools.lru_cache(maxsize=64)
def _device_band(in_size: int, out_size: int, align_corners: bool, kind: str, parts: int,
                 index: int, device: torch.device) -> tuple[int | None, torch.Tensor]:
    """Band ``index`` of :func:`band_plan` on ``device``, uploaded once per
    shape (outside inference mode, as :func:`_device_matrix`)."""
    k, mats = band_plan(in_size, out_size, align_corners, kind, parts)
    with torch.inference_mode(False):
        return k, torch.from_numpy(mats[index]).to(device)


def _band_rows(x: torch.Tensor, out_h: int, align_corners: bool, kind: str,
               axis: SpatialAxis) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's band of (..., H_local, W, C) → (the rows its output band
    reads, the height matrix of that band)."""
    parts = axis.size
    k, mh = _device_band(x.shape[-3] * parts, out_h * parts, align_corners, kind, parts,
                         axis.index, x.device)
    # the exchanges run over (…, H, W): channels to the front and back
    x = x.movedim(-1, -3)
    if k is None:
        return gather_frame(x, axis).movedim(-3, -1), mh
    return halo(x, k, axis).movedim(-3, -1), mh


def _resize(x: torch.Tensor, out_hw, align_corners: bool, kind: str,
            axis: SpatialAxis | None = None) -> torch.Tensor:
    """``axis``: ``x`` holds this rank's band of rows, ``out_hw[0]`` is its
    output band's height."""
    H, W = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    # a float32 matrix against bf16 input computes in float32, as JAX
    # promotes the einsum of its float32 matrix with a bf16 array
    dtype = torch.promote_types(x.dtype, torch.float32)
    if axis is None:
        mh = _device_matrix(H, oh, align_corners, kind, x.device)
    else:
        x, mh = _band_rows(x, oh, align_corners, kind, axis)
    mh = mh.to(dtype)
    mw = _device_matrix(W, ow, align_corners, kind, x.device).to(dtype)
    x = torch.einsum("oh,...hwc->...owc", mh, x.to(dtype))
    return torch.einsum("pw,...hwc->...hpc", mw, x)


def resize_bicubic(x: torch.Tensor, out_hw: tuple[int, int],
                   align_corners: bool = False) -> torch.Tensor:
    """Bicubic-resize the (H, W) axes of a (..., H, W, C) tensor."""
    return _resize(x, out_hw, align_corners, "cubic")


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """torch ``F.interpolate(mode='bilinear')`` over (..., H, W, C)."""
    return _resize(x, out_hw, align_corners, "linear")


def upsample_bicubic(x: torch.Tensor, scale_factor: int, align_corners: bool = True,
                     axis: SpatialAxis | None = None) -> torch.Tensor:
    """torch ``nn.Upsample(mode='bicubic')`` over (..., H, W, C); under
    ``axis``, this rank's band of the whole frame's."""
    H, W = x.shape[-3], x.shape[-2]
    return _resize(x, (H * scale_factor, W * scale_factor), align_corners, "cubic", axis)


def upsample_bilinear(x: torch.Tensor, scale_factor: int, align_corners: bool = False,
                      axis: SpatialAxis | None = None) -> torch.Tensor:
    """torch ``F.interpolate(mode='bilinear')`` with an integer scale
    factor; under ``axis``, this rank's band of the whole frame's."""
    H, W = x.shape[-3], x.shape[-2]
    return _resize(x, (H * scale_factor, W * scale_factor), align_corners, "linear", axis)


def resize_bicubic_np(x: np.ndarray, out_hw: tuple[int, int],
                      align_corners: bool = False) -> np.ndarray:
    """Bicubic-resize the two leading axes of a numpy array with the same
    matrices, on the host (the offline preprocessing: ``ops/kspace.py``)."""
    H, W = x.shape[0], x.shape[1]
    mh = resize_matrix(H, out_hw[0], align_corners)
    mw = resize_matrix(W, out_hw[1], align_corners)
    y = np.tensordot(mh, x, axes=(1, 0))  # (oh, W, ...)
    return np.moveaxis(np.tensordot(mw, y, axes=(1, 1)), 0, 1)  # (oh, ow, ...)
