"""The OpenCV operations of the preprocessing tools, in numpy.

The JAX package's ``tools/cardiac_cropping.py`` and
``tools/gen_positional_encoding.py`` call ``cv2.GaussianBlur(img, (5, 5), 0)``,
``cv2.threshold(..., THRESH_BINARY + THRESH_OTSU)`` and
``cv2.morphologyEx`` with a 5×5 rectangle.  The machine with the card has no
OpenCV, so these are their numpy twins, bit for bit (the CPU tests hold them
to ``cv2`` element for element):

* :func:`gaussian_blur_5x5`: ksize 5 with sigma 0 is OpenCV's fixed kernel
  [1, 4, 6, 4, 1] / 16, separable, rows then columns, border
  ``BORDER_REFLECT_101``.
  - uint8 takes OpenCV's bit-exact fixed-point path: the row sums keep 8
    fractional bits, the column sums 16, and the last shift rounds half up.
  - float32 rounds as OpenCV's vectorised filters do.  Only the centre
    weight 3/8 rounds a product (1/4 and 1/16 are powers of two).  The row
    pass fuses it: ``fma(x, 3/8, (l1 + r1)/4)``, then ``+ (l2 + r2)/16``,
    except the last column of an odd width, which OpenCV computes unfused.
    The column pass rounds ``x·3/8`` first.  A single row runs only the
    row pass and a single column only the column pass, as in OpenCV.  On
    integer images every order gives the same exact sums.
* :func:`otsu_threshold`: ``getThreshVal_Otsu_8u`` on the 256-bin
  histogram, in double precision, in OpenCV's order of operations; the first
  maximum wins; :func:`threshold_otsu` is ``THRESH_BINARY`` (``src > t``).
* :func:`morph_close` / :func:`morph_open`: dilate then erode / erode then
  dilate over a 5×5 rectangle; the border is padded with the neutral value
  (``morphologyDefaultBorderValue``), so it never constrains.
"""
from __future__ import annotations

import numpy as np

_F32, _F64 = np.float32, np.float64
_K0, _K1, _K2 = _F32(3 / 8), _F32(1 / 4), _F32(1 / 16)
# [1, 4, 6, 4, 1] / 16 with 8 fractional bits
_KQ = np.array([16, 64, 96, 64, 16], np.int64)
_FLT_EPSILON = float(np.finfo(np.float32).eps)


def reflect101_index(n: int, r: int = 2) -> np.ndarray:
    """Indices of ``n`` samples padded by ``r`` each side, ``BORDER_REFLECT_101``
    (``gfedcb|abcdefgh|gfedcba``), repeated as OpenCV's ``borderInterpolate``."""
    if n == 1:
        return np.zeros(n + 2 * r, np.int64)
    idx = np.arange(-r, n + r)
    while ((idx < 0) | (idx >= n)).any():
        idx = np.abs(idx)
        idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)
    return idx


def fma32(a: np.ndarray, b, c: np.ndarray) -> np.ndarray:
    """float32 ``a·b + c`` rounded once (a fused multiply-add).  The product
    of two float32 is exact in float64; the float64 sum's rounding error
    (TwoSum) decides the float32 rounding where the float64 sum falls on a
    float32 tie, where rounding twice would go wrong."""
    p = a.astype(_F64) * _F64(b)
    c64 = c.astype(_F64)
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    r = s.astype(_F32).astype(_F64)
    other = 2 * s - r  # the other float32 neighbour when s is a tie
    with np.errstate(over="ignore", invalid="ignore"):
        tie = (err != 0) & (s != r) & (other.astype(_F32).astype(_F64) == other)
    out = np.where(tie, np.where(err > 0, np.maximum(r, other), np.minimum(r, other)), r)
    return out.astype(_F32)


def _taps(padded: np.ndarray, n: int):
    """Centre, -1, +1, -2, +2 neighbours along the last axis of an array
    padded by 2."""
    return [padded[..., 2 + o: 2 + o + n] for o in (0, -1, 1, -2, 2)]


def _blur_f32(img: np.ndarray) -> np.ndarray:
    H, W = img.shape
    out = img
    if W > 1:
        c, l1, r1, l2, r2 = _taps(out[:, reflect101_index(W)], W)
        near = (l1 + r1) * _K1
        row = fma32(c, _K0, near)
        if W % 2:
            row[:, -1] = c[:, -1] * _K0 + near[:, -1]
        out = row + (l2 + r2) * _K2
    if H > 1:
        c, u1, d1, u2, d2 = _taps(out.T[:, reflect101_index(H)], H)
        out = ((c * _K0 + (u1 + d1) * _K1) + (u2 + d2) * _K2).T
    return np.ascontiguousarray(out)


def _blur_u8(img: np.ndarray) -> np.ndarray:
    H, W = img.shape
    x = img.astype(np.int64)
    p = x[:, reflect101_index(W)]
    row = sum(_KQ[j] * p[:, j: j + W] for j in range(5))  # 8 fractional bits
    q = row[reflect101_index(H), :]
    col = sum(_KQ[j] * q[j: j + H, :] for j in range(5))  # 16 fractional bits
    return ((col + (1 << 15)) >> 16).astype(np.uint8)


def gaussian_blur_5x5(img: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(img, (5, 5), 0)`` of a 2D uint8 or float32 image."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError(f"expected a 2D image, got shape {img.shape}")
    if img.dtype == np.uint8:
        return _blur_u8(img)
    if img.dtype == np.float32:
        return _blur_f32(img)
    raise TypeError(f"gaussian_blur_5x5 takes uint8 or float32, got {img.dtype}")


def otsu_threshold(img: np.ndarray) -> int:
    """Otsu's threshold of a uint8 image (OpenCV's ``getThreshVal_Otsu_8u``)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"Otsu's threshold takes uint8, got {img.dtype}")
    hist = np.bincount(img.ravel(), minlength=256)
    scale = 1.0 / img.size
    mu = 0.0
    for i in range(256):
        mu += i * float(hist[i])
    mu *= scale
    mu1 = q1 = max_sigma = 0.0
    max_val = 0
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < _FLT_EPSILON or max(q1, q2) > 1.0 - _FLT_EPSILON:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma = sigma
            max_val = i
    return max_val


def threshold_otsu(img: np.ndarray, maxval: int = 1) -> tuple[int, np.ndarray]:
    """``cv2.threshold(img, 0, maxval, THRESH_BINARY + THRESH_OTSU)`` →
    (threshold, uint8 mask)."""
    t = otsu_threshold(img)
    return t, np.where(img > t, maxval, 0).astype(np.uint8)


def _window_reduce(img: np.ndarray, size: int, pad_value, reduce) -> np.ndarray:
    r = size // 2
    p = np.pad(img, r, constant_values=pad_value)
    H, W = img.shape
    out = p[:H, :W].copy()
    for dy in range(size):
        for dx in range(size):
            out = reduce(out, p[dy: dy + H, dx: dx + W])
    return out


def erode(img: np.ndarray, size: int = 5) -> np.ndarray:
    """``cv2.erode`` with a ``size``×``size`` rectangle, default border."""
    return _window_reduce(img, size, np.iinfo(img.dtype).max, np.minimum)


def dilate(img: np.ndarray, size: int = 5) -> np.ndarray:
    """``cv2.dilate`` with a ``size``×``size`` rectangle, default border."""
    return _window_reduce(img, size, np.iinfo(img.dtype).min, np.maximum)


def morph_close(img: np.ndarray, size: int = 5) -> np.ndarray:
    return erode(dilate(img, size), size)


def morph_open(img: np.ndarray, size: int = 5) -> np.ndarray:
    return dilate(erode(img, size), size)
