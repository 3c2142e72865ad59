"""The cardiac phase code of a new patient's LR sequence, in plain numpy.

The algorithm of the original preprocessing (``cardiac_cropping.py`` and
``gen_positional_encoding.py``), as a serving daemon applies it to LR
frames:

1. the heart's motion box: frames 0 and T/2 blurred by the 5×5 Gaussian
   ([1, 4, 6, 4, 1] / 16 each way, reflect-101 border), their absolute
   difference truncated to uint8, Otsu's threshold, a 5×5 closing then
   opening, the 5%–95% slice of the active pixels' coordinates in
   row-major order, and a box of 5 standard deviations around their mean;
   a box under 2 pixels, or one that cannot be formed, is the whole frame;
2. each frame inside the box as uint8, blurred (rounded half up) and
   thresholded by Otsu; end-systole is the frame in [0.25T, 0.6T) whose
   mask differs most from frame 0's (the original subtracts the uint8
   masks, so a pixel set only in the later frame counts 255);
3. the code: cos(0 → π) over systole, cos(π → 2π) over diastole.

On integer-valued frames every blur here is exact, which is what the
seeded inputs hold.
"""
from __future__ import annotations

import numpy as np


def _reflect101(n: int, r: int = 2) -> np.ndarray:
    idx = np.arange(-r, n + r)
    idx = np.abs(idx)
    return np.where(idx >= n, 2 * (n - 1) - idx, idx)


def blur_exact(img: np.ndarray) -> np.ndarray:
    """The 5×5 binomial blur in float64 (exact on integer images)."""
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16
    x = np.asarray(img, np.float64)
    H, W = x.shape
    p = x[:, _reflect101(W)]
    x = sum(k[j] * p[:, j:j + W] for j in range(5))
    p = x[_reflect101(H), :]
    return sum(k[j] * p[j:j + H, :] for j in range(5))


def otsu(img: np.ndarray) -> int:
    """Otsu's threshold of a uint8 image: the first level that maximises
    the between-class variance, levels with an empty class skipped."""
    hist = np.bincount(img.ravel(), minlength=256).astype(np.float64)
    scale = 1.0 / img.size
    p = hist * scale
    mu = float(np.dot(np.arange(256), hist)) * scale
    eps = float(np.finfo(np.float32).eps)
    q1 = mu1 = best = 0.0
    level = 0
    for i in range(256):
        mu1 *= q1
        q1 += p[i]
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p[i]) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) ** 2
        if sigma > best:
            best, level = sigma, i
    return level


def _window(img: np.ndarray, reduce, pad) -> np.ndarray:
    p = np.pad(img, 2, constant_values=pad)
    H, W = img.shape
    out = p[:H, :W]
    for dy in range(5):
        for dx in range(5):
            out = reduce(out, p[dy:dy + H, dx:dx + W])
    return out


def _close_open(mask: np.ndarray) -> np.ndarray:
    dil = lambda m: _window(m, np.maximum, 0)  # noqa: E731
    ero = lambda m: _window(m, np.minimum, 255)  # noqa: E731
    return dil(ero(ero(dil(mask))))


def motion_box(seq: np.ndarray) -> tuple[int, int, int, int]:
    """(H, W, T) frames → (h0, hn, w0, wn)."""
    H, W, T = seq.shape
    diff = np.abs(blur_exact(seq[..., 0]) - blur_exact(seq[..., T // 2])).astype(np.uint8)
    mask = (diff > otsu(diff)).astype(np.uint8)
    rows, cols = np.where(_close_open(mask))
    rows = rows[int(len(rows) * 0.05): int(len(rows) * 0.95)]
    cols = cols[int(len(cols) * 0.05): int(len(cols) * 0.95)]
    height, width = int(np.std(rows).round() * 5), int(np.std(cols).round() * 5)
    hc, wc = int(np.mean(rows).round()), int(np.mean(cols).round())
    h0, hn = max(0, hc - height // 2), min(hc + (height - height // 2), H)
    w0, wn = max(0, wc - width // 2), min(wc + (width - width // 2), W)
    return h0, hn, w0, wn


def _frame_mask(frame: np.ndarray) -> np.ndarray:
    blurred = np.floor(blur_exact(frame.astype(np.uint8)) + 0.5).astype(np.uint8)
    return (blurred > otsu(blurred)).astype(np.uint8)


def cosine_code(T: int, end_systole: int) -> np.ndarray:
    y1 = np.cos(np.linspace(0, np.pi, end_systole, endpoint=False))
    y2 = np.cos(np.linspace(np.pi, 2 * np.pi, T - end_systole, endpoint=False))
    return np.concatenate((y1, y2)).astype(np.float32)


def phase_code(seq: np.ndarray) -> np.ndarray:
    """(H, W, T) LR frames of one slice → the (T,) float32 phase code; the
    neutral code (one cosine period) where no end-systole can be found."""
    H, W, T = seq.shape
    try:
        box = motion_box(seq)
        if box[1] - box[0] < 2 or box[3] - box[2] < 2:
            box = (0, H, 0, W)
    except ValueError:
        box = (0, H, 0, W)
    h0, hn, w0, wn = box
    try:
        first = _frame_mask(seq[h0:hn, w0:wn, 0])
        lo = int(np.floor(T * 0.25))
        diffs = [int(np.sum(np.abs(first - _frame_mask(seq[h0:hn, w0:wn, i]))))
                 for i in range(lo, int(np.ceil(T * 0.6)))]
        code = cosine_code(T, int(np.argmax(diffs)) + lo)
        if code.shape != (T,) or not np.all(np.isfinite(code)):
            raise ValueError("degenerate code")
        return code
    except ValueError:
        return np.cos(np.linspace(0, 2 * np.pi, T, endpoint=False)).astype(np.float32)
