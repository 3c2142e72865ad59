"""The numbers that decide ``correct``, each against the limit its cell's
file gives it.

Training (the first three steps of the object the window then drives):

* ``loss_gap``: the largest of the three steps' |loss − reference| /
  |reference|;
* ``grad_gap``: the first step's gradient as the optimizer got it (Adam's
  first moment after one step, / (1 − β1)), by the worst leaf: the gap
  between the program's norm and the reference's, over the reference's
  norm of that leaf or of the median leaf, whichever is larger;
* ``update_gap``: the same of each leaf's change over the three steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (below that a leaf moves under Adam by round-off alone);
  ``update_gap_median`` the median of those leaves' gaps, and
  ``loss_gap_first`` the first step's loss gap alone: the steady numbers a
  cell compares where Adam's later steps make the worst leaf or the later
  losses swing from seed to seed;
* ``batch_unmatched``: items of the three batches that are not a flip and
  crop of the seeded tree's frames at the dataset's indices.

Serving: ``gray_max``, the widest gap in gray levels between a served SR
voxel and the reference's, and ``gray_mismatch_pct``, the share of voxels
that differ at all.
"""
from __future__ import annotations

import numpy as np
import torch


def _median(values) -> float:
    return float(np.median(np.asarray(values, np.float64)))


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's |‖prog‖ − ‖ref‖| / max(‖ref‖, median leaf ‖ref‖); a leaf
    the program lacks counts as 0."""
    keys = list(keys)
    ref_n = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    floor = _median(list(ref_n.values()))
    out = {}
    for k in keys:
        p = float(torch.linalg.vector_norm(prog[k].double())) if k in prog else 0.0
        out[k] = abs(p - ref_n[k]) / max(ref_n[k], floor, 1e-30)
    return out


def norm_gap(prog: dict, ref: dict, keys) -> float:
    """The worst leaf of :func:`leaf_gaps`."""
    return max(leaf_gaps(prog, ref, keys).values())


def median_gap(prog: dict, ref: dict, keys) -> float:
    """The median leaf of :func:`leaf_gaps`."""
    return _median(list(leaf_gaps(prog, ref, keys).values()))


def moved_leaves(ref_grads: dict) -> list:
    """Leaves whose reference gradient norm is at least a thousandth of the
    median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref_grads.items()
             if g is not None}
    floor = 1e-3 * _median(list(norms.values()))
    return [k for k, n in norms.items() if n >= floor]


def gray_gaps(served: np.ndarray, ref: np.ndarray) -> tuple[float, float]:
    d = np.abs(served.astype(np.float64) - ref.astype(np.float64))
    return float(d.max()), float(100.0 * np.count_nonzero(d) / d.size)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``numbers`` against ``limits`` (every number must be at most its
    limit; a missing or non-finite number fails) → (correct, the compared
    numbers with their limits)."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and np.isfinite(value) and value <= limit
        ok = ok and bool(good)
        out[name] = {"value": value, "limit": limit}
    return ok, out


def _windows(frames: np.ndarray, size: int) -> np.ndarray:
    return np.lib.stride_tricks.sliding_window_view(frames, (size, size), axis=(-2, -1))


def find_crop(item_lr: np.ndarray, lr: np.ndarray, item_hr: np.ndarray, hr: np.ndarray,
              scale: int, tol: float = 1e-4) -> bool:
    """Whether ``item_lr`` (n, h, w) is one flip of the frames ``lr`` (n, H, W)
    cropped at some (y, x) and ``item_hr`` (m, h·s, w·s) the same flip of
    ``hr`` (m, H·s, W·s) cropped at (s·y, s·x)."""
    h = item_lr.shape[-1]
    for flip in ((), (-2,), (-1,), (-2, -1)):
        lf = np.flip(lr, flip) if flip else lr
        hf = np.flip(hr, flip) if flip else hr
        gaps = np.abs(_windows(lf[0], h) - item_lr[0]).max(axis=(-2, -1))
        for y, x in zip(*np.nonzero(gaps <= tol)):
            if (np.abs(lf[:, y:y + h, x:x + h] - item_lr).max() <= tol
                    and np.abs(hf[:, scale * y:scale * (y + h), scale * x:scale * (x + h)]
                               - item_hr).max() <= tol * 10):
                return True
    return False
