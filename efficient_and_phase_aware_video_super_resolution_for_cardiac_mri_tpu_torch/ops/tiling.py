"""Fixed-shape tiled spatial inference (the predictors' ``tile`` knob).

The port's copy of the JAX package's ``ops/tiling.py``.  The network
forward runs on fixed-size overlapping windows of the frame and the owned
core of each window is stitched back: HR memory is bounded by the tile, and
any (H, W) serves through one window shape.

Exactness contract: every net of the zoo is fully convolutional in space, so
an output pixel depends only on input pixels within the net's receptive
field.  Windows are clamped inside the image (never padded, except for
images smaller than the tile), and a window owns only output pixels at
least ``overlap`` input pixels from its edges, unless that edge is the
image's.  Hence overlap >= the receptive-field radius gives tiled ==
untiled.  RefineNet's radius grows with the recurrence (3 conv layers a
step over 42 steps), so its tiling is approximate at practical overlaps: the
deviation sits at the seams, and ``seam_stats`` measures it on a run.

Plan (``plan_1d``): n = ceil((size - 2·overlap) / core) windows (core =
tile - 2·overlap), starts evenly spaced over [0, size - tile]; consecutive
starts differ by at most ``core``, so each ownership boundary lies where
both neighbours hold a full halo.  The plan raises if that ever fails.

The JAX package fetches window outputs to the host and stitches there (a
measure against remote-chip transfers); here the windows, the stitch and
the seam comparison stay on the inputs' device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["plan_1d", "tiled_apply"]


def plan_1d(size: int, tile: int, overlap: int) -> list[tuple[int, int, int]]:
    """Window plan for one axis: ``(start, abs_lo, abs_hi)`` per window, where
    ``[abs_lo, abs_hi)`` are the positions (input pixels) the window
    ``[start, start + tile)`` owns.  The spans partition ``[0, size)``.
    Requires ``size >= tile`` and ``tile > 2 * overlap``."""
    size, tile, overlap = int(size), int(tile), int(overlap)
    core = tile - 2 * overlap
    if core <= 0:
        raise ValueError(f"tile ({tile}) must exceed 2*overlap ({2 * overlap})")
    if overlap < 0:
        raise ValueError(f"overlap must be >= 0, got {overlap}")
    if size < tile:
        raise ValueError(f"size ({size}) smaller than tile ({tile})")
    if size == tile:
        return [(0, 0, size)]
    n = max(2, math.ceil((size - 2 * overlap) / core))
    starts = np.round(np.linspace(0, size - tile, n)).astype(int)
    starts = sorted(set(int(s) for s in starts))  # drop rounding duplicates
    bounds = []
    lo = 0
    for i, start in enumerate(starts):
        if i + 1 < len(starts):
            hi = starts[i + 1] + overlap
            # the invariant the exactness argument rests on, checked always
            if (lo < start + overlap and start != 0) or hi > start + tile - overlap:
                raise RuntimeError(
                    f"plan_1d internal error: window {i} at {start} owns "
                    f"[{lo}, {hi}) without a full {overlap}-px halo "
                    f"(size={size}, tile={tile})"
                )
        else:
            hi = size
        bounds.append((start, lo, hi))
        lo = hi
    return bounds


def _pad_to_tile(arr: torch.Tensor, tile_hw) -> torch.Tensor:
    """Edge-extend (bottom/right) an image smaller than the tile, the one
    case windows cannot clamp into; the caller crops the output back."""
    for axis, size in ((arr.dim() - 3, tile_hw[0]), (arr.dim() - 2, tile_hw[1])):
        n = arr.shape[axis]
        if n < size:
            idx = torch.arange(size, device=arr.device).clamp_(max=n - 1)
            arr = arr.index_select(axis, idx)
    return arr


def seam_probe_plan(plan_h, plan_w, tile_hw, overlap: int, h: int, w: int) -> list[tuple[int, int]]:
    """Window starts of the seam probes: one window centred on each of the
    (up to two) middle-most ownership boundaries per axis, clamped inside
    the image, at the middle window of the other axis."""
    th, tw = tile_hw
    h_starts = [p[0] for p in plan_h]
    w_starts = [p[0] for p in plan_w]

    def _mid(items, cap=2):
        order = sorted(range(len(items)), key=lambda i: abs(i - (len(items) - 1) / 2))
        return [items[i] for i in sorted(order[:cap])]

    hs_mid = h_starts[len(h_starts) // 2]
    ws_mid = w_starts[len(w_starts) // 2]
    probes = []
    for b in _mid([s + overlap for s in h_starts[1:]]):
        probes.append((int(np.clip(b - th // 2, 0, h - th)), ws_mid))
    for b in _mid([s + overlap for s in w_starts[1:]]):
        probes.append((hs_mid, int(np.clip(b - tw // 2, 0, w - tw))))
    return sorted(set(probes))


def tiled_apply(tile_fn, inputs, tile_hw, overlap: int, seam_stats: bool = False,
                probe_fn=None):
    """Run ``tile_fn`` (the network forward returning one HR tensor) over
    fixed-shape windows of ``inputs`` and stitch the owned cores.

    - ``inputs``: the model's positional tensors.  Those with ndim >= 4
      (channels-last images or videos) are windowed on axes (-3, -2) and
      must share one (H, W); the others pass through whole.
    - ``tile_hw``: (th, tw), the window in input pixels.
    - ``overlap``: the halo in input pixels.
    - ``seam_stats``: also run up to two probe windows per axis centred on
      ownership boundaries and compare their valid cores with the stitched
      output; returns ``(out, {"n_probes", "rms", "max_abs"})`` in output
      units, with ``None`` for the stats when the plan has one window.
    - ``probe_fn``: the forward of the probe windows (default ``tile_fn``),
      so a caller can keep their side effects (telemetry) apart.
    """
    th, tw = int(tile_hw[0]), int(tile_hw[1])
    arrays = list(inputs)
    spatial = [i for i, a in enumerate(arrays) if a.dim() >= 4]
    if not spatial:
        raise ValueError("tiled_apply: no image-like (ndim>=4) input to tile")
    h, w = arrays[spatial[0]].shape[-3:-1]
    for i in spatial[1:]:
        if tuple(arrays[i].shape[-3:-1]) != (h, w):
            raise ValueError(
                "tiled_apply: all image-like inputs must share one (H, W); "
                f"got {tuple(arrays[i].shape[-3:-1])} vs {(h, w)}"
            )
    true_hw = (h, w)
    if h < th or w < tw:
        arrays = [_pad_to_tile(a, (th, tw)) if i in spatial else a for i, a in enumerate(arrays)]
        h, w = arrays[spatial[0]].shape[-3:-1]

    plan_h = plan_1d(h, th, overlap)
    plan_w = plan_1d(w, tw, overlap)
    plan = [(ph, pw) for ph in plan_h for pw in plan_w]

    def _window_args(hs: int, ws: int):
        return [a[..., hs:hs + th, ws:ws + tw, :] if i in spatial else a
                for i, a in enumerate(arrays)]

    outs = [tile_fn(*_window_args(hs, ws)) for (hs, _, _), (ws, _, _) in plan]
    probe_plan = (seam_probe_plan(plan_h, plan_w, (th, tw), overlap, h, w)
                  if seam_stats else [])
    probe_outs = [(probe_fn or tile_fn)(*_window_args(phs, pws)) for phs, pws in probe_plan]

    first = outs[0]
    oth, otw = first.shape[-3], first.shape[-2]
    if oth % th or otw % tw:
        raise ValueError(
            f"tiled_apply: window output spatial {oth}x{otw} is not an "
            f"integer multiple of the tile {th}x{tw}"
        )
    rh, rw = oth // th, otw // tw
    out = first.new_empty(first.shape[:-3] + (h * rh, w * rw, first.shape[-1]))
    for ((hs, h_lo, h_hi), (ws, w_lo, w_hi)), win in zip(plan, outs):
        oy, ox = (h_lo - hs) * rh, (w_lo - ws) * rw
        out[..., h_lo * rh:h_hi * rh, w_lo * rw:w_hi * rw, :] = win[
            ..., oy:oy + (h_hi - h_lo) * rh, ox:ox + (w_hi - w_lo) * rw, :
        ]
    seam = None
    if probe_plan:
        # each probe's valid core against the stitched output at the same
        # positions, in fp32; one fetch for all probes
        sums, maxes, n = [], [], 0
        for (phs, pws), po in zip(probe_plan, probe_outs):
            rows = slice((phs + overlap) * rh, (phs + th - overlap) * rh)
            cols = slice((pws + overlap) * rw, (pws + tw - overlap) * rw)
            core = po[..., overlap * rh:(th - overlap) * rh, overlap * rw:(tw - overlap) * rw, :]
            d = core.float() - out[..., rows, cols, :].float()
            sums.append(torch.sum(d * d))
            maxes.append(d.abs().max())
            n += d.numel()
        sq, mx = torch.stack([torch.stack(sums).sum(), torch.stack(maxes).max()]).tolist()
        seam = {"n_probes": len(probe_plan), "rms": math.sqrt(sq / max(n, 1)), "max_abs": mx}
    if true_hw != (h, w):
        out = out[..., : true_hw[0] * rh, : true_hw[1] * rw, :]
    if seam_stats:
        return out, seam
    return out
