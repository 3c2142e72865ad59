"""Flow warping with torch ``grid_sample`` semantics (NCHW).

The port's copy of the JAX package's ``ops/warp.py`` for TOFlow:

* ``grid_sample``: ``F.grid_sample`` in bilinear mode with zeros or border
  padding, its coordinates and blend in fp32 whatever the input's dtype
  (bf16 cannot hold pixel positions above 256), the result in the input's
  dtype, as the JAX package's gather computes it.
* ``flow_warp``: the reference's warp (``toflow_net.py:116-138``), pixel
  grid + flow normalised by (size−1) (the align_corners=True convention),
  then sampled with torch's default ``align_corners=False``: the
  mismatched chain, reproduced literally.
* ``windowed_sample``: the JAX package's gather-free bilinear sample, a sum
  over a static displacement window of shifted maps times closed-form corner
  weights, equal to the gather wherever |offset| <= R on both axes; an
  out-of-window tap contributes exactly zero ('zeros') or the displacement
  is clamped to the window ('border').  ``flow_warp(max_flow=R)`` takes it
  with the window widened for the chain's rescale and shift.

* ``stn_warp``: FRVSR's STN warp (reference ``frvsr_net.py:209-226``), a
  normalised flow added to a ``linspace(-1, 1)`` mesh and sampled with
  ``align_corners=False``; ``max_flow=R`` takes the windowed path with the
  window widened by one for the mesh's sub-pixel offset.

Images are (B, C, H, W); a grid or a flow is (B, H, W, 2) with x first, as
``F.grid_sample`` takes its grid.

Under a spatial ``axis`` (``parallel/halo.py``) each rank holds a band of
rows of the image and of the flow: the flows are normalised by the
frame's height and measured from the frame's row index.  The windowed
path takes its window's rows from the neighbours
(``parallel/halo.halo_rows``: zeros past the frame's border, or its edge
row for ``border``); the exact path samples the frame gathered whole
(``parallel/halo.gather_frame``, whose backward returns each rank its rows'
gradient) at the band's grid.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.halo import SpatialAxis, gather_frame, halo_rows


def grid_sample(x: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros",
                align_corners: bool = False) -> torch.Tensor:
    """x: (B, C, H, W); grid: (B, Ho, Wo, 2) normalised (x, y) in [-1, 1]
    → (B, C, Ho, Wo) in ``x.dtype``, computed in fp32."""
    out = F.grid_sample(x.float(), grid.float(), mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.to(x.dtype)


def _ceil_div(num: int, den: int) -> int:
    return -(-num // den)


def _corner_weights(o: torch.Tensor, d: int) -> torch.Tensor:
    """(1−frac)·[d==floor(o)] + frac·[d==floor(o)+1]: nonzero exactly at the
    two bilinear corners; the gradient flows through frac only."""
    fl = torch.floor(o)
    frac = o - fl
    zero = torch.zeros((), dtype=o.dtype, device=o.device)
    return torch.where(fl == d, 1.0 - frac, zero) + torch.where(fl + 1 == d, frac, zero)


def _rows(H: int, axis: SpatialAxis | None) -> tuple[int, int]:
    """(the frame's height, its row of this band's first row) for a band
    of ``H`` rows."""
    if axis is None:
        return H, 0
    return H * axis.size, H * axis.index


def windowed_sample(x: torch.Tensor, off_y: torch.Tensor, off_x: torch.Tensor, max_flow: int,
                    padding_mode: str = "zeros", axis: SpatialAxis | None = None) -> torch.Tensor:
    """Gather-free bilinear sample of x (B, C, H, W) at each pixel plus the
    displacement (off_y, off_x) (B, H, W), summed over the window d ∈
    [−R, R]² of shifted maps (one pad, then slices) times the corner weights
    (fp32, cast to ``x.dtype`` before the product, in the JAX package's
    order of operations).  Under ``axis`` the window's rows above and below
    the band come from the frame (:func:`parallel.halo.halo_rows`)."""
    B, C, H, W = x.shape
    R = int(max_flow)
    oy, ox = off_y.float(), off_x.float()
    if padding_mode == "border":
        oy, ox = oy.clamp(-R, R), ox.clamp(-R, R)
    mode = "replicate" if padding_mode == "border" else "constant"
    if axis is None:
        xp = F.pad(x, (R, R, R, R), mode=mode)
    else:
        xh = halo_rows(x, R, axis, "replicate" if padding_mode == "border" else "zeros")
        xp = F.pad(xh, (R, R, 0, 0), mode=mode)
    wxs = [_corner_weights(ox, dx) for dx in range(-R, R + 1)]  # the same for every row
    acc = None
    for dy in range(-R, R + 1):
        wy = _corner_weights(oy, dy)
        row = xp[:, :, R + dy:R + dy + H]
        for dx, wx in zip(range(-R, R + 1), wxs):
            wgt = (wy * wx).to(x.dtype)[:, None]
            term = row[:, :, :, R + dx:R + dx + W] * wgt
            acc = term if acc is None else acc + term
    return acc


def flow_warp(x: torch.Tensor, flow: torch.Tensor, padding_mode: str = "zeros",
              max_flow: int | None = None, axis: SpatialAxis | None = None) -> torch.Tensor:
    """TOFlow's warp: x (B, C, H, W), flow (B, H, W, 2) in pixels, (x, y).

    ``max_flow=R`` takes the windowed path, exact while |flow| <= R px on
    both axes: the chain's effective displacement is
    flow·size/(size−1) + pos/(size−1) − 0.5, up to flow/(size−1) + 0.5 px
    beyond |flow|, so the window is widened to
    ``ceil((2·R·size + size − 1) / (2·size − 2))`` (R + 1 at these sizes).
    ``axis``: x and flow are this rank's band of rows."""
    B, C, Hl, W = x.shape
    H, r0 = _rows(Hl, axis)
    grid_x = torch.arange(W, dtype=torch.float32, device=x.device)[None, None, :]
    grid_y = torch.arange(r0, r0 + Hl, dtype=torch.float32, device=x.device)[None, :, None]
    vx = grid_x + flow[..., 0].float()
    vy = grid_y + flow[..., 1].float()
    gx = 2.0 * vx / max(W - 1, 1) - 1.0
    gy = 2.0 * vy / max(H - 1, 1) - 1.0
    if max_flow is not None:
        # unnormalise by the align_corners=False rule, as grid_sample would
        sx = ((gx + 1.0) * W - 1.0) / 2.0
        sy = ((gy + 1.0) * H - 1.0) / 2.0
        win = max(
            _ceil_div(2 * max_flow * W + W - 1, 2 * W - 2) if W > 1 else max_flow,
            _ceil_div(2 * max_flow * H + H - 1, 2 * H - 2) if H > 1 else max_flow,
        )
        return windowed_sample(x, sy - grid_y, sx - grid_x, win, padding_mode, axis)
    return grid_sample(gather_frame(x, axis), torch.stack([gx, gy], dim=-1), padding_mode,
                       align_corners=False)


@functools.lru_cache(maxsize=64)
def _mesh(size: int, device: torch.device) -> torch.Tensor:
    """``np.linspace(-1, 1, size)`` in f64 cast to f32 on ``device``, the
    reference's mesh bit for bit (``frvsr_net.py:211-212``; a device
    ``torch.linspace`` in f32 is 1 ulp off, which the recurrent warp
    amplifies over training steps).  Uploaded once per size, outside
    inference mode (see ``ops/resize._device_matrix``)."""
    with torch.inference_mode(False):
        return torch.from_numpy(np.linspace(-1.0, 1.0, size).astype(np.float32)).to(device)


def stn_warp(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, padding_mode: str = "border",
             max_flow: int | None = None, axis: SpatialAxis | None = None) -> torch.Tensor:
    """FRVSR's STN warp: x (B, C, H, W); u, v (B, H, W) normalised flow
    added to the mesh, then sampled with ``align_corners=False`` → (B, C,
    H, W) in ``x.dtype``.

    ``max_flow=R`` takes the windowed path, exact while the pixel flow
    (normalised flow · size/2) stays within R: the mesh's offset from the
    pixel centres is a position-dependent shift in (−0.5, +0.5], so the
    window is R + 1.  ``axis``: x, u and v are this rank's band of rows,
    the mesh the frame's rows of that band."""
    B, C, Hl, W = x.shape
    H, r0 = _rows(Hl, axis)
    gx = _mesh(W, x.device)[None, None, :] + u.float()
    gy = _mesh(H, x.device)[None, r0:r0 + Hl, None] + v.float()
    if max_flow is not None:
        sx = ((gx + 1.0) * W - 1.0) / 2.0
        sy = ((gy + 1.0) * H - 1.0) / 2.0
        grid_x = torch.arange(W, dtype=torch.float32, device=x.device)[None, None, :]
        grid_y = torch.arange(r0, r0 + Hl, dtype=torch.float32, device=x.device)[None, :, None]
        return windowed_sample(x, sy - grid_y, sx - grid_x, max_flow + 1, padding_mode, axis)
    return grid_sample(gather_frame(x, axis), torch.stack([gx, gy], dim=-1), padding_mode,
                       align_corners=False)
