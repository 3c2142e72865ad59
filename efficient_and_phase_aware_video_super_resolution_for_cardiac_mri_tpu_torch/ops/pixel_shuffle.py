"""PixelShuffle and space-to-depth with torch ``nn.PixelShuffle`` channel order.

Output channel ``c`` at subpixel ``(i, j)`` reads input channel
``c*r² + i*r + j``, the order the reference's upsamplers use and the JAX
package's ``ops/pixel_shuffle.py`` reproduces channel-last; space-to-depth
is its inverse, FRVSR's packing of the warped SR frame, channels grouped
(c, i, j).  The port's per-frame blocks run NCHW, where these are
``F.pixel_shuffle`` and ``F.pixel_unshuffle``; the channel-last forms keep
the JAX package's layout for callers that use it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(..., H, W, C·r²) → (..., H·r, W·r, C), channel-last."""
    *lead, H, W, C = x.shape
    if C % (r * r) != 0:
        raise ValueError(f"Channels {C} not divisible by r²={r*r}.")
    y = F.pixel_shuffle(x.reshape(-1, H, W, C).permute(0, 3, 1, 2), r)
    return y.permute(0, 2, 3, 1).reshape(*lead, H * r, W * r, C // (r * r))



def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """(..., H·r, W·r, C) → (..., H, W, C·r²), channel-last, the inverse of
    :func:`pixel_shuffle`: output channel ``c*r² + i*r + j`` is input
    channel ``c`` at subpixel ``(i, j)``."""
    *lead, H, W, C = x.shape
    if H % r or W % r:
        raise ValueError(f"Spatial dims ({H},{W}) not divisible by r={r}.")
    y = F.pixel_unshuffle(x.reshape(-1, H, W, C).permute(0, 3, 1, 2), r)
    return y.permute(0, 2, 3, 1).reshape(*lead, H // r, W // r, C * r * r)
