"""PixelShuffle with torch ``nn.PixelShuffle`` channel order.

Output channel ``c`` at subpixel ``(i, j)`` reads input channel
``c*r² + i*r + j``, the order the reference's upsamplers use and the JAX
package's ``ops/pixel_shuffle.py`` reproduces channel-last.  The port's
per-frame blocks run NCHW, where this is ``F.pixel_shuffle``; the
channel-last form keeps the JAX package's layout for callers that use it.
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

