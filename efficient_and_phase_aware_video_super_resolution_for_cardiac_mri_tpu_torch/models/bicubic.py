"""Bicubic upsampling baseline (no learned parameters).

Reference ``src/model/nets/bicubic.py:8-18``:
``nn.Upsample(scale_factor, mode='bicubic', align_corners=True)``, computed
with the JAX package's dense Keys matrices (``ops/resize.py``).  The
predictor loads no checkpoint for it (``main.test_from_config``).  Under a
spatial axis each rank computes its band of output rows from the global
matrix, with a halo of up to 2 LR rows, or from the gathered frame when
a rank holds fewer rows than that.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import upsample_bicubic


class Bicubic(nn.Module):
    spatial_axis = None

    def __init__(self, upscale_factor: int = 4, generator: torch.Generator | None = None):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, lr: torch.Tensor) -> torch.Tensor:
        # (B, H, W, C) or (B, T, H, W, C): the resize acts on the last 3 dims
        return upsample_bicubic(lr, self.upscale_factor, align_corners=True,
                                axis=self.spatial_axis)
