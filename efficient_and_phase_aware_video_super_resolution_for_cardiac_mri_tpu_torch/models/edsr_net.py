"""EDSR (reference ``src/model/nets/edsr_net.py:8-67``), PyTorch.

head conv → N residual blocks (conv-ReLU-conv, ×res_scale) → body conv →
global skip → PixelShuffle tail (``log2(r)`` stages of conv F→4F +
PixelShuffle(2), or one conv F→9F + PixelShuffle(3)) → output conv.
Channels-last at the boundary, (B, h, w, C) → (B, rh, rw, C), NCHW inside.
The module tree gives the reference's ``state_dict`` keys: ``head.0``,
``body.{i}.body.conv{1,2}``, ``body.conv``, ``tail.0.conv{n}``,
``tail.conv``.  Every conv is 3×3 and exchanges a one-row halo under a
spatial axis (``parallel/halo.py``): 2·N + 5 exchanges a forward at ×4.
"""
from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.halo import HaloConv2d
from .common import UpsampleBlock, conv2d, to_conv_layout


class _ResBlock(nn.Module):
    def __init__(self, num_features: int, res_scale: float, generator: torch.Generator):
        super().__init__()
        self.res_scale = res_scale
        self.body = nn.ModuleDict({
            "conv1": conv2d(num_features, num_features, 3, generator, cls=HaloConv2d),
            "conv2": conv2d(num_features, num_features, 3, generator, cls=HaloConv2d),
        })

    def forward(self, x):
        r = self.body["conv2"](F.relu(self.body["conv1"](x)))
        return x + r * self.res_scale


class EDSRNet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_resblocks: int,
                 num_features: int, upscale_factor: int, res_scale: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        F_ = num_features
        self.head = nn.Sequential(conv2d(in_channels, F_, 3, generator, cls=HaloConv2d))
        # residual blocks then the body conv, run in order by the Sequential
        blocks = [(str(i), _ResBlock(F_, res_scale, generator)) for i in range(num_resblocks)]
        self.body = nn.Sequential(OrderedDict(
            blocks + [("conv", conv2d(F_, F_, 3, generator, cls=HaloConv2d))]))
        self.tail = nn.ModuleDict({
            "0": UpsampleBlock(F_, F_, upscale_factor, generator, final_conv=False),
            "conv": conv2d(F_, out_channels, 3, generator, cls=HaloConv2d),
        })

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        head = self.head(to_conv_layout(x))
        body = self.body(head) + head
        y = self.tail["conv"](self.tail["0"](body))
        return y.permute(0, 2, 3, 1)
