"""DUF: dynamic upsampling filters (reference ``src/model/nets/duf_net.py``), PyTorch.

A per-frame head conv, then a 3D dense backbone (16, 28 or 52 layers, whose
last three blocks shrink the time axis to one frame), then a filter branch
that makes a softmax-normalised sf×sf filter for each of the r² subpixels
of each LR pixel, applied to the window's reference frame through the
constant im2col of the reference (``F.unfold``, tap ``o = i·sf + j``; not a
parameter), a contraction and a PixelShuffle, plus a residual branch.  The
3D convs run NCDHW.  Channels-last at the boundary, (B, T, h, w, C) →
(B, rh, rw, C).  The module tree gives the reference's ``state_dict`` keys
(the JAX package's ``utils/torch_import.duf_net_key_map``): ``head``,
``denseLayer.conv{i}.{bn1,conv1,bn2,conv2}``, ``denseLayer.tail.{bn,conv}``,
``filterNet.conv{1,2}``, ``residualNet.conv{1,2}``.  BatchNorm follows the
module's mode: batch statistics in training, running ones in eval.

Under a spatial axis (``parallel/halo.py``) the head conv, every 3×3×3 and
(1,3,3) conv and the unfold exchange their halos (one row; sf//2 rows for
the unfold, whose zero rows past the border are its own zero padding);
the 1×1×1 convs, the softmax, the contraction and the PixelShuffle are
row-local, and a training BatchNorm reduces over the ranks that hold the
batch's other rows and items (``runner/trainers.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.halo import HaloConv2d, HaloConv3d, halo
from .common import batch_norm, conv2d, conv3d, to_conv_layout

#: backbone → (growth G, blocks that keep T, blocks that shrink T by 2,
#: channels into the tail)
_BACKBONES = {
    "_DenseLayer16": (32, 3, 3, 256),
    "_DenseLayer28": (16, 9, 3, 256),
    "_DenseLayer52": (16, 21, 3, 448),
}
_HEAD_FEATURES = 64


class _DenseBlock(nn.Module):
    """BN-ReLU-conv1×1×1 + BN-ReLU-conv3×3×3 (reference ``duf_net.py:195-214``);
    a shrinking block pads (0, 1, 1): no padding in time, two frames fewer."""

    def __init__(self, in_features: int, out_features: int, shrink: bool,
                 generator: torch.Generator):
        super().__init__()
        c = in_features
        self.bn1 = batch_norm(c, 3)
        self.conv1 = conv3d(c, c, 1, generator)
        self.bn2 = batch_norm(c, 3)
        self.conv2 = conv3d(c, out_features, 3, generator,
                            padding=(0, 1, 1) if shrink else (1, 1, 1), cls=HaloConv3d)

    def forward(self, x):
        x = self.conv1(F.relu(self.bn1(x)))
        return self.conv2(F.relu(self.bn2(x)))


class _DenseTail(nn.Module):
    def __init__(self, in_features: int, generator: torch.Generator):
        super().__init__()
        self.bn = batch_norm(in_features, 3)
        self.conv = conv3d(in_features, 256, (1, 3, 3), generator, padding=(0, 1, 1),
                           cls=HaloConv3d)

    def forward(self, x):
        return self.conv(F.relu(self.bn(x)))


class _DenseBackbone(nn.Module):
    """Reference ``_DenseLayer{16,28,52}`` (``duf_net.py:102-192``): each
    block's output joins the running concat along channels; a shrinking
    block's drops the concat's first and last frame."""

    def __init__(self, backbone: str, generator: torch.Generator):
        super().__init__()
        growth, n_keep, n_shrink, tail_in = _BACKBONES[backbone]
        self.n_keep, self.n_blocks = n_keep, n_keep + n_shrink
        c = _HEAD_FEATURES
        for i in range(self.n_blocks):
            setattr(self, f"conv{i}", _DenseBlock(c, growth, i >= n_keep, generator))
            c += growth
        self.tail = _DenseTail(tail_in, generator)

    def forward(self, x):
        concat = x
        for i in range(self.n_blocks):
            y = getattr(self, f"conv{i}")(concat)
            if i >= self.n_keep:
                concat = concat[:, :, 1:-1]
            concat = torch.cat([concat, y], dim=1)
        return self.tail(concat)


class DUFNet(nn.Module):
    """Reference ``duf_net.py:9-99``: (B, T, h, w, C) → (B, rh, rw, C)."""

    #: the axis the unfold takes its halo over
    spatial_axis = None

    def __init__(self, in_channels: int, out_channels: int, num_frames: int, size_filter: int,
                 upscale_factor: int, backbone: str, generator: torch.Generator | None = None):
        super().__init__()
        if backbone not in _BACKBONES:
            raise ValueError(f"Unknown backbone {backbone!r}.")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_frames = num_frames
        self.size_filter = size_filter
        self.upscale_factor = r = upscale_factor
        sf = size_filter
        self.head = conv2d(in_channels, _HEAD_FEATURES, 3, generator, cls=HaloConv2d)
        self.denseLayer = _DenseBackbone(backbone, generator)
        self.filterNet = nn.ModuleDict({
            "conv1": conv3d(256, 512, 1, generator),
            "conv2": conv3d(512, sf * sf * r * r, 1, generator),
        })
        self.residualNet = nn.ModuleDict({
            "conv1": conv3d(256, 256, 1, generator),
            "conv2": conv3d(256, in_channels * r * r, 1, generator),
        })

    def forward(self, lr_imgs: torch.Tensor) -> torch.Tensor:
        B, T, h, w, C = lr_imgs.shape
        sf, r = self.size_filter, self.upscale_factor
        t_ref = self.num_frames // 2 if self.num_frames % 2 == 1 else self.num_frames // 2 - 1

        feats = self.head(to_conv_layout(lr_imgs.reshape(B * T, h, w, C)))
        feats = feats.reshape(B, T, _HEAD_FEATURES, h, w).transpose(1, 2).contiguous()
        feats = self.denseLayer(feats)  # (B, 256, 1, h, w)

        # the filters: a softmax over the sf² taps of each of the r² subpixels
        f = self.filterNet["conv1"](F.relu(feats))
        f = self.filterNet["conv2"](F.relu(f))
        filters = torch.softmax(f[:, :, 0].reshape(B, sf * sf, r * r, h, w), dim=1)

        # the reference frame's sf×sf neighbourhoods, channel by channel
        target, pad = lr_imgs[:, t_ref], sf // 2
        if self.spatial_axis is not None:  # H padded from the halo, W with zeros
            target = halo(target.movedim(-1, -3), sf // 2, self.spatial_axis).movedim(-3, -1)
            pad = (0, sf // 2)
        outs = []
        for c in range(C):
            patches = F.unfold(target[:, None, :, :, c], sf, padding=pad).view(B, sf * sf, h, w)
            y = torch.einsum("bkhw,bkrhw->brhw", patches, filters)
            outs.append(F.pixel_shuffle(y, r))
        duf_out = torch.cat(outs, dim=1)

        g = self.residualNet["conv1"](F.relu(feats))
        g = self.residualNet["conv2"](F.relu(g))
        residual = F.pixel_shuffle(g[:, :, 0], r)
        return (duf_out + residual).permute(0, 2, 3, 1)
