"""SRFBN feedback SISR and its DRF variants (reference ``src/model/nets/srfb_net.py``,
``drf_sisr_net.py``, ``drf_net.py``), PyTorch.

The feedback block's mutable ``hidden_state`` is an explicit carry: the
single-image nets unroll it over ``num_steps`` and return the list of
per-step outputs; the video net, DRFNet, carries it across the frames.
Channels-last at the boundary, (B, h, w, C) → (B, rh, rw, C) and (B, T,
h, w, C) → (B, T, rh, rw, C), NCHW inside.  Module names give the
reference's ``state_dict`` keys (the JAX package's
``utils/torch_import._srfb_like_key_map``).

Under a spatial axis (``parallel/halo.py``) every conv with a window in H
exchanges its halo: the 3×3 convs one row, each down-projection (a conv
of stride r, ``PROJ_PARAMS``) p = 2 HR rows above and below, each
up-projection (a transposed conv of stride r) one LR row; SRFBNet's
bilinear skip is the band of the global resize (``ops/resize.py``).
Every rank runs the same steps and frames, so the exchanges come in the
same order on each.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.resize import upsample_bilinear
from ..parallel.halo import HaloConv2d, HaloConvTranspose2d
from .common import (
    PROJ_PARAMS,
    PReLU,
    UpsampleBlock,
    conv2d,
    conv_transpose2d,
    fold_time,
    to_conv_layout,
    unfold_time,
)


def _check_factor(upscale_factor: int) -> None:
    if upscale_factor not in PROJ_PARAMS:
        raise ValueError(f"The upscale factor should be 2, 3, 4 or 8. Got {upscale_factor}.")


class _LRFBlock(nn.Module):
    """LR feature extraction (reference ``srfb_net.py:53-59``)."""

    def __init__(self, in_channels: int, num_features: int, generator: torch.Generator):
        super().__init__()
        F_ = num_features
        self.conv1 = conv2d(in_channels, 4 * F_, 3, generator, cls=HaloConv2d)
        self.prelu1 = PReLU()
        self.conv2 = conv2d(4 * F_, F_, 1, generator)
        self.prelu2 = PReLU()

    def forward(self, x):
        return self.prelu2(self.conv2(self.prelu1(self.conv1(x))))


class _ConvPReLU(nn.Module):
    """conv + PReLU under the child names ``conv`` and ``prelu``."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv
        self.prelu = PReLU()

    def forward(self, x):
        return self.prelu(self.conv(x))


class _Projection(nn.Module):
    """One up (transposed conv) or down (strided conv) projection of the
    feedback block.  Group 0 is ``{deconv|conv}, prelu``; a later group
    first squeezes its dense input with a 1×1 conv: ``conv1, prelu1,
    {deconv2|conv2}, prelu2`` (reference ``srfb_net.py:80-110``)."""

    def __init__(self, up: bool, group: int, num_features: int, upscale_factor: int,
                 generator: torch.Generator):
        super().__init__()
        F_ = num_features
        k, s, p = PROJ_PARAMS[upscale_factor]
        self.names = []
        if group > 0:
            self.conv1 = conv2d(F_ * (group + 1), F_, 1, generator)
            self.prelu1 = PReLU()
            self.names = [("conv1", "prelu1")]
        if up:
            proj = conv_transpose2d(F_, F_, k, s, p, generator, cls=HaloConvTranspose2d)
        else:
            proj = conv2d(F_, F_, k, generator, stride=s, padding=p, cls=HaloConv2d)
        kind = "deconv" if up else "conv"
        proj_name, prelu_name = (f"{kind}2", "prelu2") if group > 0 else (kind, "prelu")
        setattr(self, proj_name, proj)
        setattr(self, prelu_name, PReLU())
        self.names.append((proj_name, prelu_name))

    def forward(self, x):
        for conv, prelu in self.names:
            x = getattr(self, prelu)(getattr(self, conv)(x))
        return x


class _FBlock(nn.Module):
    """Feedback block: dense up/down projection groups
    (reference ``srfb_net.py:62-134``)."""

    def __init__(self, num_features: int, num_groups: int, upscale_factor: int,
                 generator: torch.Generator):
        super().__init__()
        F_ = num_features
        self.in_block = _ConvPReLU(conv2d(2 * F_, F_, 1, generator))
        self.up_blocks = nn.ModuleList()
        self.down_blocks = nn.ModuleList()
        for i in range(num_groups):
            self.up_blocks.append(_Projection(True, i, F_, upscale_factor, generator))
            self.down_blocks.append(_Projection(False, i, F_, upscale_factor, generator))
        self.out_block = _ConvPReLU(conv2d(F_ * num_groups, F_, 1, generator))

    def forward(self, features, hidden_state):
        lr_list = [self.in_block(torch.cat([features, hidden_state], dim=1))]
        hr_list = []
        for up, down in zip(self.up_blocks, self.down_blocks):
            hr_list.append(up(torch.cat(lr_list, dim=1)))
            lr_list.append(down(torch.cat(hr_list, dim=1)))
        return self.out_block(torch.cat(lr_list[1:], dim=1))


class _RBlock(nn.Module):
    """Reconstruction: deconv + PReLU + conv (reference ``srfb_net.py:137-151``)."""

    def __init__(self, num_features: int, out_channels: int, upscale_factor: int,
                 generator: torch.Generator):
        super().__init__()
        k, s, p = PROJ_PARAMS[upscale_factor]
        self.deconv1 = conv_transpose2d(num_features, num_features, k, s, p, generator,
                                        cls=HaloConvTranspose2d)
        self.prelu1 = PReLU()
        self.conv2 = conv2d(num_features, out_channels, 3, generator, cls=HaloConv2d)

    def forward(self, x):
        return self.conv2(self.prelu1(self.deconv1(x)))


class SRFBNet(nn.Module):
    """Reference ``srfb_net.py:8-50``: a list of ``num_steps`` outputs, each the
    bilinear (``align_corners=False``) upscale of the input plus the
    reconstruction of that step's hidden state."""

    #: every conv and the skip take a halo (``parallel/halo.shard_spatially``)
    spatial_ready = True
    #: the axis the bilinear skip takes its band over
    spatial_axis = None

    def __init__(self, in_channels: int, out_channels: int, num_steps: int, num_features: int,
                 num_groups: int, upscale_factor: int, generator: torch.Generator | None = None):
        super().__init__()
        _check_factor(upscale_factor)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_steps = num_steps
        self.upscale_factor = upscale_factor
        self.lrf_block = _LRFBlock(in_channels, num_features, generator)
        self.f_block = _FBlock(num_features, num_groups, upscale_factor, generator)
        self.r_block = _RBlock(num_features, out_channels, upscale_factor, generator)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        upscaled = upsample_bilinear(x, self.upscale_factor, align_corners=False,
                                     axis=self.spatial_axis)
        # the LR features are the same at every step: computed once
        features = self.lrf_block(to_conv_layout(x))
        outputs, hidden = [], features
        for _ in range(self.num_steps):
            hidden = self.f_block(features, hidden)
            outputs.append(upscaled + self.r_block(hidden).permute(0, 2, 3, 1))
        return outputs


class DRFSISRNet(nn.Module):
    """DRF SISR variant (reference ``drf_sisr_net.py:8-148``): the feature-space
    sum of the LR features and the hidden state through the shared
    PixelShuffle ``UpsampleBlock``, one output a step."""

    spatial_ready = True

    def __init__(self, in_channels: int, out_channels: int, num_steps: int, num_features: int,
                 num_groups: int, upscale_factor: int, generator: torch.Generator | None = None):
        super().__init__()
        _check_factor(upscale_factor)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_steps = num_steps
        self.in_block = _LRFBlock(in_channels, num_features, generator)
        self.f_block = _FBlock(num_features, num_groups, upscale_factor, generator)
        self.out_block = UpsampleBlock(num_features, out_channels, upscale_factor, generator)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        features = self.in_block(to_conv_layout(x))
        outputs, hidden = [], features
        for _ in range(self.num_steps):
            hidden = self.f_block(features, hidden)
            outputs.append(self.out_block(features + hidden).permute(0, 2, 3, 1))
        return outputs


class DRFNet(nn.Module):
    """DRFSISRNet unrolled over video frames (reference ``drf_net.py:8-147``):
    (B, T, h, w, C) → (B, T, rh, rw, C).  The LR features of every frame
    come from one folded ``in_block`` call; frame t's feedback step reads
    the hidden state frame t−1 left, and frame 0 reads its own features
    (the JAX package's ``jnp.where(first, f, hidden)``).

    ``remat``: each frame step (feedback block and upsampler) is a
    non-reentrant ``torch.utils.checkpoint`` under autograd, so the
    backward keeps only the hidden states across frames and recomputes
    the rest (the JAX package's ``nn.remat`` of ``_DRFStep``); under a
    spatial axis the recompute reissues the step's halo exchanges."""

    spatial_ready = True

    def __init__(self, in_channels: int, out_channels: int, num_features: int, num_groups: int,
                 upscale_factor: int, remat: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        _check_factor(upscale_factor)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.remat = remat
        self.in_block = _LRFBlock(in_channels, num_features, generator)
        self.f_block = _FBlock(num_features, num_groups, upscale_factor, generator)
        self.out_block = UpsampleBlock(num_features, out_channels, upscale_factor, generator)

    def step(self, f: torch.Tensor, hidden: torch.Tensor):
        """One frame: its features and the incoming hidden state → (the new
        hidden state, the SR frame (B, C, rh, rw))."""
        hidden = self.f_block(f, hidden)
        return hidden, self.out_block(f + hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, spec = fold_time(x)
        feats = unfold_time(self.in_block(to_conv_layout(y)), spec)
        remat = self.remat and torch.is_grad_enabled()
        hidden, outs = feats[:, 0], []
        for t in range(feats.shape[1]):
            if remat:
                # the step is deterministic: no RNG state to stash and restore
                hidden, out = checkpoint(self.step, feats[:, t], hidden, use_reentrant=False,
                                         preserve_rng_state=False)
            else:
                hidden, out = self.step(feats[:, t], hidden)
            outs.append(out.permute(0, 2, 3, 1))
        return torch.stack(outs, dim=1)
