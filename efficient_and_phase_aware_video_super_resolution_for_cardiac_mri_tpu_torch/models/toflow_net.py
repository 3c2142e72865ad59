"""TOFlow: task-oriented flow MISR (reference ``src/model/nets/toflow_net.py``), PyTorch.

Every frame is bicubic-upscaled (``align_corners=False``) and padded to a
multiple of 16 with the tensor's minimum; a SpyNet 4-level pyramid
(``avg_pool2d(2)``) estimates the flow from each neighbour to the reference
frame, the flow upsampled level to level by ``resize_bilinear(align_corners
=True)·2``; each neighbour is warped by its flow (``ops/warp.flow_warp``,
windowed under ``max_flow``), the frames are concatenated along channels,
and a 4-conv fusion plus the reference frame gives the output, cropped back.

In training SpyNet runs once per neighbour, so each call normalises with
its own BatchNorm batch statistics, as the reference's loop does
(``toflow_net.py:47-56``); in eval one batched call covers the T−1
neighbours (the same arithmetic, the running statistics frozen).
``self.training`` chooses.

The resize matrices are fp32, so the upscaled frames are fp32 whatever the
input's dtype, and every conv and BatchNorm here computes in the promoted
dtype of its input and its parameters, as flax's ``nn.Conv`` does: under
``compute_dtype: bfloat16`` the net runs in fp32 on bf16-rounded weights and
inputs, as the JAX package's does.

Under ``max_flow`` every upsampled pyramid flow and every final flow is a
telemetry site (``ops/telemetry.py``: ``spy_net/pyramid_flow_window`` and
``flow_window``, the JAX package's ``_sow_flow``), recorded only inside
``telemetry.collect``.

Under a spatial axis (``parallel/halo.py``) each rank holds a band of rows
of every frame: the bicubic upscale takes its band of the frame's
(``ops/resize.py``), the pad's minimum is the frame's and its rows go to
the top and bottom ranks (``models/common.pad_to_multiple``), the pools are
row-local (a band's rows stay even down the pyramid), the flow resizes
take their band, every 7×7 and 9×9 conv exchanges its halo, and each warp
reads the rows its window reaches from the neighbours under ``max_flow``,
else the frame gathered whole (``ops/warp.py``); each telemetry triple is
the frame's (``ops/telemetry.over_axis``).

Channels-last at the boundary, (B, T, h, w, C) → (B, rh, rw, C); NCHW
inside, flows (B, H, W, 2).  Keys: ``spy_net.blocks.{i}.block.{0,1,3,4,6,7,
9,10,12}`` and ``out_block.{0,2,4,6}`` (the JAX package's
``utils/torch_import.toflow_net_key_map``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import telemetry
from ..ops.resize import upsample_bicubic, upsample_bilinear
from ..ops.warp import flow_warp
from .common import (BatchNorm2d, PromotedConv2d, band_misfit, batch_norm, batch_norm_active,
                     check_band, conv2d, global_batch_norm, pad_to_multiple)


class _BatchNorm2d(BatchNorm2d):
    """``nn.BatchNorm2d`` in the promoted dtype of its input and its
    parameters; a training step's running statistics are computed in that
    dtype and stored back in the buffers' own (over the global batch
    inside ``common.batch_norm_group``)."""

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        if self.training and batch_norm_active():
            return global_batch_norm(self, x, dtype)
        if dtype == x.dtype == self.weight.dtype == self.running_mean.dtype:
            return super().forward(x)
        mean, var = self.running_mean.to(dtype), self.running_var.to(dtype)
        y = F.batch_norm(x.to(dtype), mean, var, self.weight.to(dtype), self.bias.to(dtype),
                         self.training, self.momentum, self.eps)
        if self.training:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        return y


def _record_flow(module: nn.Module, name: str, bound: int | None, flow: torch.Tensor,
                 axis=None) -> None:
    """|flow| in pixels against the ``max_flow`` exactness bound, over the
    frame's bands under ``axis``; nothing is computed unless collecting."""
    if bound is not None and telemetry.collecting(module):
        telemetry.record_triple(module, name, telemetry.over_axis(telemetry.exceedance_triple(
            bound, flow[..., 0].abs(), flow[..., 1].abs()), axis))


def _conv(in_features: int, features: int, kernel_size: int, generator: torch.Generator):
    return conv2d(in_features, features, kernel_size, generator, cls=PromotedConv2d)


def _bn(features: int) -> _BatchNorm2d:
    return batch_norm(features, cls=_BatchNorm2d)


class SpyNetBlock(nn.Module):
    """Four conv7×7 + BN + ReLU layers, then a conv7×7 to a 2-channel flow
    refinement (reference ``toflow_net.py:95-113``)."""

    def __init__(self, in_channels: int, generator: torch.Generator):
        super().__init__()
        layers, c = [], in_channels
        for width in (32, 64, 32, 16):
            layers += [_conv(c, width, 7, generator), _bn(width), nn.ReLU()]
            c = width
        layers.append(_conv(c, 2, 7, generator))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        return self.block(x)


class SpyNet(nn.Module):
    """Coarse-to-fine pyramid flow (reference ``toflow_net.py:70-92``):
    (ref, nbr) (B, C, H, W), H and W multiples of 16 → flow (B, H, W, 2)."""

    #: the axis the flow resizes and warps take their rows over
    spatial_axis = None

    def __init__(self, in_channels: int, generator: torch.Generator, max_flow: int | None = None):
        super().__init__()
        self.blocks = nn.ModuleList(SpyNetBlock(in_channels, generator) for _ in range(4))
        self.max_flow = max_flow

    def forward(self, ref, nbr):
        B, _, H, W = ref.shape
        refs, nbrs = [ref], [nbr]
        for _ in range(3):
            refs.insert(0, F.avg_pool2d(refs[0], 2))
            nbrs.insert(0, F.avg_pool2d(nbrs[0], 2))
        flow = ref.new_zeros(B, H // 16, W // 16, 2)
        axis = self.spatial_axis
        for block, r, n in zip(self.blocks, refs, nbrs):
            flow_up = upsample_bilinear(flow, 2, align_corners=True, axis=axis) * 2.0
            _record_flow(self, "pyramid_flow_window", self.max_flow, flow_up, axis)
            feats = torch.cat([r, flow_warp(n, flow_up, max_flow=self.max_flow, axis=axis),
                               flow_up.permute(0, 3, 1, 2)], dim=1)
            flow = flow_up + block(feats).permute(0, 2, 3, 1)
        return flow


class TOFlowNet(nn.Module):
    """Reference ``toflow_net.py:8-67``: (B, T, h, w, C) → (B, rh, rw, C).

    ``max_flow=R``: every warp takes the windowed path of ``ops/warp.py``,
    exact while |flow| <= R px (the JAX package's option; None is the
    reference's unbounded warp)."""

    spatial_axis = None
    #: a band after the centred pad: a multiple of SpyNet's factor 16 (its
    #: coarsest flow is H/16 rows) and at least 24 rows (its level H/8
    #: takes 7×7 halos)
    spatial_band = (16, 24)

    def band_misfit(self, rows: int, ranks: int) -> str | None:
        """Why LR frames of ``rows`` rows do not split over ``ranks``
        spatial ranks into bands this net takes (of the upsampled frame);
        None when they do."""
        return band_misfit(self.upscale_factor * rows, ranks, *self.spatial_band)

    def __init__(self, in_channels: int, out_channels: int, num_frames: int, upscale_factor: int,
                 max_flow: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_frames = num_frames
        self.upscale_factor = upscale_factor
        self.max_flow = max_flow
        self.spy_net = SpyNet(2 * in_channels + 2, generator, max_flow)
        self.out_block = nn.Sequential(
            _conv(in_channels * num_frames, 64, 9, generator), nn.ReLU(),
            _conv(64, 64, 9, generator), nn.ReLU(),
            _conv(64, 64, 1, generator), nn.ReLU(),
            _conv(64, out_channels, 1, generator),
        )

    def forward(self, lr_imgs: torch.Tensor) -> torch.Tensor:
        T = self.num_frames
        ref_idx = T // 2 if T % 2 == 1 else T // 2 - 1
        axis = self.spatial_axis
        x = upsample_bicubic(lr_imgs, self.upscale_factor, align_corners=False, axis=axis)
        x, crops = pad_to_multiple(x, 16, dims=(-3, -2), axis=axis)
        B, _, H, W, C = x.shape
        check_band(H, *self.spatial_band, "TOFlowNet", axis)
        x = x.permute(0, 1, 4, 2, 3).contiguous()  # (B, T, C, H, W)
        x_ref = x[:, ref_idx]
        if self.training:
            warped = []
            for i in range(T):
                if i == ref_idx:
                    warped.append(x_ref)
                    continue
                flow = self.spy_net(x_ref, x[:, i])
                _record_flow(self, "flow_window", self.max_flow, flow, axis)
                warped.append(flow_warp(x[:, i], flow, max_flow=self.max_flow, axis=axis))
        else:
            nbr_idx = [i for i in range(T) if i != ref_idx]
            n = len(nbr_idx)
            flat = x[:, nbr_idx].reshape(B * n, C, H, W)
            flows = self.spy_net(x_ref.repeat_interleave(n, dim=0), flat)
            _record_flow(self, "flow_window", self.max_flow, flows, axis)
            warped_nbrs = flow_warp(flat, flows, max_flow=self.max_flow,
                                    axis=axis).reshape(B, n, C, H, W)
            nbr_of = {i: k for k, i in enumerate(nbr_idx)}
            warped = [x_ref if i == ref_idx else warped_nbrs[:, nbr_of[i]] for i in range(T)]
        # frame-major channels: the reference's view(B, T*C, H, W)
        out = (self.out_block(torch.cat(warped, dim=1)) + x_ref).permute(0, 2, 3, 1)
        if crops is not None:  # crops of (B, T, H, W, C); out is (B, H, W, C)
            out = out[:, crops[2], crops[3]]
        return out
