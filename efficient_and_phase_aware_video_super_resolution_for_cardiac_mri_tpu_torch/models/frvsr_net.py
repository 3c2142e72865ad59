"""FRVSR: frame-recurrent VSR (reference ``src/model/nets/frvsr_net.py``), PyTorch.

Each frame: FNet (a 6-scale conv encoder/decoder with a tanh output, on
the pair padded to a multiple of 8 with the pair's minimum) estimates the
LR flow from the previous LR frame; the flow is upsampled bilinearly ×r
(``align_corners=True``); the previous SR frame, detached, is warped
through the STN (``ops/warp.stn_warp``, border padding), packed by
space-to-depth (``F.pixel_unshuffle``: the channel order (c, i, j) of
``ops/pixel_shuffle.space_to_depth``) and fed with the current LR frame
into SRNet (a head conv, residual blocks, two ×2 transposed convs with
``output_padding=1``, a tail conv).  The step also returns the previous LR
frame warped by the LR flow, for ``FlowLoss``.

The recurrence is a loop over the frames of :meth:`FRVSRNet.step`, the one
per-frame step ``runner/streaming.FRVSRStream`` also runs, with the carry
(previous LR frame, previous SR frame) seeded as (frame 0, zeros).  Every
conv is Xavier-uniform (reference ``frvsr_net.py:35-38``) and computes in
the promoted dtype of its input and its parameters, as flax's ``nn.Conv``
does: under ``compute_dtype: bfloat16`` FNet's encoder runs in bf16, its
decoder (after the first fp32 resize product) and the flows in fp32, the
warps and SRNet in bf16, as the JAX package's ``_FRVSRStep`` computes.

``max_flow=R`` takes both warps' windowed path; the step then measures
both flows in pixels (normalised flow · size/2) against R, and the clip
forward folds the per-frame triples over time into the telemetry sites
``sr_flow_window`` and ``lr_flow_window`` (``ops/telemetry.py``), only
inside ``telemetry.collect``.  ``remat`` checkpoints each frame step under
autograd (non-reentrant), as ``DRFNet`` does.

Under a spatial axis (``parallel/halo.py``) each rank holds a band of rows
of every frame and of the carry: FNet's pad is the frame's
(``models/common.pad_to_multiple``), its convs and SRNet's exchange their
halos (the ×2 transposed convs with ``output_padding`` one row below the
band, ``parallel/halo.halo_conv_transpose2d``), the pools and
``pixel_unshuffle`` are row-local, the resizes take their band, the warps
read the rows their window reaches from the neighbours under ``max_flow``,
else the frame gathered whole (``ops/warp.py``), and the flows are
measured against the frame's height.

Channels-last at the boundary: (B, T, h, w, C) → (B, T, rh, rw, C) SR
frames and (B, T, h, w, C) warped LR frames; NCHW inside, flows (B, h, w,
2).  Keys: ``fnet.body.conv{1..6}_{1,2}``, ``fnet.tail.conv{1,2}``,
``srnet.head.conv``, ``srnet.body.{i}.body.conv{1,2}``,
``srnet.tail.{deconv1,deconv2,conv}`` (the JAX package's
``utils/torch_import.frvsr_net_key_map``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import telemetry
from ..ops.resize import upsample_bilinear
from ..ops.warp import stn_warp
from ..parallel.halo import HaloConvTranspose2d
from .common import (
    PromotedConv2d,
    band_misfit,
    check_band,
    conv2d,
    conv_format,
    conv_transpose2d,
    init_xavier_,
    pad_to_multiple,
    to_conv_layout,
)


def _xconv(in_features: int, features: int, generator: torch.Generator) -> nn.Conv2d:
    conv = conv2d(in_features, features, 3, generator, cls=PromotedConv2d)
    init_xavier_(conv.weight, generator)
    return conv


class _ResBlock(nn.Module):
    def __init__(self, features: int, generator: torch.Generator):
        super().__init__()
        self.body = nn.ModuleDict({"conv1": _xconv(features, features, generator),
                                   "conv2": _xconv(features, features, generator)})

    def forward(self, x):
        return x + self.body["conv2"](F.relu(self.body["conv1"](x)))


class SRNet(nn.Module):
    """Reference ``frvsr_net.py:65-95``: the packed warped SR frame and the
    LR frame, (B, C·(r²+1), h, w) → (B, C_out, 4h, 4w)."""

    def __init__(self, in_channels: int, out_channels: int, upscale_factor: int,
                 num_resblocks: int, generator: torch.Generator):
        super().__init__()
        self.head = nn.ModuleDict({
            "conv": _xconv(in_channels * (upscale_factor ** 2 + 1), 64, generator)})
        self.body = nn.ModuleList(_ResBlock(64, generator) for _ in range(num_resblocks))
        deconvs = {}
        for i in (1, 2):
            deconv = conv_transpose2d(64, 64, 3, 2, 1, generator, output_padding=1,
                                      cls=HaloConvTranspose2d)
            init_xavier_(deconv.weight, generator)
            deconvs[f"deconv{i}"] = deconv
        self.tail = nn.ModuleDict({**deconvs, "conv": _xconv(64, out_channels, generator)})

    def forward(self, x):
        x = F.relu(self.head["conv"](x))
        for block in self.body:
            x = block(x)
        x = F.relu(self.tail["deconv1"](x))
        x = F.relu(self.tail["deconv2"](x))
        return self.tail["conv"](x)


class FNet(nn.Module):
    """Reference ``frvsr_net.py:110-166``: (a, b) (B, C, h, w) → the flow
    (B, h, w, 2), on the pair padded to a multiple of 8 with its minimum
    (``F.pad(value=x.min())``), cropped back."""

    #: the axis the pad and the resizes take their rows over
    spatial_axis = None

    def __init__(self, in_channels: int, out_channels: int, generator: torch.Generator):
        super().__init__()
        body, f, c_in = {}, 32, 2 * in_channels
        for i in range(3):  # encoder: 32, 64, 128 features, max-pooled
            body[f"conv{i + 1}_1"] = _xconv(c_in, f, generator)
            body[f"conv{i + 1}_2"] = _xconv(f, f, generator)
            c_in, f = f, f * 2
        for i in range(3):  # decoder: 256, 128, 64 features, upsampled
            body[f"conv{i + 4}_1"] = _xconv(c_in, f, generator)
            body[f"conv{i + 4}_2"] = _xconv(f, f, generator)
            c_in, f = f, f // 2
        self.body = nn.ModuleDict(body)
        self.tail = nn.ModuleDict({"conv1": _xconv(c_in, 32, generator),
                                   "conv2": _xconv(32, out_channels, generator)})

    def forward(self, a, b):
        axis = self.spatial_axis
        x, crops = pad_to_multiple(torch.cat([a, b], dim=1), 8, dims=(-2, -1), axis=axis)
        check_band(x.shape[-2], *FRVSRNet.spatial_band, "FRVSRNet", axis)
        for i in range(1, 7):
            x = F.leaky_relu(self.body[f"conv{i}_1"](x), 0.2)
            x = F.leaky_relu(self.body[f"conv{i}_2"](x), 0.2)
            if i <= 3:
                x = F.max_pool2d(x, 2)
            else:  # the resize product is fp32: later convs promote to it
                x = upsample_bilinear(x.permute(0, 2, 3, 1), 2, align_corners=False, axis=axis)
                x = x.permute(0, 3, 1, 2).contiguous(memory_format=conv_format(x.dtype))
        x = F.leaky_relu(self.tail["conv1"](x), 0.2)
        x = torch.tanh(self.tail["conv2"](x))
        if crops is not None:
            x = x[crops]
        return x.permute(0, 2, 3, 1)


class FRVSRNet(nn.Module):
    """Reference ``frvsr_net.py:11-62``: (B, T, h, w, C) → (sr_seq,
    warped_lr_seq), or sr_seq alone when ``is_prediction``."""

    spatial_axis = None
    #: a band after FNet's centred pad: a multiple of its three 2×2 pools' 8
    spatial_band = (8, 8)

    def band_misfit(self, rows: int, ranks: int) -> str | None:
        """Why LR frames of ``rows`` rows do not split over ``ranks``
        spatial ranks into bands this net takes; None when they do."""
        return band_misfit(rows, ranks, *self.spatial_band)

    def __init__(self, in_channels: int, out_channels: int, upscale_factor: int,
                 is_prediction: bool = False, num_resblocks: int = 10,
                 max_flow: int | None = None, remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        # SRNet's tail hardcodes two x2 transposed-conv stages
        # (reference frvsr_net.py:84-88): the reference is x4-only too
        if upscale_factor != 4:
            raise ValueError(f"FRVSRNet supports upscale_factor=4 only. Got {upscale_factor}.")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.upscale_factor = upscale_factor
        self.is_prediction = is_prediction
        self.max_flow = max_flow
        self.remat = remat
        self.fnet = FNet(in_channels, 2, generator)
        self.srnet = SRNet(in_channels, out_channels, upscale_factor, num_resblocks, generator)

    def initial_carry(self, frame: torch.Tensor):
        """The carry before frame 0 (``frame``, (B, C, h, w)): (frame 0,
        a zero SR frame), so the first step estimates the flow from frame 0
        to itself and warps zeros."""
        B, C, h, w = frame.shape
        r = self.upscale_factor
        return frame, frame.new_zeros(B, C, h * r, w * r)

    def step(self, carry, x: torch.Tensor, triples: bool = False):
        """One frame: the carry (previous LR frame, previous SR frame) and
        the LR frame ``x`` (B, C, h, w) → (new carry, SR frame (B, C, rh,
        rw), previous LR frame warped to ``x``, the (sr, lr) flows'
        exceedance triples when ``triples`` (else None))."""
        r, axis = self.upscale_factor, self.spatial_axis
        lr_last, sr_last = carry
        lr_flow = self.fnet(lr_last, x)
        sr_flow = upsample_bilinear(lr_flow, r, align_corners=True, axis=axis)
        warped_sr = stn_warp(sr_last.detach(), sr_flow[..., 0], sr_flow[..., 1], "border",
                             max_flow=self.max_flow, axis=axis)
        packed = F.pixel_unshuffle(warped_sr, r)
        sr = self.srnet(torch.cat([packed, x], dim=1))
        warped_lr = stn_warp(lr_last, lr_flow[..., 0], lr_flow[..., 1], "border",
                             max_flow=self.max_flow, axis=axis)
        tel = None
        if triples:
            # the STN flow is normalised: pixel displacement = u·W/2, v·H/2
            # of the warped image (the frame's height under an axis)
            h, w = x.shape[-2:]
            h *= axis.size if axis is not None else 1
            tel = (telemetry.exceedance_triple(self.max_flow, sr_flow[..., 0].abs() * (w * r / 2.0),
                                               sr_flow[..., 1].abs() * (h * r / 2.0)),
                   telemetry.exceedance_triple(self.max_flow, lr_flow[..., 0].abs() * (w / 2.0),
                                               lr_flow[..., 1].abs() * (h / 2.0)))
        return (x, sr), sr, warped_lr, tel

    def forward(self, lr_imgs: torch.Tensor):
        frames = [to_conv_layout(lr_imgs[:, t]) for t in range(lr_imgs.shape[1])]
        carry = self.initial_carry(frames[0])
        triples = self.max_flow is not None and telemetry.collecting(self)
        remat = self.remat and torch.is_grad_enabled()
        srs, warped, tels = [], [], []
        for x in frames:
            if remat:
                # the step is deterministic: no RNG state to stash and restore
                carry, sr, warped_lr, tel = checkpoint(self.step, carry, x, triples,
                                                       use_reentrant=False,
                                                       preserve_rng_state=False)
            else:
                carry, sr, warped_lr, tel = self.step(carry, x, triples)
            srs.append(sr.permute(0, 2, 3, 1))
            warped.append(warped_lr.permute(0, 2, 3, 1))
            tels.append(tel)
        if triples:
            for name, site in (("sr_flow_window", 0), ("lr_flow_window", 1)):
                stacked = torch.stack([tel[site] for tel in tels], dim=1)
                telemetry.record_triple(self, name, telemetry.over_axis(
                    telemetry.merge_time_axis(stacked), self.spatial_axis))
        sr_seq = torch.stack(srs, dim=1)
        if self.is_prediction:
            return sr_seq
        return sr_seq, torch.stack(warped, dim=1)
