"""EDVR: PCD-aligned, TSA-fused MISR (reference ``src/model/nets/edvr_net/``), PyTorch.

The port of the JAX package's ``models/edvr_net.py`` (reference
``EDVR_arch.py``):

* a feature pyramid (L1, L2, L3 by stride-2 convs) of every frame, with
  ``front_RBs`` residual blocks at L1, optionally behind the predeblur
  pyramid (``predeblur``) or two stride-2 convs (``HR_in``);
* PCD alignment, one neighbour at a time as the JAX package loops: per
  level an offset conv stack (the coarser level's offsets upsampled
  bilinearly and doubled), a deformable conv pack (``DCNPack``: offsets and
  a sigmoid mask from a zero-initialised conv over the offset features,
  ``ops/deform_conv.py``'s kernels on the card), then a cascading DCN at L1;
* TSA fusion (temporal attention against the centre frame's embedding, a
  spatial attention pyramid with 3×3/s2 max and average pools), or a 1×1
  conv over the frame-major channels (``w_TSA=False``);
* ``back_RBs`` residual blocks, two conv + PixelShuffle(2) stages, HRconv,
  conv_last, plus the centre frame upsampled bilinearly ×4 (or itself with
  ``HR_in``).

The input is padded to a multiple of 4 with the tensor's minimum and the
output cropped back (``models/common.pad_to_multiple``).  Every conv
computes in the promoted dtype of its input and its parameters, as flax's
``nn.Conv``: under ``compute_dtype: bfloat16`` the features and the L3
level run in bf16, and from the first fp32 resize product on (the L2 and
L1 offsets, the DCN's mask and col, TSA, the trunk) in fp32 on
bf16-rounded weights, as the JAX package's net computes.

``dcn_max_offset=R`` takes the windowed DCN sampling (exact while every
|offset| ≤ R) and makes each DCN pack a telemetry site
(``pcd_align/{L3,L2,L1,cas}_dcnpack/dcn_offset_window``, the five
neighbours' calls merged), recorded only inside ``telemetry.collect``.

Under a spatial axis (``parallel/halo.py``) each rank holds a band of rows
of every frame, a multiple of 4 LR rows: the pad is the frame's
(``models/common.pad_to_multiple``), every conv exchanges its halo (the
3×3/s2/p1 pyramid convs one row from above), the resizes take their band
(``ops/resize.py``), TSA's pools take one row from above (−inf past the
frame's border for the max, zeros for the count-including average), the
PixelShuffles are row-local, and each DCN pack samples its band's window
rows from the neighbours under ``dcn_max_offset``, else the frame
gathered whole (``ops/deform_conv.spatial_operand``).

Channels-last at the boundary, (B, N, h, w, C) → (B, 4h, 4w, C); NCHW
inside.  Keys are the reference's (the JAX package's
``utils/torch_import.edvr_net_key_map``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.deform_conv import ModulatedDeformConvPack
from ..ops.resize import resize_bilinear, upsample_bilinear
from ..parallel.halo import halo
from .common import PromotedConv2d, band_misfit, check_band, conv2d, pad_to_multiple


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


def _conv(in_features: int, features: int, kernel_size: int, generator: torch.Generator,
          stride: int = 1) -> nn.Conv2d:
    return conv2d(in_features, features, kernel_size, generator, stride=stride,
                  cls=PromotedConv2d)


def _resize(x: torch.Tensor, hw: tuple[int, int], axis=None) -> torch.Tensor:
    """``F.interpolate(mode='bilinear', align_corners=False)`` of NCHW ``x``
    through the dense matrices of ``ops/resize.py`` (fp32); under ``axis``
    (a ×2 resize) this rank's band of the frame's."""
    if axis is None:
        return resize_bilinear(x.unsqueeze(-1), hw, align_corners=False)[..., 0]
    if hw != (x.shape[-2] * 2, x.shape[-1] * 2):
        raise ValueError(f"a sharded resize here is ×2; got {tuple(x.shape[-2:])} → {hw}")
    return upsample_bilinear(x.unsqueeze(-1), 2, align_corners=False, axis=axis)[..., 0]


def _up2(x: torch.Tensor, axis=None) -> torch.Tensor:
    return _resize(x, (x.shape[-2] * 2, x.shape[-1] * 2), axis)


class ResidualBlockNoBN(nn.Module):
    """conv-ReLU-conv + skip (``arch_util.py:34-52``): kaiming-normal
    (fan_in) weights × 0.1 and zero biases (``initialize_weights``)."""

    def __init__(self, nf: int, generator: torch.Generator):
        super().__init__()
        self.conv1 = _conv(nf, nf, 3, generator)
        self.conv2 = _conv(nf, nf, 3, generator)
        with torch.no_grad():
            for conv in (self.conv1, self.conv2):
                nn.init.kaiming_normal_(conv.weight, a=0, mode="fan_in", generator=generator)
                conv.weight.mul_(0.1)
                conv.bias.zero_()

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


class DCNPack(ModulatedDeformConvPack):
    """The reference's ``DCN(nf, nf, 3, padding=1, deformable_groups=groups,
    extra_offset_mask=True)``: ``conv_offset_mask`` over the offset features
    → (o1, o2, mask), offset ``cat(o1, o2)``, ``sigmoid(mask)``, then the
    deformable conv (JAX ``DCNPack``)."""

    def __init__(self, nf: int, kernel_size: int, deformable_groups: int,
                 max_offset: int | None, generator: torch.Generator):
        super().__init__(nf, nf, kernel_size, padding=kernel_size // 2,
                         deformable_groups=deformable_groups, extra_offset_mask=True,
                         max_offset=max_offset, generator=generator)


class PCDAlign(nn.Module):
    """Pyramid, cascading and deformable alignment (``EDVR_arch.py:191-251``)."""

    #: the axis the offsets' and features' resizes take their band over
    spatial_axis = None

    def __init__(self, nf: int, groups: int, max_offset: int | None, generator: torch.Generator):
        super().__init__()
        g = generator
        for lvl in ("L3", "L2", "L1"):
            setattr(self, f"{lvl}_offset_conv1", _conv(nf * 2, nf, 3, g))
            if lvl == "L3":
                self.L3_offset_conv2 = _conv(nf, nf, 3, g)
            else:
                setattr(self, f"{lvl}_offset_conv2", _conv(nf * 2, nf, 3, g))
                setattr(self, f"{lvl}_offset_conv3", _conv(nf, nf, 3, g))
            setattr(self, f"{lvl}_dcnpack", DCNPack(nf, 3, groups, max_offset, g))
            if lvl != "L3":
                setattr(self, f"{lvl}_fea_conv", _conv(nf * 2, nf, 3, g))
        self.cas_offset_conv1 = _conv(nf * 2, nf, 3, g)
        self.cas_offset_conv2 = _conv(nf, nf, 3, g)
        self.cas_dcnpack = DCNPack(nf, 3, groups, max_offset, g)

    def forward(self, nbr, ref):
        a = self.spatial_axis
        # L3
        off = _lrelu(self.L3_offset_conv1(torch.cat([nbr[2], ref[2]], dim=1)))
        L3_offset = _lrelu(self.L3_offset_conv2(off))
        L3_fea = _lrelu(self.L3_dcnpack(nbr[2], L3_offset))
        # L2
        off = _lrelu(self.L2_offset_conv1(torch.cat([nbr[1], ref[1]], dim=1)))
        off = _lrelu(self.L2_offset_conv2(torch.cat([off, _up2(L3_offset, a) * 2], dim=1)))
        L2_offset = _lrelu(self.L2_offset_conv3(off))
        L2_fea = self.L2_dcnpack(nbr[1], L2_offset)
        L2_fea = _lrelu(self.L2_fea_conv(torch.cat([L2_fea, _up2(L3_fea, a)], dim=1)))
        # L1
        off = _lrelu(self.L1_offset_conv1(torch.cat([nbr[0], ref[0]], dim=1)))
        off = _lrelu(self.L1_offset_conv2(torch.cat([off, _up2(L2_offset, a) * 2], dim=1)))
        L1_offset = _lrelu(self.L1_offset_conv3(off))
        L1_fea = self.L1_dcnpack(nbr[0], L1_offset)
        L1_fea = self.L1_fea_conv(torch.cat([L1_fea, _up2(L2_fea, a)], dim=1))
        # cascading
        off = _lrelu(self.cas_offset_conv1(torch.cat([L1_fea, ref[0]], dim=1)))
        off = _lrelu(self.cas_offset_conv2(off))
        return _lrelu(self.cas_dcnpack(L1_fea, off))


class TSAFusion(nn.Module):
    """Temporal and spatial attention fusion (``EDVR_arch.py:254-321``)."""

    #: the axis the pools and resizes take their rows over
    spatial_axis = None

    def __init__(self, nf: int, nframes: int, center: int, generator: torch.Generator):
        super().__init__()
        g = generator
        self.center = center
        self.tAtt_1 = _conv(nf, nf, 3, g)
        self.tAtt_2 = _conv(nf, nf, 3, g)
        self.fea_fusion = _conv(nframes * nf, nf, 1, g)
        self.sAtt_1 = _conv(nframes * nf, nf, 1, g)
        self.sAtt_2 = _conv(nf * 2, nf, 1, g)
        self.sAtt_3 = _conv(nf, nf, 3, g)
        self.sAtt_4 = _conv(nf, nf, 1, g)
        self.sAtt_5 = _conv(nf, nf, 3, g)
        self.sAtt_L1 = _conv(nf, nf, 1, g)
        self.sAtt_L2 = _conv(nf * 2, nf, 3, g)
        self.sAtt_L3 = _conv(nf, nf, 3, g)
        self.sAtt_add_1 = _conv(nf, nf, 1, g)
        self.sAtt_add_2 = _conv(nf, nf, 1, g)

    @staticmethod
    def _pools(x, axis=None):
        # max pool pads with -inf; the average divides by the full window
        # (count_include_pad), the JAX package's _torch_avg_pool_3x3s2p1
        if axis is None:
            return torch.cat([F.max_pool2d(x, 3, 2, 1),
                              F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)], dim=1)
        # a band's outputs read one row above it and none below: the row of
        # the rank above, or past the frame's border -inf for the max and
        # zero for the average (which still divides by 9)
        rows = x.shape[-2]
        xa = halo(x, 1, axis)[..., :rows + 1, :]
        xm = xa
        if axis.index == 0:
            xm = torch.cat([torch.full_like(xa[..., :1, :], float("-inf")), xa[..., 1:, :]],
                           dim=-2)
        return torch.cat([F.max_pool2d(xm, 3, 2, (0, 1)),
                          F.avg_pool2d(xa, 3, 2, (0, 1), count_include_pad=True)], dim=1)

    def forward(self, aligned):
        B, N, C, H, W = aligned.shape
        emb_ref = self.tAtt_2(aligned[:, self.center])
        emb = self.tAtt_1(aligned.reshape(B * N, C, H, W)).reshape(B, N, -1, H, W)
        cor_prob = torch.sigmoid((emb * emb_ref[:, None]).sum(2, keepdim=True))  # (B, N, 1, H, W)
        merged = (aligned * cor_prob).reshape(B, N * C, H, W)  # frame-major channels

        a = self.spatial_axis
        fea = _lrelu(self.fea_fusion(merged))
        att = _lrelu(self.sAtt_1(merged))
        att = _lrelu(self.sAtt_2(self._pools(att, a)))
        att_L = _lrelu(self.sAtt_L1(att))
        att_L = _lrelu(self.sAtt_L2(self._pools(att_L, a)))
        att_L = _up2(_lrelu(self.sAtt_L3(att_L)), a)
        att = _lrelu(self.sAtt_3(att)) + att_L
        att = _resize(_lrelu(self.sAtt_4(att)), (H, W), a)
        att = self.sAtt_5(att)
        att_add = self.sAtt_add_2(_lrelu(self.sAtt_add_1(att)))
        return fea * torch.sigmoid(att) * 2 + att_add


class PredeblurPyramid(nn.Module):
    """``EDVR_arch.py:148-188``."""

    #: the axis the resizes take their band over
    spatial_axis = None

    def __init__(self, in_channels: int, nf: int, HR_in: bool, generator: torch.Generator):
        super().__init__()
        g = generator
        self.HR_in = HR_in
        if HR_in:
            self.conv_first_1 = _conv(in_channels, nf, 3, g)
            self.conv_first_2 = _conv(nf, nf, 3, g, stride=2)
            self.conv_first_3 = _conv(nf, nf, 3, g, stride=2)
        else:
            self.conv_first = _conv(in_channels, nf, 3, g)
        self.deblur_L2_conv = _conv(nf, nf, 3, g, stride=2)
        self.deblur_L3_conv = _conv(nf, nf, 3, g, stride=2)
        for name in ("RB_L3_1", "RB_L2_1", "RB_L2_2", "RB_L1_1", "RB_L1_2", "RB_L1_3", "RB_L1_4",
                     "RB_L1_5"):
            setattr(self, name, ResidualBlockNoBN(nf, g))

    def forward(self, x):
        if self.HR_in:
            f = _lrelu(self.conv_first_1(x))
            f = _lrelu(self.conv_first_2(f))
            L1 = _lrelu(self.conv_first_3(f))
        else:
            L1 = _lrelu(self.conv_first(x))
        L2 = _lrelu(self.deblur_L2_conv(L1))
        L3 = _lrelu(self.deblur_L3_conv(L2))
        L3 = _up2(self.RB_L3_1(L3), self.spatial_axis)
        L2 = _up2(self.RB_L2_2(self.RB_L2_1(L2) + L3), self.spatial_axis)
        L1 = self.RB_L1_2(self.RB_L1_1(L1)) + L2
        return self.RB_L1_5(self.RB_L1_4(self.RB_L1_3(L1)))


class EDVRNet(nn.Module):
    """``EDVR_arch.py:13-145``: (B, N, h, w, C) → (B, 4h, 4w, C)."""

    spatial_axis = None
    #: a band after the centred pad: a multiple of the two stride-2 levels' 4
    spatial_band = (4, 4)

    def band_misfit(self, rows: int, ranks: int) -> str | None:
        """Why LR frames of ``rows`` rows do not split over ``ranks``
        spatial ranks into bands this net takes; None when they do."""
        return band_misfit(rows, ranks, *self.spatial_band)

    def __init__(self, in_channels: int, out_channels: int, nf: int = 64, nframes: int = 5,
                 groups: int = 8, front_RBs: int = 5, back_RBs: int = 10,
                 center: int | None = None, predeblur: bool = False, HR_in: bool = False,
                 w_TSA: bool = True, dcn_max_offset: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        g = generator
        self.nframes = nframes
        self.center = nframes // 2 if center is None else center
        self.predeblur, self.HR_in, self.w_TSA = predeblur, HR_in, w_TSA
        self.dcn_max_offset = dcn_max_offset
        if predeblur:
            self.pre_deblur = PredeblurPyramid(in_channels, nf, HR_in, g)
            self.conv_1x1 = _conv(nf, nf, 1, g)
        elif HR_in:
            self.conv_first_1 = _conv(in_channels, nf, 3, g)
            self.conv_first_2 = _conv(nf, nf, 3, g, stride=2)
            self.conv_first_3 = _conv(nf, nf, 3, g, stride=2)
        else:
            self.conv_first = _conv(in_channels, nf, 3, g)
        self.feature_extraction = nn.Sequential(*(ResidualBlockNoBN(nf, g)
                                                  for _ in range(front_RBs)))
        self.fea_L2_conv1 = _conv(nf, nf, 3, g, stride=2)
        self.fea_L2_conv2 = _conv(nf, nf, 3, g)
        self.fea_L3_conv1 = _conv(nf, nf, 3, g, stride=2)
        self.fea_L3_conv2 = _conv(nf, nf, 3, g)
        self.pcd_align = PCDAlign(nf, groups, dcn_max_offset, g)
        self.tsa_fusion = (TSAFusion(nf, nframes, self.center, g) if w_TSA
                           else _conv(nframes * nf, nf, 1, g))
        self.recon_trunk = nn.Sequential(*(ResidualBlockNoBN(nf, g) for _ in range(back_RBs)))
        self.upconv1 = _conv(nf, nf * 4, 3, g)
        self.upconv2 = _conv(nf, 64 * 4, 3, g)
        self.HRconv = _conv(64, 64, 3, g)
        self.conv_last = _conv(64, out_channels, 3, g)

    def forward(self, lr_imgs: torch.Tensor) -> torch.Tensor:
        axis = self.spatial_axis
        x, crops = pad_to_multiple(lr_imgs, 4, dims=(-3, -2), axis=axis)
        B, N, H, W, C = x.shape
        check_band(H, *self.spatial_band, "EDVRNet", axis)
        x_center = x[:, self.center]
        frames = x.permute(0, 1, 4, 2, 3).reshape(B * N, C, H, W)
        if self.predeblur:
            L1 = self.conv_1x1(self.pre_deblur(frames))
        elif self.HR_in:
            L1 = _lrelu(self.conv_first_1(frames))
            L1 = _lrelu(self.conv_first_2(L1))
            L1 = _lrelu(self.conv_first_3(L1))
        else:
            L1 = _lrelu(self.conv_first(frames))
        L1 = self.feature_extraction(L1)
        L2 = _lrelu(self.fea_L2_conv2(_lrelu(self.fea_L2_conv1(L1))))
        L3 = _lrelu(self.fea_L3_conv2(_lrelu(self.fea_L3_conv1(L2))))
        L1, L2, L3 = (t.reshape(B, N, *t.shape[1:]) for t in (L1, L2, L3))

        c = self.center
        ref = [L1[:, c], L2[:, c], L3[:, c]]
        # one neighbour at a time, as the JAX package loops (its measured
        # choice: 1/N of the alignment's activations alive at once)
        aligned = torch.stack([self.pcd_align([L1[:, i], L2[:, i], L3[:, i]], ref)
                               for i in range(N)], dim=1)  # (B, N, nf, h, w)
        if self.w_TSA:
            fea = self.tsa_fusion(aligned)
        else:
            fea = self.tsa_fusion(aligned.reshape(B, -1, *aligned.shape[3:]))

        out = self.recon_trunk(fea)
        out = _lrelu(F.pixel_shuffle(self.upconv1(out), 2))
        out = _lrelu(F.pixel_shuffle(self.upconv2(out), 2))
        out = self.conv_last(_lrelu(self.HRconv(out))).permute(0, 2, 3, 1)
        base = (x_center if self.HR_in
                else upsample_bilinear(x_center, 4, align_corners=False, axis=axis))
        out = out + base
        if crops is not None:  # crops of (B, N, H, W, C) at input scale, ×4 (JAX's crop)
            hs, ws = crops[2], crops[3]
            out = out[:, hs.start * 4 : hs.stop * 4, ws.start * 4 : ws.stop * 4]
        return out
