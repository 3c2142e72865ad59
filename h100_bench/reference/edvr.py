"""EDVR (Wang et al., CVPRW 2019, arXiv:1905.02716) in plain PyTorch.

The published net without predeblur and HR input, as a function of a
parameter dict with the original ``state_dict``'s keys:

* per frame: conv 3×3 + LeakyReLU(0.1), ``front_RBs`` residual blocks
  (conv-ReLU-conv + skip), then L2 and L3 by (3×3 stride-2 conv, 3×3 conv),
  each followed by LeakyReLU;
* PCD alignment of each frame to the centre one, coarse to fine: offset
  features from [neighbour ‖ reference] convs (plus the coarser offsets,
  upsampled bilinearly ×2 and doubled), a modulated deformable conv
  (offsets and a sigmoid mask from a 3×3 conv over the offset features,
  ``deformable_groups`` groups), the coarser aligned features upsampled and
  merged, then a cascading deformable conv at L1;
* TSA fusion: temporal attention (sigmoid of the per-pixel dot product of
  each frame's embedding with the centre's), then spatial attention over a
  pyramid of 3×3/s2 max and average pools;
* ``back_RBs`` residual blocks, (conv to 4·nf, PixelShuffle(2), LeakyReLU)
  twice, conv, LeakyReLU, conv to the output, plus the centre frame
  upsampled bilinearly ×4.

Every conv runs through :mod:`ops`, the deformable ones through its
gather-based deformable im2col.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import bilinear, conv2d, deform_conv2d, leaky_relu


class EDVR:
    """``forward(lr (B, N, h, w, C))`` → (B, 4h, 4w, C)."""

    def __init__(self, params: dict, kwargs: dict):
        self.p = params
        self.nf = int(kwargs["nf"])
        self.N = int(kwargs["nframes"])
        self.groups = int(kwargs["groups"])
        self.front = int(kwargs["front_RBs"])
        self.back = int(kwargs["back_RBs"])
        self.center = self.N // 2
        for key in ("predeblur", "HR_in"):
            if kwargs.get(key):
                raise ValueError(f"the reference covers EDVR without {key}")
        if kwargs.get("w_TSA", True) is False or kwargs.get("dcn_max_offset"):
            raise ValueError("the reference covers TSA fusion and the exact DCN only")

    def _conv(self, name, x, stride=1):
        w = self.p[f"{name}.weight"]
        return conv2d(x, w, self.p[f"{name}.bias"], stride=stride, padding=w.shape[-1] // 2)

    def _rb(self, name, x):
        return x + self._conv(f"{name}.conv2", F.relu(self._conv(f"{name}.conv1", x)))

    def _dcn(self, name, x, offset_feats):
        om = self._conv(f"{name}.conv_offset_mask", offset_feats)
        o1, o2, mask = torch.chunk(om, 3, dim=1)
        return deform_conv2d(x, torch.cat([o1, o2], dim=1), torch.sigmoid(mask),
                             self.p[f"{name}.weight"], self.p[f"{name}.bias"], 1, self.groups)

    @staticmethod
    def _up2(x):
        return bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))

    def _pcd(self, nbr, ref):
        c, lr = self._conv, leaky_relu
        a = "pcd_align"
        off = lr(c(f"{a}.L3_offset_conv1", torch.cat([nbr[2], ref[2]], 1)))
        L3_off = lr(c(f"{a}.L3_offset_conv2", off))
        L3 = lr(self._dcn(f"{a}.L3_dcnpack", nbr[2], L3_off))
        off = lr(c(f"{a}.L2_offset_conv1", torch.cat([nbr[1], ref[1]], 1)))
        off = lr(c(f"{a}.L2_offset_conv2", torch.cat([off, self._up2(L3_off) * 2], 1)))
        L2_off = lr(c(f"{a}.L2_offset_conv3", off))
        L2 = self._dcn(f"{a}.L2_dcnpack", nbr[1], L2_off)
        L2 = lr(c(f"{a}.L2_fea_conv", torch.cat([L2, self._up2(L3)], 1)))
        off = lr(c(f"{a}.L1_offset_conv1", torch.cat([nbr[0], ref[0]], 1)))
        off = lr(c(f"{a}.L1_offset_conv2", torch.cat([off, self._up2(L2_off) * 2], 1)))
        L1_off = lr(c(f"{a}.L1_offset_conv3", off))
        L1 = self._dcn(f"{a}.L1_dcnpack", nbr[0], L1_off)
        L1 = c(f"{a}.L1_fea_conv", torch.cat([L1, self._up2(L2)], 1))
        off = lr(c(f"{a}.cas_offset_conv1", torch.cat([L1, ref[0]], 1)))
        off = lr(c(f"{a}.cas_offset_conv2", off))
        return lr(self._dcn(f"{a}.cas_dcnpack", L1, off))

    @staticmethod
    def _pools(x):
        return torch.cat([F.max_pool2d(x, 3, 2, 1),
                          F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)], dim=1)

    def _tsa(self, aligned):
        c, lr, t = self._conv, leaky_relu, "tsa_fusion"
        B, N, C, H, W = aligned.shape
        emb_ref = c(f"{t}.tAtt_2", aligned[:, self.center])
        emb = c(f"{t}.tAtt_1", aligned.reshape(B * N, C, H, W)).reshape(B, N, C, H, W)
        prob = torch.sigmoid((emb * emb_ref[:, None]).sum(2, keepdim=True))
        merged = (aligned * prob).reshape(B, N * C, H, W)
        fea = lr(c(f"{t}.fea_fusion", merged))
        att = lr(c(f"{t}.sAtt_1", merged))
        att = lr(c(f"{t}.sAtt_2", self._pools(att)))
        att_L = lr(c(f"{t}.sAtt_L1", att))
        att_L = lr(c(f"{t}.sAtt_L2", self._pools(att_L)))
        att_L = self._up2(lr(c(f"{t}.sAtt_L3", att_L)))
        att = lr(c(f"{t}.sAtt_3", att)) + att_L
        att = bilinear(lr(c(f"{t}.sAtt_4", att)), (H, W))
        att = c(f"{t}.sAtt_5", att)
        att_add = c(f"{t}.sAtt_add_2", lr(c(f"{t}.sAtt_add_1", att)))
        return fea * torch.sigmoid(att) * 2 + att_add

    def forward(self, lr_imgs):
        B, N, H, W, C = lr_imgs.shape
        if H % 4 or W % 4:
            raise ValueError("the reference takes frames whose sides are multiples of 4")
        c, lr = self._conv, leaky_relu
        frames = lr_imgs.permute(0, 1, 4, 2, 3).reshape(B * N, C, H, W)
        L1 = lr(c("conv_first", frames))
        for i in range(self.front):
            L1 = self._rb(f"feature_extraction.{i}", L1)
        L2 = lr(c("fea_L2_conv2", lr(c("fea_L2_conv1", L1, stride=2))))
        L3 = lr(c("fea_L3_conv2", lr(c("fea_L3_conv1", L2, stride=2))))
        L1, L2, L3 = (t.reshape(B, N, *t.shape[1:]) for t in (L1, L2, L3))
        k = self.center
        ref = [L1[:, k], L2[:, k], L3[:, k]]
        aligned = torch.stack([self._pcd([L1[:, i], L2[:, i], L3[:, i]], ref)
                               for i in range(N)], dim=1)
        out = self._tsa(aligned)
        for i in range(self.back):
            out = self._rb(f"recon_trunk.{i}", out)
        out = lr(F.pixel_shuffle(c("upconv1", out), 2))
        out = lr(F.pixel_shuffle(c("upconv2", out), 2))
        out = c("conv_last", lr(c("HRconv", out)))
        base = bilinear(lr_imgs[:, k].permute(0, 3, 1, 2), (4 * H, 4 * W))
        return (out + base).permute(0, 2, 3, 1)


def charbonnier(out, target, eps: float):
    """The mean of ``sqrt((out − target)² + eps)``."""
    return torch.mean(torch.sqrt(torch.square(out - target) + eps))


NET = EDVR


def loss(net: EDVR, batch: dict, cfg: dict):
    """The training step's Charbonnier loss on a batch of device tensors."""
    eps = float(cfg["losses"][0]["kwargs"]["epsilon"])
    return charbonnier(net.forward(batch["lr_imgs"]), batch["hr_img"], eps)


def item_frames(t: int, T: int, kwargs: dict) -> tuple[list, list]:
    """Frames of a training item centred on frame ``t``: the window of
    ``num_frames`` around it (the extra frame after), circular, and the
    HR frame t."""
    n = int(kwargs["num_frames"])
    first = t - (n - 1) // 2
    return [(first + j) % T for j in range(n)], [t]
