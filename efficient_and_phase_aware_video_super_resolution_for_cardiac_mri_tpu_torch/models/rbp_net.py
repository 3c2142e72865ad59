"""RBPN: recurrent back-projection MISR (reference ``src/model/nets/rbp_net.py``), PyTorch.

For each neighbour frame, a DBPN up/down back-projection trunk refines the
reference frame's features (h0) while a residual chain projects the
[reference ‖ neighbour] pair's features (h1); the error feedback is
``h = h0 + res_feat2(h0 − h1)``, and ``res_feat3`` projects h back to LR as
the next trunk input.  The per-neighbour states meet in the output conv.
PReLU starts at torch's default 0.25 here (0.2 elsewhere in the
reference).  Channels-last at the boundary, (B, T, h, w, C) →
(B, rh, rw, C), NCHW inside.  The module tree gives the reference's
``state_dict`` keys (the JAX package's ``utils/torch_import.rbp_net_key_map``);
each ``res_feat{1,2,3}`` is a sequential of ``num_resblocks`` residual
blocks, then its projection block.

Under a spatial axis (``parallel/halo.py``) every conv with a window in H
exchanges its halo: the 3×3 convs one row, the down-projections (stride r,
``PROJ_PARAMS``) 2 HR rows above and below, the up-projections
(transposed, stride r) one LR row.  The 1×1 convs are row-local.  The
skipped last ``res_feat3`` depends on the neighbour's index only, so
every rank issues the same exchanges.
"""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.halo import HaloConv2d, HaloConvTranspose2d
from .common import PROJ_PARAMS, PReLU, conv2d, conv_transpose2d, to_conv_layout


class ConvBlock(nn.Module):
    """conv + optional PReLU (reference ``rbp_net.py:142-174``, norm unused)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, pad: int,
                 generator: torch.Generator, act: bool = True):
        super().__init__()
        self.conv = conv2d(in_ch, out_ch, kernel, generator, stride=stride, padding=pad,
                           cls=HaloConv2d)
        self.act = PReLU(0.25) if act else None

    def forward(self, x):
        x = self.conv(x)
        return x if self.act is None else self.act(x)


class DeconvBlock(nn.Module):
    """transposed conv + PReLU (reference ``rbp_net.py:177-209``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, pad: int,
                 generator: torch.Generator):
        super().__init__()
        self.deconv = conv_transpose2d(in_ch, out_ch, kernel, stride, pad, generator,
                                       cls=HaloConvTranspose2d)
        self.act = PReLU(0.25)

    def forward(self, x):
        return self.act(self.deconv(x))


class ResnetBlock(nn.Module):
    """conv-act-conv + skip, then act (reference ``rbp_net.py:212-257``):
    ONE PReLU, applied twice."""

    def __init__(self, features: int, generator: torch.Generator):
        super().__init__()
        self.conv1 = conv2d(features, features, 3, generator, cls=HaloConv2d)
        self.conv2 = conv2d(features, features, 3, generator, cls=HaloConv2d)
        self.act = PReLU(0.25)

    def forward(self, x):
        out = self.conv2(self.act(self.conv1(x)))
        return self.act(out + x)


class UpBlock(nn.Module):
    """DBPN up-projection (reference ``rbp_net.py:260-271``)."""

    def __init__(self, features: int, kernel: int, stride: int, pad: int,
                 generator: torch.Generator):
        super().__init__()
        args = (features, features, kernel, stride, pad, generator)
        self.up_conv1 = DeconvBlock(*args)
        self.up_conv2 = ConvBlock(*args)
        self.up_conv3 = DeconvBlock(*args)

    def forward(self, x):
        h0 = self.up_conv1(x)
        l0 = self.up_conv2(h0)
        return self.up_conv3(l0 - x) + h0


class DownBlock(nn.Module):
    """DBPN down-projection (reference ``rbp_net.py:274-285``)."""

    def __init__(self, features: int, kernel: int, stride: int, pad: int,
                 generator: torch.Generator):
        super().__init__()
        args = (features, features, kernel, stride, pad, generator)
        self.down_conv1 = ConvBlock(*args)
        self.down_conv2 = DeconvBlock(*args)
        self.down_conv3 = ConvBlock(*args)

    def forward(self, x):
        l0 = self.down_conv1(x)
        h0 = self.down_conv2(l0)
        return self.down_conv3(h0 - x) + l0


class DBPNet(nn.Module):
    """The 3-stage DBPN trunk (reference ``rbp_net.py:94-139``)."""

    def __init__(self, base_filter: int, feat: int, num_stages: int, upscale_factor: int,
                 generator: torch.Generator):
        super().__init__()
        proj = (*PROJ_PARAMS[upscale_factor], generator)
        self.feat1 = ConvBlock(base_filter, feat, 1, 1, 0, generator)
        self.up1 = UpBlock(feat, *proj)
        self.down1 = DownBlock(feat, *proj)
        self.up2 = UpBlock(feat, *proj)
        self.down2 = DownBlock(feat, *proj)
        self.up3 = UpBlock(feat, *proj)
        self.output = ConvBlock(num_stages * feat, feat, 1, 1, 0, generator, act=False)

    def forward(self, x):
        x = self.feat1(x)
        h1 = self.up1(x)
        h2 = self.up2(self.down1(h1))
        h3 = self.up3(self.down2(h2))
        return self.output(torch.cat([h3, h2, h1], dim=1))


def _res_chain(n_blocks: int, width: int, tail: nn.Module, generator: torch.Generator):
    """``n_blocks`` residual blocks, then the projection ``tail``
    (reference ``rbp_net.py:34-50``, ``res_feat{1,2,3}``)."""
    return nn.Sequential(*[ResnetBlock(width, generator) for _ in range(n_blocks)], tail)


class RBPNet(nn.Module):
    """Reference ``rbp_net.py:8-91``: (B, T, h, w, C) → (B, rh, rw, C)."""

    #: every conv takes a halo (``parallel/halo.shard_spatially``)
    spatial_ready = True

    def __init__(self, in_channels: int, out_channels: int, base_filter: int, feat: int,
                 num_stages: int, num_resblocks: int, num_frames: int, upscale_factor: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        if upscale_factor not in PROJ_PARAMS:
            raise ValueError(f"The upscale factor should be 2, 3, 4 or 8. Got {upscale_factor}.")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        g = generator
        self.num_frames = num_frames
        k, s, p = PROJ_PARAMS[upscale_factor]
        BF, F_, n = base_filter, feat, num_resblocks
        self.feat0 = ConvBlock(in_channels, BF, 3, 1, 1, g)
        self.feat1 = ConvBlock(in_channels * 2, BF, 3, 1, 1, g)
        self.dbp_net = DBPNet(BF, F_, num_stages, upscale_factor, g)
        self.res_feat1 = _res_chain(n, BF, DeconvBlock(BF, F_, k, s, p, g), g)
        self.res_feat2 = _res_chain(n, F_, ConvBlock(F_, F_, 3, 1, 1, g), g)
        self.res_feat3 = _res_chain(n, F_, ConvBlock(F_, BF, k, s, p, g), g)
        self.output = ConvBlock((num_frames - 1) * F_, out_channels, 3, 1, 1, g, act=False)

    def forward(self, lr_imgs: torch.Tensor) -> torch.Tensor:
        T = self.num_frames
        t = T // 2 if T % 2 == 1 else T // 2 - 1
        x = to_conv_layout(lr_imgs[:, t])
        neighbors = [to_conv_layout(lr_imgs[:, j]) for j in range(T) if j != t]

        feat_input = self.feat0(x)
        feat_frames = [self.feat1(torch.cat([x, nbr], dim=1)) for nbr in neighbors]
        states = []
        for j, feat_frame in enumerate(feat_frames):
            if j:  # the last state's projection would feed nothing
                feat_input = self.res_feat3(states[-1])
            h0 = self.dbp_net(feat_input)
            h1 = self.res_feat1(feat_frame)
            states.append(h0 + self.res_feat2(h0 - h1))
        return self.output(torch.cat(states, dim=1)).permute(0, 2, 3, 1)
