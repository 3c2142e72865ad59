"""Plain PyTorch operations of the reference nets, with an operation count.

Every convolution of the reference nets goes through :func:`conv2d` and
every deformable convolution through :func:`deform_conv2d`.  Inside
:func:`counting` each call adds its operations to the counter, a
multiply-add counting 2: the forward product, and where autograd will run
them the two products of its backward (the weight's gradient when the
weight needs one, the input's when the input needs one).  Each count is
the output's size times the products an output element sums, so it grows
linearly with the batch and the frame's area.

Nothing here imports the program under test or JAX.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_COUNT: list[int] | None = None


@contextlib.contextmanager
def counting():
    """Count the operations of the convolutions inside; yields a one-item
    list that holds the total when the block ends."""
    global _COUNT
    previous, _COUNT = _COUNT, [0]
    box = _COUNT
    try:
        yield box
    finally:
        _COUNT = previous


def _add(macs: int, x: torch.Tensor, weight: torch.Tensor) -> None:
    if _COUNT is None:
        return
    n = 1
    if torch.is_grad_enabled():
        n += int(weight.requires_grad) + int(x.requires_grad)
    _COUNT[0] += 2 * macs * n


def conv2d(x, weight, bias=None, stride=1, padding=0):
    """``F.conv2d``, counted: every output element sums Cin·kh·kw products."""
    out = F.conv2d(x, weight, bias, stride=stride, padding=padding)
    _add(out.numel() * weight[0].numel(), x, weight)
    return out


def leaky_relu(x):
    return F.leaky_relu(x, 0.1)


def bilinear(x, size):
    """``F.interpolate(mode='bilinear', align_corners=False)`` of NCHW ``x``."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def _sample_points(offset, H, W, kh, kw, pad, dg):
    """Sampling rows and columns (B, dg, K, H, W) of a stride-1 deformable
    conv: the tap's position plus its offset (channel g·2K + 2·tap the row,
    + 1 the column)."""
    B = offset.shape[0]
    K = kh * kw
    off = offset.reshape(B, dg, K, 2, H, W)
    dev, dt = offset.device, offset.dtype
    ky = torch.arange(kh, device=dev, dtype=dt).repeat_interleave(kw)
    kx = torch.arange(kw, device=dev, dtype=dt).repeat(kh)
    ho = torch.arange(H, device=dev, dtype=dt)
    wo = torch.arange(W, device=dev, dtype=dt)
    py = (ho[None, :, None] - pad + ky[:, None, None]) + off[:, :, :, 0]
    px = (wo[None, None, :] - pad + kx[:, None, None]) + off[:, :, :, 1]
    return py, px


def deformable_im2col(x, offset, mask, kh, kw, pad, dg):
    """The modulated deformable im2col of DCNv2 (stride 1, dilation 1):
    col (B, C·K, H·W), channel c·K + tap, each entry ``mask · bilinear
    sample`` with zero padding; a point outside (-1, H) × (-1, W) samples
    0.  Written from the definition: four gathered corners a point."""
    B, C, H, W = x.shape
    K = kh * kw
    py, px = _sample_points(offset, H, W, kh, kw, pad, dg)
    inside = ((py > -1) & (py < H) & (px > -1) & (px < W)).to(x.dtype)
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0
    planes = x.reshape(B, dg, 1, C // dg, H * W)
    sample = 0
    for dy, dx, wy, wx in ((0, 0, 1 - ly, 1 - lx), (0, 1, 1 - ly, lx),
                           (1, 0, ly, 1 - lx), (1, 1, ly, lx)):
        yy, xx = y0 + dy, x0 + dx
        ok = ((yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)).to(x.dtype)
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()  # (B, dg, K, H, W)
        idx = idx.reshape(B, dg, K, 1, H * W).expand(B, dg, K, C // dg, H * W)
        vals = torch.gather(planes.expand(B, dg, K, C // dg, H * W), 4, idx)
        weight = (wy * wx * ok).reshape(B, dg, K, 1, H * W)
        sample = sample + vals * weight
    m = (inside * mask.reshape(B, dg, K, H, W)).reshape(B, dg, K, 1, H * W)
    col = sample * m  # (B, dg, K, C/dg, HW)
    return col.permute(0, 1, 3, 2, 4).reshape(B, C * K, H * W)


def deform_conv2d(x, offset, mask, weight, bias, pad, dg):
    """Modulated deformable conv: ``weight (Cout, C·K) @ col + bias``,
    counted as the dense conv it contracts."""
    B, C, H, W = x.shape
    cout, _, kh, kw = weight.shape
    col = deformable_im2col(x, offset, mask, kh, kw, pad, dg)
    out = torch.matmul(weight.reshape(cout, -1), col).reshape(B, cout, H, W)
    if bias is not None:
        out = out + bias[None, :, None, None]
    if _COUNT is not None:
        _add(B * cout * H * W * C * kh * kw, col, weight)
    return out
