"""The spatial axis: a frame's height sharded over ranks, with a halo exchange.

The JAX package shards the height of its image arrays over a ``spatial``
mesh axis and lets GSPMD insert the halo exchange of every convolution
(its ``parallel/mesh.py``).  PyTorch has no GSPMD, so here the exchange is
written out:

* :class:`SpatialAxis` names the ranks that share one frame (the mesh's
  ``spatial_group``), their count and this rank's place; rank ``i`` holds
  rows ``[i·H/S, (i+1)·H/S)``.
* :func:`halo` returns a tensor (…, H_local, W) with ``k`` rows of each
  neighbour attached above and below.  The top rank's upper halo and the
  bottom rank's lower halo are zeros: the conv's own zero padding at the
  frame's border.  Forward: one ``all_gather`` of every rank's 2·k edge
  rows over the spatial group.  Backward: one ``all_gather`` of every
  rank's two halo gradients, each added to the edge rows it was taken
  from.  Only ``all_gather`` is used, which NCCL and gloo both take on CUDA
  tensors; every element of a gradient has exactly one sender, so nothing
  is reduced and the exchange is exact in any dtype.
* :func:`halo_conv2d` and :func:`halo_conv3d` pad H from the halo and W
  (and T) with zeros, then convolve with no H padding; without an axis
  they are ``F.conv2d`` / ``F.conv3d``.  A conv of stride s (the
  back-projections' down-projection, k = s + 2p) takes p rows each side:
  each rank's rows are a multiple of s, so its output band is its input
  band over s.  :func:`halo_conv_transpose2d` (the
  up-projection, k = s + 2p again) takes ⌈p/s⌉ rows each side and pads H
  by p + ⌈p/s⌉·s, so that its output is exactly s times the rank's rows;
  the zero rows past the border add nothing.  :class:`HaloConv2d`,
  :class:`HaloConv3d` and :class:`HaloConvTranspose2d` are the ``nn``
  modules whose forward goes through them while they have an axis (same
  ``state_dict`` keys).
* :func:`gather_rows` puts whole frames back together (no gradient).
* :func:`shard_spatially` gives a net its axis: every module that declares
  a ``spatial_axis`` attribute takes it.  Only nets that declare
  ``spatial_ready`` are accepted: RefineNet, EDSRNet, SRFBNet,
  DRFSISRNet, DRFNet, Bicubic, DUFNet and RBPNet, in each of which an
  output row reads a bounded band of input rows (the resizes of
  ``ops/resize.py`` take the band of their global matrix).  The warps of
  TOFlowNet and FRVSRNet and EDVRNet's deformable convs read rows an
  unbounded flow or offset points at (ROADMAP item 10c).

Every rank of a spatial group runs the same graph, so the halo collectives
come in the same order on every rank, in forward, in backward and in the
recompute of a checkpointed step.  ``EXCHANGES`` counts them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

#: halo exchanges made, by direction (forward calls of :func:`halo`, and
#: their backwards)
EXCHANGES = {"forward": 0, "backward": 0}

#: the refusal of a net whose output rows read an unbounded band of input rows
NOT_READY = ("the spatial axis is ported for RefineNet, EDSRNet, SRFBNet, DRFSISRNet, DRFNet, "
             "Bicubic, DUFNet and RBPNet; {net} warps or samples rows an unbounded flow or "
             "offset points at, which a fixed halo does not reach (TOFlowNet, FRVSRNet, "
             "EDVRNet: ROADMAP queue 1, item 10c)")


@dataclass(frozen=True)
class SpatialAxis:
    """The ranks that hold the rows of one frame."""

    group: object
    size: int
    index: int


def reset_exchanges() -> None:
    for key in EXCHANGES:
        EXCHANGES[key] = 0


def _layout(x: torch.Tensor) -> torch.memory_format:
    """Channels-last for a 4-D tensor stored so (the bf16 recurrence's
    layout), else contiguous."""
    if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def _all_gather(t: torch.Tensor, axis: SpatialAxis) -> list[torch.Tensor]:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return parts


class _Halo(torch.autograd.Function):
    """(…, H, W) → (…, k + H + k, W): the neighbours' edge rows attached."""

    @staticmethod
    def forward(ctx, x, k, axis):
        ctx.k, ctx.axis = k, axis
        EXCHANGES["forward"] += 1
        parts = _all_gather(torch.cat([x[..., :k, :], x[..., -k:, :]], dim=-2), axis)
        i, zeros = axis.index, x.new_zeros(*x.shape[:-2], k, x.shape[-1])
        above = parts[i - 1][..., k:, :] if i > 0 else zeros  # the bottom rows of the rank above
        below = parts[i + 1][..., :k, :] if i < axis.size - 1 else zeros
        return torch.cat([above, x, below], dim=-2).contiguous(memory_format=_layout(x))

    @staticmethod
    def backward(ctx, grad):
        k, axis = ctx.k, ctx.axis
        EXCHANGES["backward"] += 1
        H = grad.shape[-2] - 2 * k
        # each rank sends back the gradients of the rows it borrowed ...
        parts = _all_gather(torch.cat([grad[..., :k, :], grad[..., k + H:, :]], dim=-2), axis)
        dx = grad[..., k:k + H, :].clone(memory_format=_layout(grad))
        # ... and adds those of the rows it lent: its top rows went to the
        # rank above as that rank's lower halo, its bottom rows below
        i = axis.index
        if i > 0:
            dx[..., :k, :] += parts[i - 1][..., k:, :]
        if i < axis.size - 1:
            dx[..., H - k:, :] += parts[i + 1][..., :k, :]
        return dx, None, None


def halo(x: torch.Tensor, k: int, axis: SpatialAxis) -> torch.Tensor:
    """``x`` (…, H_local, W) with ``k`` rows of each neighbour above and
    below (zeros past the frame's border)."""
    if x.shape[-2] < k:
        raise ValueError(f"a shard of {x.shape[-2]} rows cannot lend a halo of {k}")
    return _Halo.apply(x, k, axis)


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def halo_conv2d(x, weight, bias=None, padding=1, axis: SpatialAxis | None = None, stride=1):
    """``F.conv2d(x, weight, bias, stride, padding)`` on a height-sharded
    ``x``: H padded from the halo (p rows above, k − s − p = p below), W
    with zeros.  The band must map onto the output's: k = s + 2p in H
    (every stride-1 'same' conv; every back-projection) and the rank's rows
    a multiple of the stride."""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    if axis is None:
        return F.conv2d(x, weight, bias, stride=(sh, sw), padding=(ph, pw))
    kh, rows = weight.shape[-2], x.shape[-2]
    if kh != sh + 2 * ph or rows % sh:
        raise ValueError(f"a conv (k {kh}, stride {sh}, padding {ph}) does not map a band of "
                         f"{rows} rows onto a band of its output (needs k = s + 2p)")
    xh = halo(x, ph, axis) if ph else x
    return F.conv2d(xh, weight, bias, stride=(sh, sw), padding=(0, pw))


def halo_conv_transpose2d(x, weight, bias=None, stride=1, padding=0,
                          axis: SpatialAxis | None = None):
    """``F.conv_transpose2d(x, weight, bias, stride, padding)`` on a
    height-sharded ``x`` whose kernel is k = s + 2p in H (the output is s
    times the input): ⌈p/s⌉ halo rows each side, H padded by p + ⌈p/s⌉·s,
    so that the output is exactly this rank's s·H_local rows."""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    if axis is None:
        return F.conv_transpose2d(x, weight, bias, stride=(sh, sw), padding=(ph, pw))
    kh = weight.shape[-2]
    if kh != sh + 2 * ph:
        raise ValueError(f"a transposed conv (k {kh}, stride {sh}, padding {ph}) does not map "
                         "a band of rows onto a band of its output (needs k = s + 2p)")
    k = -(-ph // sh)
    xh = halo(x, k, axis) if k else x
    return F.conv_transpose2d(xh, weight, bias, stride=(sh, sw), padding=(ph + k * sh, pw))


def halo_conv3d(x, weight, bias=None, padding=(0, 1, 1), axis: SpatialAxis | None = None):
    """``F.conv3d`` over (B, C, T, H, W) (stride 1) on a height-sharded
    ``x``: H padded from the halo, T and W with zeros."""
    pt, ph, pw = padding
    if axis is None or ph == 0:
        return F.conv3d(x, weight, bias, padding=(pt, ph, pw))
    return F.conv3d(halo(x, ph, axis), weight, bias, padding=(pt, 0, pw))


class HaloConv2d(nn.Conv2d):
    """``nn.Conv2d`` (zero padding, any stride :func:`halo_conv2d` takes)
    that exchanges its H halo while :func:`shard_spatially` has given it an
    axis."""

    spatial_axis: SpatialAxis | None = None

    def forward(self, x):
        if self.spatial_axis is None:
            return super().forward(x)
        return halo_conv2d(x, self.weight, self.bias, self.padding, self.spatial_axis, self.stride)


class HaloConv3d(nn.Conv3d):
    """``nn.Conv3d`` (stride 1, zero padding) that exchanges its H halo
    while it has an axis."""

    spatial_axis: SpatialAxis | None = None

    def forward(self, x):
        if self.spatial_axis is None:
            return super().forward(x)
        return halo_conv3d(x, self.weight, self.bias, self.padding, self.spatial_axis)


class HaloConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (k = s + 2p in H, no output padding) that
    exchanges its H halo while it has an axis."""

    spatial_axis: SpatialAxis | None = None

    def forward(self, x, output_size=None):
        if self.spatial_axis is None:
            return super().forward(x, output_size)
        if output_size is not None or self.output_padding != (0, 0):
            raise ValueError("a sharded transposed conv takes no output size or padding")
        return halo_conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding,
                                     self.spatial_axis)


def gather_rows(x: torch.Tensor, axis: SpatialAxis | None, dim: int = -3) -> torch.Tensor:
    """The whole frames of each rank's rows of ``x`` (height at ``dim``;
    channels-last arrays (…, H, W, C) by default), in rank order; no
    gradient flows back."""
    if axis is None:
        return x
    return torch.cat(_all_gather(x.detach(), axis), dim=dim)


def set_spatial_axis(net: nn.Module, axis: SpatialAxis | None) -> None:
    """Every module of ``net`` that declares ``spatial_axis`` takes ``axis``
    (None: each rank computes whole frames)."""
    for m in net.modules():
        if hasattr(m, "spatial_axis"):
            m.spatial_axis = axis


def shard_spatially(net: nn.Module, axis: SpatialAxis | None) -> nn.Module:
    """Give ``net`` its spatial axis; a net that does not declare
    ``spatial_ready`` raises ``NotImplementedError`` (item 10c)."""
    if axis is not None and not getattr(net, "spatial_ready", False):
        raise NotImplementedError(f"spatial_parallel={axis.size}: "
                                  + NOT_READY.format(net=type(net).__name__))
    set_spatial_axis(net, axis)
    return net
