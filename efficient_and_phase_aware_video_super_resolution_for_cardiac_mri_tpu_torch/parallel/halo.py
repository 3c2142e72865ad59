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
  they are ``F.conv2d`` / ``F.conv3d``.  A conv of stride s takes p rows
  from above and k − s − p from below (the larger of the two is
  exchanged): each rank's rows are a multiple of s, so its output band is
  its input band over s (the back-projections' down-projection, k = s +
  2p; EDVR's 3×3/s2/p1 pyramid convs, one row from above).
  :func:`halo_conv_transpose2d` takes the transposed convs whose output
  is s times the input (k − 2p + output_padding = s: the up-projection,
  k = s + 2p, ⌈p/s⌉ rows each side; FRVSR's k 3, s 2, p 1, output padding
  1, whose output rows ``[2r0, 2r1)`` read input rows ``r0 … r1``, one row
  below the band).
  :class:`HaloConv2d`, :class:`HaloConv3d` and
  :class:`HaloConvTranspose2d` are the ``nn`` modules whose forward goes
  through them while they have an axis (same ``state_dict`` keys).
* :func:`halo_rows` attaches ``k`` rows of the frame above and below a
  band for any ``k``: a halo when the neighbours hold them, else rows of
  the gathered frame; past the frame's border zeros, or the edge row
  repeated (``replicate``, a ``border`` warp's padding).
* :func:`gather_frame` puts the whole frame together on every rank with
  a gradient: its backward returns to each rank the sum, over the ranks,
  of the gradients of that rank's rows (a warp or a deformable conv
  whose flow or offsets are unbounded reads any row).  :func:`gather_rows`
  does the same without a gradient (a step's outputs, for the metrics).
* :func:`shard_spatially` gives a net its axis: every module that declares
  a ``spatial_axis`` attribute takes it.  A net whose pad and pyramid ask
  its bands for a multiple of rows declares ``band_misfit`` (TOFlow,
  FRVSR, EDVR), which ``parallel/mesh.spatial_step`` reads.

Every rank of a spatial group runs the same graph, so the halo collectives
come in the same order on every rank, in forward, in backward and in the
recompute of a checkpointed step.  ``EXCHANGES`` counts the halos and
``GATHERS`` the differentiable gathers.
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

#: whole-frame gathers made with a gradient, by direction (forward calls
#: of :func:`gather_frame`, and their backwards)
GATHERS = {"forward": 0, "backward": 0}



@dataclass(frozen=True)
class SpatialAxis:
    """The ranks that hold the rows of one frame."""

    group: object
    size: int
    index: int

    def __deepcopy__(self, memo):
        # a copy of a sharded net (``FRVSRStream``'s cast copy) keeps the
        # axis: a process group is shared, and cannot be copied
        return self


def reset_exchanges() -> None:
    """Zero :data:`EXCHANGES` and :data:`GATHERS`."""
    for counts in (EXCHANGES, GATHERS):
        for key in counts:
            counts[key] = 0


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
    ``x``: H padded from the halo (p rows above, k − s − p below), W with
    zeros.  The rank's rows must be a multiple of the stride, so that its
    output band is its input band over s."""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    if axis is None:
        return F.conv2d(x, weight, bias, stride=(sh, sw), padding=(ph, pw))
    kh, rows = weight.shape[-2], x.shape[-2]
    above, below = ph, kh - sh - ph
    if rows % sh:
        raise ValueError(f"a conv (k {kh}, stride {sh}, padding {ph}) does not map a band of "
                         f"{rows} rows onto a band of its output")
    k = max(above, below, 0)
    xh = halo(x, k, axis) if k else x
    if above != below:  # the rows the band's outputs read, no more
        xh = xh[..., k - above:k + rows + below, :]
    return F.conv2d(xh, weight, bias, stride=(sh, sw), padding=(0, pw))


def halo_conv_transpose2d(x, weight, bias=None, stride=1, padding=0,
                          axis: SpatialAxis | None = None, output_padding=0):
    """``F.conv_transpose2d(x, weight, bias, stride, padding,
    output_padding)`` on a height-sharded ``x`` whose output is s times its
    input in H (k − 2p + output_padding = s): exactly this rank's
    s·H_local rows.  Output rows ``[s·r0, s·r1)`` read input rows from
    r0 − ⌊(k − 1 − p)/s⌋ to r1 − 1 + ⌊(s − 1 + p)/s⌋, so m, the larger of
    the two, halo rows each side, and H padded by p + m·s (a transposed
    conv's padding crops its output) keep those rows: ⌈p/s⌉ for k = s + 2p,
    one row below for FRVSR's k 3, s 2, p 1, output padding 1."""
    (sh, sw), (ph, pw), (oh, ow) = _pair(stride), _pair(padding), _pair(output_padding)
    if axis is None:
        return F.conv_transpose2d(x, weight, bias, stride=(sh, sw), padding=(ph, pw),
                                  output_padding=(oh, ow))
    kh = weight.shape[-2]
    if kh - 2 * ph + oh != sh:
        raise ValueError(f"a transposed conv (k {kh}, stride {sh}, padding {ph}, output padding "
                         f"{oh}) does not map a band of rows onto a band of its output")
    m = max((kh - 1 - ph) // sh, (sh - 1 + ph) // sh, 0)
    xh = halo(x, m, axis) if m else x
    return F.conv_transpose2d(xh, weight, bias, stride=(sh, sw), padding=(ph + m * sh, pw),
                              output_padding=(oh, ow))


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
    """``nn.ConvTranspose2d`` whose output is s times its input in H (any
    :func:`halo_conv_transpose2d` takes) that exchanges its H halo while it
    has an axis."""

    spatial_axis: SpatialAxis | None = None

    def forward(self, x, output_size=None):
        if self.spatial_axis is None:
            return super().forward(x, output_size)
        if output_size is not None:
            raise ValueError("a sharded transposed conv takes no output size")
        return halo_conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding,
                                     self.spatial_axis, self.output_padding)


def gather_rows(x: torch.Tensor, axis: SpatialAxis | None, dim: int = -3) -> torch.Tensor:
    """The whole frames of each rank's rows of ``x`` (height at ``dim``;
    channels-last arrays (…, H, W, C) by default), in rank order; no
    gradient flows back."""
    if axis is None:
        return x
    return torch.cat(_all_gather(x.detach(), axis), dim=dim)


class _GatherFrame(torch.autograd.Function):
    """(…, H_local, W) → (…, S·H_local, W) on every rank; the backward sums
    the ranks' gradients of this rank's rows."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        GATHERS["forward"] += 1
        return torch.cat(_all_gather(x, axis), dim=-2).contiguous(memory_format=_layout(x))

    @staticmethod
    def backward(ctx, grad):
        axis = ctx.axis
        GATHERS["backward"] += 1
        rows = grad.shape[-2] // axis.size
        # every rank's gradient of the whole frame, in rank order: this
        # rank's rows of each, summed in that order on every rank
        parts = _all_gather(grad, axis)
        own = slice(axis.index * rows, (axis.index + 1) * rows)
        dx = parts[0][..., own, :].clone(memory_format=_layout(grad))
        for part in parts[1:]:
            dx += part[..., own, :]
        return dx, None


def gather_frame(x: torch.Tensor, axis: SpatialAxis | None) -> torch.Tensor:
    """The whole frame (…, H, W) of each rank's band (…, H_local, W) of
    ``x``, on every rank, with a gradient (:class:`_GatherFrame`)."""
    if axis is None:
        return x
    return _GatherFrame.apply(x, axis)


def halo_rows(x: torch.Tensor, k: int, axis: SpatialAxis, mode: str = "zeros") -> torch.Tensor:
    """``x`` (…, H_local, W) with the ``k`` frame rows above and below it
    attached, for any ``k``: a :func:`halo` when the band can lend one,
    else a slice of the gathered frame (:func:`gather_frame`).  Past the
    frame's border: zero rows, or with ``mode='replicate'`` the frame's
    edge row repeated (``F.pad``'s replicate)."""
    rows, i = x.shape[-2], axis.index
    if k == 0:
        return x
    if k <= rows:
        xh = halo(x, k, axis)
    else:
        frame = gather_frame(x, axis)
        pad = [0, 0, k, k]
        xh = F.pad(frame, pad)[..., i * rows:i * rows + rows + 2 * k, :]
    if mode == "zeros":
        return xh
    if mode != "replicate":
        raise ValueError(f"unknown padding mode {mode!r}")
    # the frame's own edge row in place of the zero rows past its border
    top = rows * i - k  # frame row of xh's first row
    frame_rows = rows * axis.size
    first, last = max(0, -top), min(rows + 2 * k, frame_rows - top)
    if first == 0 and last == rows + 2 * k:
        return xh
    body = xh[..., first:last, :]
    parts = [body[..., :1, :].expand(*body.shape[:-2], first, body.shape[-1]), body,
             body[..., -1:, :].expand(*body.shape[:-2], rows + 2 * k - last, body.shape[-1])]
    return torch.cat(parts, dim=-2)


def set_spatial_axis(net: nn.Module, axis: SpatialAxis | None) -> None:
    """Every module of ``net`` that declares ``spatial_axis`` takes ``axis``
    (None: each rank computes whole frames)."""
    for m in net.modules():
        if hasattr(m, "spatial_axis"):
            m.spatial_axis = axis


def shard_spatially(net: nn.Module, axis: SpatialAxis | None) -> nn.Module:
    """Give ``net`` its spatial axis (:func:`set_spatial_axis`)."""
    set_spatial_axis(net, axis)
    return net
