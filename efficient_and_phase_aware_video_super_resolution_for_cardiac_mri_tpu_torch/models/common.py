"""Shared model building blocks (NCHW inside, PyTorch idiom).

The port's counterpart of the JAX package's ``models/common.py``: the
conv (odd-kernel 'same' padding, or an explicit stride and padding for the
back-projection blocks), the 3D conv, the transposed conv, the BatchNorm,
the in-block (conv3×3 + PReLU), the conv + PixelShuffle upsampler, the
one-parameter PReLU, the back-projection table, the convs' memory layout by
dtype, padding to a multiple with the tensor's minimum, and folding time
into the batch axis for per-frame blocks.  Module names give the
reference's ``state_dict`` keys.

Initialisation is torch's default, ``U(-1/√fan_in, 1/√fan_in)`` on weight
and bias, with ``fan_in = C_in·kh·kw`` (``C_in·kd·kh·kw`` in 3D) for a conv
and ``C_out·kh·kw`` for a transposed conv (what the JAX package's
``ops/torch_init.py`` and ``ConvTransposeTorch`` mimic), drawn from an
explicit ``torch.Generator``; FRVSR redraws its kernels Xavier-uniform
(``init_xavier_``, the JAX package's ``xavier_conv_init``).  BatchNorm
starts at weight 1, bias 0, running mean 0 and variance 1.

Under a data or spatial mesh the JAX package's BatchNorm reduces over the
global batch (GSPMD), not over each device's slice or rows.  Inside
:func:`batch_norm_group` the port's BatchNorms do the same in training:
each rank's per-channel sum, sum of squares and count go through one
differentiable all-reduce over the group (the ranks holding the step's
other items and rows, ``Mesh.statistics_group``; its backward all-reduces
the gradients of those sums), so the normalisation, the gradients and the
running statistics are the single-device ones.  ``nn.SyncBatchNorm`` is
not used: it refuses CPU tensors.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.halo import HaloConv2d, HaloConv3d, HaloConvTranspose2d, halo_conv2d


def init_uniform_(tensor: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """In place ``U(-1/√fan_in, 1/√fan_in)`` from ``generator``."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return tensor.uniform_(-bound, bound, generator=generator)


def init_xavier_(tensor: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """In place ``nn.init.xavier_uniform_`` (gain 1) from ``generator``:
    ``U(±√(6 / (fan_in + fan_out)))``, the fans of a conv's or a transposed
    conv's weight summing to (C_in + C_out)·kh·kw either way."""
    with torch.no_grad():
        return nn.init.xavier_uniform_(tensor, generator=generator)


class PromotedConv2d(HaloConv2d):
    """``nn.Conv2d`` in the promoted dtype of its input and its parameters,
    as flax's ``nn.Conv`` computes: under ``compute_dtype: bfloat16`` a
    conv fed an fp32 resize product runs in fp32 on bf16-rounded weights.
    Under a spatial axis it exchanges its H halo (:class:`HaloConv2d`)."""

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        x, w, b = x.to(dtype), self.weight.to(dtype), self.bias.to(dtype)
        if self.spatial_axis is None:
            return self._conv_forward(x, w, b)
        return halo_conv2d(x, w, b, self.padding, self.spatial_axis, self.stride)


def conv2d(in_features: int, features: int, kernel_size: int,
           generator: torch.Generator, stride: int = 1, padding: int | None = None,
           cls: type[nn.Conv2d] = nn.Conv2d) -> nn.Conv2d:
    """``nn.Conv2d`` (or its subclass ``cls``) with torch-default init drawn
    from ``generator``; ``padding`` defaults to k//2 ('same' for odd kernels)
    and pads both sides of each spatial axis by that much (the strided
    projections)."""
    conv = cls(in_features, features, kernel_size, stride=stride,
               padding=kernel_size // 2 if padding is None else padding)
    fan_in = in_features * kernel_size * kernel_size
    init_uniform_(conv.weight, fan_in, generator)
    init_uniform_(conv.bias, fan_in, generator)
    return conv


def conv3d(in_features: int, features: int, kernel_size: int | tuple[int, int, int],
           generator: torch.Generator, padding: tuple[int, int, int] | None = None,
           cls: type[nn.Conv3d] = nn.Conv3d) -> nn.Conv3d:
    """``nn.Conv3d`` (or its subclass ``cls``) over (B, C, T, H, W) with
    torch-default init drawn from ``generator`` (``fan_in = C_in·kd·kh·kw``,
    the JAX package's ``duf_net.conv3d``); ``padding`` defaults to k//2 on
    each axis."""
    ks = (kernel_size,) * 3 if isinstance(kernel_size, int) else tuple(kernel_size)
    conv = cls(in_features, features, ks,
               padding=tuple(k // 2 for k in ks) if padding is None else tuple(padding))
    fan_in = in_features * math.prod(ks)
    init_uniform_(conv.weight, fan_in, generator)
    init_uniform_(conv.bias, fan_in, generator)
    return conv


#: the process group a training BatchNorm reduces its statistics over
_BN_GROUP = None


@contextlib.contextmanager
def batch_norm_group(group):
    """Training BatchNorms inside reduce over ``group`` (None: locally)."""
    global _BN_GROUP
    previous, _BN_GROUP = _BN_GROUP, group
    try:
        yield
    finally:
        _BN_GROUP = previous


class _AllReduce(torch.autograd.Function):
    """Sum over ``group``; the gradient is summed over it likewise."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        torch.distributed.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        torch.distributed.all_reduce(grad, group=ctx.group)
        return grad, None


def batch_norm_active() -> bool:
    return _BN_GROUP is not None


def global_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """Training-mode BatchNorm of ``x`` over the global batch of the ranks
    in the active :func:`batch_norm_group`, computed in ``dtype`` (``x``'s
    by default): the biased variance normalises, the unbiased one over the
    global count updates the running variance."""
    dtype = dtype or x.dtype
    x = x.to(dtype)
    dims = [0, *range(2, x.dim())]
    c = x.shape[1]
    count = x.new_full((1,), x.numel() // c)
    stats = _AllReduce.apply(torch.cat([x.sum(dims), (x * x).sum(dims), count]), _BN_GROUP)
    n = stats[-1]
    mean = stats[:c] / n
    var = stats[c:2 * c] / n - mean * mean
    shape = (1, c) + (1,) * (x.dim() - 2)
    y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + bn.eps)
    if bn.affine:
        y = y * bn.weight.to(dtype).view(shape) + bn.bias.to(dtype).view(shape)
    if bn.track_running_stats:
        with torch.no_grad():
            m = bn.momentum
            unbiased = var * (n / (n - 1))
            bn.running_mean.copy_(bn.running_mean.to(dtype) * (1 - m) + mean * m)
            bn.running_var.copy_(bn.running_var.to(dtype) * (1 - m) + unbiased * m)
            bn.num_batches_tracked.add_(1)
    return y


class _GlobalBatchNorm:
    """Mixin: the global-batch path in training inside a group."""

    def forward(self, x):
        if self.training and batch_norm_active():
            return global_batch_norm(self, x)
        return super().forward(x)


class BatchNorm2d(_GlobalBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_GlobalBatchNorm, nn.BatchNorm3d):
    pass


def batch_norm(features: int, dims: int = 2, cls: type[nn.Module] | None = None) -> nn.Module:
    """``nn.BatchNorm2d`` / ``nn.BatchNorm3d`` (or its subclass ``cls``) at
    eps 1e-5 and momentum 0.1.  In training it normalises with the biased
    batch variance and updates the running variance with the unbiased one,
    the semantics the JAX package's ``TorchBatchNorm`` copies; in eval it
    uses the running statistics."""
    cls = cls or {2: BatchNorm2d, 3: BatchNorm3d}[dims]
    return cls(features, eps=1e-5, momentum=0.1)


class _GroupMin(torch.autograd.Function):
    """The minimum of a tensor over the ranks of ``group``; its gradient
    is shared by the elements that hold it on every rank, as
    ``torch.amin``'s and JAX's ``min`` share it among ties."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        wide = torch.promote_types(x.dtype, torch.float32)  # gloo gathers no bf16
        m = _gather_scalars(x.amin().to(wide), group).min()
        ctx.mask = x == m.to(x.dtype)
        ctx.ties = _gather_scalars(ctx.mask.sum().to(wide), group).sum()
        return m.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        total = _gather_scalars(grad.to(ctx.ties.dtype), ctx.group).sum()
        return (ctx.mask * (total / ctx.ties)).to(grad.dtype), None


def _gather_scalars(t: torch.Tensor, group) -> torch.Tensor:
    """A 0-d tensor of every rank of ``group``, (ranks,), by ``all_gather``
    (which gloo takes on CUDA tensors too)."""
    n = torch.distributed.get_world_size(group)
    parts = [torch.empty(1, dtype=t.dtype, device=t.device) for _ in range(n)]
    torch.distributed.all_gather(parts, t.reshape(1).contiguous(), group=group)
    return torch.cat(parts)


def pad_to_multiple(x: torch.Tensor, mult: int, dims=(-3, -2), axis=None):
    """Pad ``dims`` of ``x`` to multiples of ``mult`` with the WHOLE tensor's
    minimum (over batch and frames, as ``jnp.min(x)`` in the JAX package's
    ``pad_to_multiple``, the reference's ``F.pad(value=x.min())``), centred:
    ``diff // 2`` before, the rest after.  Returns ``(padded, crops)``:
    ``crops`` is a tuple of one slice per dimension of ``x`` (a concrete
    one for each of ``dims``) that cuts the input back out, or ``None``
    when nothing was padded here.  The pad value stays on the device and in
    the autograd graph (its gradient reaches the minimum, as through
    ``lax.pad``'s padding value).

    Under a spatial ``axis`` (``parallel/halo.py``) ``dims[0]`` is the
    height, of which ``x`` holds this rank's band: the sizes are the
    frame's, the minimum is the group's (the spatial group's, or in
    training the BatchNorm group's, which holds the step's other rows and
    items), and the rows of the centred pad go to the top and the bottom
    rank, never to a band edge inside the frame.  The bands must stay
    equal: no pad in H, or an even one over 2 ranks."""
    nd = x.dim()
    h = dims[0] % nd
    S, i = (1, 0) if axis is None else (axis.size, axis.index)
    crops = [slice(None)] * nd
    shape = list(x.shape)
    padded_any = False
    for d in dims:
        d %= nd
        size = x.shape[d] * (S if d == h else 1)
        diff = (mult - size % mult) % mult
        before, after = diff // 2, diff - diff // 2
        if d == h and S > 1:
            if diff and (S > 2 or diff % 2):
                raise ValueError(
                    f"a frame of {size} rows padded to a multiple of {mult} over {S} spatial "
                    "ranks would give unequal bands; pick a height that needs no pad (or an "
                    "even one over 2 ranks)")
            before, after = (before if i == 0 else 0), (after if i == S - 1 else 0)
        padded_any = padded_any or diff > 0
        crops[d] = slice(before, before + x.shape[d])
        shape[d] = x.shape[d] + before + after
    if not padded_any:
        return x, None
    if axis is None:
        value = x.amin()
    else:  # every rank of the group takes part, padded here or not
        value = _GroupMin.apply(x, _BN_GROUP if batch_norm_active() else axis.group)
    if shape == list(x.shape):
        return x, None
    padded = value.expand(shape).clone(memory_format=torch.contiguous_format)
    padded[tuple(crops)] = x
    return padded, tuple(crops)


def band_misfit(rows: int, ranks: int, multiple: int, least: int) -> str | None:
    """Why a frame of ``rows`` rows, padded centred to a multiple of
    ``multiple`` (:func:`pad_to_multiple`), does not split over ``ranks``
    spatial ranks into bands of a multiple of ``multiple`` rows and at
    least ``least`` each; None when it does.  The pad's rows go to the top
    and the bottom band, so the pad must be even over 2 ranks and absent
    over more."""
    diff = -rows % multiple
    if rows % ranks or (diff and (ranks > 2 or diff % 2)):
        return (f"{rows} rows padded to a multiple of {multiple} do not split into equal bands "
                f"over {ranks} ranks")
    bands = [rows // ranks] * ranks
    bands[0] += diff // 2
    bands[-1] += diff - diff // 2
    if any(b % multiple or b < least for b in bands):
        return (f"{rows} rows give bands of {bands[0]} rows after the pad, where a band must be "
                f"a multiple of {multiple} and at least {least}")
    return None


def check_band(rows: int, multiple: int, least: int, net: str, axis) -> None:
    """Under a spatial ``axis``: a band of ``rows`` rows (after the net's
    pad) must be a multiple of its pyramid's factor and at least as deep as
    its widest halo.  ``parallel/mesh.spatial_step`` replicates an item
    whose bands would not be (the net's ``band_misfit``), so only a caller
    that gives the net an axis itself reaches this."""
    if axis is not None and (rows % multiple or rows < least):
        raise ValueError(f"{net} on {axis.size} spatial ranks needs bands of a multiple of "
                         f"{multiple} rows and at least {least} after its pad; got {rows}")


def conv_transpose2d(in_features: int, features: int, kernel_size: int, stride: int,
                     padding: int, generator: torch.Generator, output_padding: int = 0,
                     cls: type[nn.ConvTranspose2d] = nn.ConvTranspose2d) -> nn.ConvTranspose2d:
    """``nn.ConvTranspose2d(k, s, p, output_padding)`` (or its subclass
    ``cls``): out = (in-1)·s − 2p + k + output_padding (the extra rows and
    columns at the bottom and right, as the JAX package's
    ``ConvTransposeTorch`` pads them).

    The JAX package's ``ConvTransposeTorch`` computes the same map as an
    input-dilated conv that flips its stored (kh, kw, in, out) kernel inside
    its forward, so the stored kernel is this weight (in, out, kh, kw)
    permuted, with no flip.  torch's default init uses
    ``fan_in = out·k²`` (weight dim 1)."""
    deconv = cls(in_features, features, kernel_size, stride=stride, padding=padding,
                 output_padding=output_padding)
    fan_in = features * kernel_size * kernel_size
    init_uniform_(deconv.weight, fan_in, generator)
    init_uniform_(deconv.bias, fan_in, generator)
    return deconv


#: back-projection (k, stride, pad) per upscale factor, the reference's
#: shared projection table (SRFB and RBPN both hardcode it)
PROJ_PARAMS = {2: (6, 2, 2), 3: (7, 3, 2), 4: (8, 4, 2), 8: (12, 8, 2)}


class PReLU(nn.Module):
    """Single-parameter PReLU, init 0.2 (the reference's
    ``nn.PReLU(num_parameters=1, init=0.2)``)."""

    def __init__(self, init: float = 0.2):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init))

    def forward(self, x):
        return F.prelu(x, self.weight)


def conv_format(dtype: torch.dtype) -> torch.memory_format:
    """The memory layout for cuDNN's convs in ``dtype``: NCHW in fp32, where
    its convs (FFT, or implicit GEMM on the CUDA cores) run NCHW and, fed
    channels-last, transpose input and output around each conv;
    channels-last in bf16 and other half types, the layout of its
    tensor-core convs (``tools/profile_layout.py``, ``tools/profile_sisr.py``
    measure both)."""
    return torch.contiguous_format if dtype == torch.float32 else torch.channels_last


def to_conv_layout(x: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) images → (B, C, h, w) in ``conv_format(x.dtype)``.

    With one channel the permuted view is contiguous both as NCHW and as
    channels-last, and a conv takes such an input as channels-last; the
    copy (one small kernel) makes the layout the chosen one, which every
    later op then keeps."""
    return x.permute(0, 3, 1, 2).clone(memory_format=conv_format(x.dtype))


def fold_time(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
    """(B, T, ...) → (B·T, ...); returns the unfold spec."""
    B, T = x.shape[:2]
    return x.reshape(B * T, *x.shape[2:]), (B, T)


def unfold_time(x: torch.Tensor, spec: tuple[int, int]) -> torch.Tensor:
    B, T = spec
    return x.reshape(B, T, *x.shape[1:])


def per_frame(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a per-frame block to (B, T, C, H, W) with time in the batch."""
    y, spec = fold_time(x)
    return unfold_time(block(y), spec)


class InBlock(nn.Module):
    """conv3×3 + PReLU (reference ``refine_net.py:188-192``); the conv
    exchanges its halo under a spatial axis (``parallel/halo.py``)."""

    def __init__(self, in_features: int, features: int, generator: torch.Generator):
        super().__init__()
        self.conv = conv2d(in_features, features, 3, generator, cls=HaloConv2d)
        self.prelu = PReLU()

    def forward(self, x):
        return self.prelu(self.conv(x))


class UpsampleBlock(nn.Module):
    """conv(C→C·r²) + PixelShuffle stages for ×{2,3,4,8}, then a final conv
    unless ``final_conv`` is off (reference ``refine_net.py:194-205``,
    ``edsr_net.py:56-67``).  The convs exchange their halos under a
    spatial axis; PixelShuffle is row-local, so after a shuffle each rank
    holds r× its rows and the next conv's halo is taken at that scale."""

    def __init__(self, features: int, out_features: int, upscale_factor: int,
                 generator: torch.Generator, final_conv: bool = True):
        super().__init__()
        r = upscale_factor
        if r in (2, 4, 8):
            n = int(math.log2(r))
            self.shuffles = [2] * n
            for i in range(n):
                setattr(self, f"conv{i + 1}",
                        conv2d(features, 4 * features, 3, generator, cls=HaloConv2d))
        elif r == 3:
            n = 1
            self.shuffles = [3]
            self.conv1 = conv2d(features, 9 * features, 3, generator, cls=HaloConv2d)
        else:
            raise ValueError(f"The upscale factor should be 2, 3, 4 or 8. Got {r}.")
        self.final_conv = final_conv
        if final_conv:
            setattr(self, f"conv{n + 1}",
                    conv2d(features, out_features, 3, generator, cls=HaloConv2d))

    def forward(self, x):
        for i, r in enumerate(self.shuffles):
            x = F.pixel_shuffle(getattr(self, f"conv{i + 1}")(x), r)
        if self.final_conv:
            x = getattr(self, f"conv{len(self.shuffles) + 1}")(x)
        return x
