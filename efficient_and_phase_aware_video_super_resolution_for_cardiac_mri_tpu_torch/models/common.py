"""Shared model building blocks (NCHW inside, PyTorch idiom).

The port's counterpart of the JAX package's ``models/common.py``: the
conv (odd-kernel 'same' padding, or an explicit stride and padding for the
back-projection blocks), the transposed conv, the in-block (conv3×3 +
PReLU), the conv + PixelShuffle upsampler, the one-parameter PReLU, the
back-projection table, the convs' memory layout by dtype, and folding time
into the batch axis for per-frame blocks.  Module names give the
reference's ``state_dict`` keys.

Initialisation is torch's default, ``U(-1/√fan_in, 1/√fan_in)`` on weight
and bias, with ``fan_in = C_in·kh·kw`` for a conv and ``C_out·kh·kw`` for a
transposed conv (what the JAX package's ``ops/torch_init.py`` and
``ConvTransposeTorch`` mimic), drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def init_uniform_(tensor: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """In place ``U(-1/√fan_in, 1/√fan_in)`` from ``generator``."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return tensor.uniform_(-bound, bound, generator=generator)


def conv2d(in_features: int, features: int, kernel_size: int,
           generator: torch.Generator, stride: int = 1, padding: int | None = None) -> nn.Conv2d:
    """``nn.Conv2d`` with torch-default init drawn from ``generator``;
    ``padding`` defaults to k//2 ('same' for odd kernels) and pads both sides
    of each spatial axis by that much (the strided projections)."""
    conv = nn.Conv2d(in_features, features, kernel_size, stride=stride,
                     padding=kernel_size // 2 if padding is None else padding)
    fan_in = in_features * kernel_size * kernel_size
    init_uniform_(conv.weight, fan_in, generator)
    init_uniform_(conv.bias, fan_in, generator)
    return conv


def conv_transpose2d(in_features: int, features: int, kernel_size: int, stride: int,
                     padding: int, generator: torch.Generator) -> nn.ConvTranspose2d:
    """``nn.ConvTranspose2d(k, s, p)``: out = (in-1)·s − 2p + k.

    The JAX package's ``ConvTransposeTorch`` computes the same map as an
    input-dilated conv that flips its stored (kh, kw, in, out) kernel inside
    its forward, so the stored kernel is this weight (in, out, kh, kw)
    permuted, with no flip.  torch's default init uses
    ``fan_in = out·k²`` (weight dim 1)."""
    deconv = nn.ConvTranspose2d(in_features, features, kernel_size, stride=stride,
                                padding=padding)
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
    """conv3×3 + PReLU (reference ``refine_net.py:188-192``)."""

    def __init__(self, in_features: int, features: int, generator: torch.Generator):
        super().__init__()
        self.conv = conv2d(in_features, features, 3, generator)
        self.prelu = PReLU()

    def forward(self, x):
        return self.prelu(self.conv(x))


class UpsampleBlock(nn.Module):
    """conv(C→C·r²) + PixelShuffle stages for ×{2,3,4,8}, then a final conv
    unless ``final_conv`` is off (reference ``refine_net.py:194-205``,
    ``edsr_net.py:56-67``)."""

    def __init__(self, features: int, out_features: int, upscale_factor: int,
                 generator: torch.Generator, final_conv: bool = True):
        super().__init__()
        r = upscale_factor
        if r in (2, 4, 8):
            n = int(math.log2(r))
            self.shuffles = [2] * n
            for i in range(n):
                setattr(self, f"conv{i + 1}", conv2d(features, 4 * features, 3, generator))
        elif r == 3:
            n = 1
            self.shuffles = [3]
            self.conv1 = conv2d(features, 9 * features, 3, generator)
        else:
            raise ValueError(f"The upscale factor should be 2, 3, 4 or 8. Got {r}.")
        self.final_conv = final_conv
        if final_conv:
            setattr(self, f"conv{n + 1}", conv2d(features, out_features, 3, generator))

    def forward(self, x):
        for i, r in enumerate(self.shuffles):
            x = F.pixel_shuffle(getattr(self, f"conv{i + 1}")(x), r)
        if self.final_conv:
            x = getattr(self, f"conv{len(self.shuffles) + 1}")(x)
        return x
