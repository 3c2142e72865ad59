"""Shared model building blocks (NCHW inside, PyTorch idiom).

The port's counterpart of the JAX package's ``models/common.py``: the
in-block (conv3×3 + PReLU), the conv + PixelShuffle upsampler, the
one-parameter PReLU, and folding time into the batch axis for per-frame
blocks.  Module names give the reference's ``state_dict`` keys.

Initialisation is torch's ``nn.Conv2d`` default, ``U(-1/√fan_in, 1/√fan_in)``
on weight and bias with ``fan_in = C_in·kh·kw`` (what the JAX package's
``ops/torch_init.py`` mimics), drawn from an explicit ``torch.Generator``.
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
           generator: torch.Generator) -> nn.Conv2d:
    """``nn.Conv2d`` with 'same' padding for odd kernels and torch-default
    init drawn from ``generator``."""
    conv = nn.Conv2d(in_features, features, kernel_size, padding=kernel_size // 2)
    fan_in = in_features * kernel_size * kernel_size
    init_uniform_(conv.weight, fan_in, generator)
    init_uniform_(conv.bias, fan_in, generator)
    return conv


class PReLU(nn.Module):
    """Single-parameter PReLU, init 0.2 (the reference's
    ``nn.PReLU(num_parameters=1, init=0.2)``)."""

    def __init__(self, init: float = 0.2):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init))

    def forward(self, x):
        return F.prelu(x, self.weight)


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
    (reference ``refine_net.py:194-205``)."""

    def __init__(self, features: int, out_features: int, upscale_factor: int,
                 generator: torch.Generator):
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
        setattr(self, f"conv{n + 1}", conv2d(features, out_features, 3, generator))

    def forward(self, x):
        for i, r in enumerate(self.shuffles):
            x = F.pixel_shuffle(getattr(self, f"conv{i + 1}")(x), r)
        return getattr(self, f"conv{len(self.shuffles) + 1}")(x)
