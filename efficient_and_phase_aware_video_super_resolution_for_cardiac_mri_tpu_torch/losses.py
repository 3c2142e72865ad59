"""Loss functions of the eval path (PyTorch).

The port's counterpart of the JAX package's ``losses.py`` ``Loss`` and
``L1Loss``.  Each loss is a callable whose class name is its log key.
``dim`` reduces over the given axes only, so a predictor takes per-frame
values in one call.
"""
from __future__ import annotations

import torch

from .config import LOSSES


class Loss:
    """Base: a named, mean-reduced elementwise loss."""

    def __call__(self, output, target, dim=None):
        raise NotImplementedError

    @property
    def name(self) -> str:
        return self.__class__.__name__


@LOSSES.register()
class L1Loss(Loss):
    def __call__(self, output, target, dim=None):
        diff = torch.abs(output - target)
        return diff.mean() if dim is None else diff.mean(dim=dim)
