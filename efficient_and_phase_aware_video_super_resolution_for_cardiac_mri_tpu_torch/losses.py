"""Loss functions (PyTorch).

The port's counterpart of the JAX package's ``losses.py``: L1, MSE,
SmoothL1, the reference's custom losses (Huber, Charbonnier, Flow), and the
torch builtins the reference resolves by name (``src/main.py:62-70``) that
take ``(output, target)``, with the JAX package's formulas.  Each loss is a
callable whose class name is its log key.  ``dim`` reduces a mean over the
given axes only, so a predictor takes per-frame values in one call; a
``reduction: sum`` loss sums over them instead.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import LOSSES


def _mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    return x.mean() if dim is None else x.mean(dim=dim)


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
        return _mean(torch.abs(output - target), dim)


@LOSSES.register()
class MSELoss(Loss):
    def __call__(self, output, target, dim=None):
        return _mean(torch.square(output - target), dim)


@LOSSES.register()
class SmoothL1Loss(Loss):
    """torch.nn.SmoothL1Loss (beta=1)."""

    def __init__(self, beta: float = 1.0):
        self.beta = beta

    def __call__(self, output, target, dim=None):
        diff = torch.abs(output - target)
        return _mean(torch.where(diff < self.beta, 0.5 * diff * diff / self.beta,
                                 diff - 0.5 * self.beta), dim)


@LOSSES.register()
class HuberLoss(Loss):
    """Reference ``src/model/losses.py:5-20`` (DUF's loss)."""

    def __init__(self, delta: float):
        self.delta = delta

    def __call__(self, output, target, dim=None):
        abs_error = torch.abs(output - target)
        quadratic = torch.clamp(abs_error, max=self.delta)
        linear = abs_error - quadratic
        return _mean(0.5 * quadratic**2 + self.delta * linear, dim)


@LOSSES.register()
class CharbonnierLoss(Loss):
    """Reference ``src/model/losses.py:23-34`` (EDVR's loss)."""

    def __init__(self, epsilon: float):
        self.epsilon = epsilon

    def __call__(self, output, target, dim=None):
        return _mean(torch.sqrt(torch.square(output - target) + self.epsilon), dim)


@LOSSES.register()
class FlowLoss(MSELoss):
    """MSE under a distinct log key for FRVSR's flow branch
    (reference ``src/model/losses.py:37-44``)."""


# --- the remaining torch.nn builtins resolvable by name ----------------------
#
# Every ``torch.nn`` loss the reference could name whose call is
# ``(output, target)``, at torch's default constructor arguments, with
# reduction 'mean' or 'sum'.


class _TorchLoss(Loss):
    def __init__(self, reduction: str = "mean"):
        if reduction not in ("mean", "sum"):
            raise ValueError(f"reduction must be 'mean' or 'sum', got {reduction!r}")
        self.reduction = reduction

    def _reduce(self, pointwise, dim=None):
        if self.reduction == "mean":
            return _mean(pointwise, dim)
        return pointwise.sum() if dim is None else pointwise.sum(dim=dim)


@LOSSES.register()
class BCELoss(_TorchLoss):
    """torch.nn.BCELoss: log terms clamped to >= -100 like torch."""

    def __call__(self, output, target, dim=None):
        log_o = torch.clamp(torch.log(output), min=-100.0)
        log_1mo = torch.clamp(torch.log1p(-output), min=-100.0)
        return self._reduce(-(target * log_o + (1.0 - target) * log_1mo), dim)


@LOSSES.register()
class BCEWithLogitsLoss(_TorchLoss):
    """torch.nn.BCEWithLogitsLoss (numerically stable log-sum-exp form)."""

    def __call__(self, output, target, dim=None):
        return self._reduce(torch.clamp(output, min=0.0) - output * target
                            + torch.log1p(torch.exp(-torch.abs(output))), dim)


@LOSSES.register()
class KLDivLoss(_TorchLoss):
    """torch.nn.KLDivLoss: ``output`` is log-probabilities; 0*log(0) := 0."""

    def __call__(self, output, target, dim=None):
        return self._reduce(torch.xlogy(target, target) - target * output, dim)


@LOSSES.register()
class NLLLoss(_TorchLoss):
    """torch.nn.NLLLoss: output (B, C, *) log-probs, target (B, *) indices;
    ``dim`` counts the axes of the target."""

    def __call__(self, output, target, dim=None):
        picked = torch.gather(output, 1, target[:, None].long())[:, 0]
        return self._reduce(-picked, dim)


@LOSSES.register()
class CrossEntropyLoss(NLLLoss):
    """torch.nn.CrossEntropyLoss: log-softmax over axis 1 + NLL, with integer
    class-index targets (B, *) or probability targets shaped like the
    output."""

    def __call__(self, output, target, dim=None):
        log_p = F.log_softmax(output, dim=1)
        if not torch.is_floating_point(target):
            return super().__call__(log_p, target, dim)
        return self._reduce(-torch.sum(target * log_p, dim=1), dim)


@LOSSES.register()
class PoissonNLLLoss(_TorchLoss):
    """torch.nn.PoissonNLLLoss at defaults (log_input=True, full=False)."""

    def __init__(self, log_input: bool = True, full: bool = False, eps: float = 1e-8,
                 reduction: str = "mean"):
        super().__init__(reduction)
        self.log_input, self.full, self.eps = log_input, full, eps

    def __call__(self, output, target, dim=None):
        if self.log_input:
            pointwise = torch.exp(output) - target * output
        else:
            pointwise = output - target * torch.log(output + self.eps)
        if self.full:
            # Stirling approximation term for target > 1, as torch documents
            stirling = target * torch.log(target) - target + 0.5 * torch.log(
                2.0 * math.pi * target)
            pointwise = pointwise + torch.where(target > 1, stirling, torch.zeros_like(stirling))
        return self._reduce(pointwise, dim)


@LOSSES.register()
class SoftMarginLoss(_TorchLoss):
    """torch.nn.SoftMarginLoss: mean log(1 + exp(-y*x))."""

    def __call__(self, output, target, dim=None):
        return self._reduce(torch.log1p(torch.exp(-target * output)), dim)


@LOSSES.register()
class HingeEmbeddingLoss(_TorchLoss):
    """torch.nn.HingeEmbeddingLoss (margin=1): x where y==1, relu(m-x) where y==-1."""

    def __init__(self, margin: float = 1.0, reduction: str = "mean"):
        super().__init__(reduction)
        self.margin = margin

    def __call__(self, output, target, dim=None):
        return self._reduce(torch.where(target == 1, output,
                                        torch.clamp(self.margin - output, min=0.0)), dim)
