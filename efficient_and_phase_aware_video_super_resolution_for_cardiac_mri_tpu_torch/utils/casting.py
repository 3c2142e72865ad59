"""Dtype casting for the runners' ``compute_dtype`` knob.

The port's copy of the JAX package's ``utils/casting.py::cast_floating``,
plus the forward that knob runs: the net on copies of its floating
parameters and buffers in the compute dtype, made inside the autograd graph
so that gradients arrive in fp32 on the fp32 masters (as ``jax.grad``
through ``cast_floating`` does), with its inputs cast likewise and its
outputs cast back to fp32.  Nothing is autocast: every op of the forward
runs in the compute dtype.
"""
from __future__ import annotations

import itertools

import torch
from torch import nn


def cast_floating(tree, dtype: torch.dtype):
    """Cast every floating-point tensor of a tensor, list, tuple or dict to
    ``dtype``; integer tensors and everything else pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree


def resolve_dtype(name: str | None) -> torch.dtype | None:
    """A config's ``compute_dtype`` string (``bfloat16``, ``float32``, …)
    → ``torch.dtype``; ``None`` means the parameters' own dtype."""
    if not name:
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype must name a floating torch dtype, got {name!r}")
    return dtype


def cast_state(net: nn.Module, dtype: torch.dtype | None) -> dict | None:
    """``dtype`` copies of the net's floating parameters and buffers, by
    name (``None`` for ``dtype=None``).  ``Tensor.to`` is differentiable, so
    the fp32 masters receive fp32 gradients through them.  Made once per
    item or step and shared by its forwards (tiles, seam probes,
    microbatches)."""
    if dtype is None:
        return None
    return {name: cast_floating(t, dtype)
            for name, t in itertools.chain(net.named_parameters(), net.named_buffers())}


def forward_in(net: nn.Module, dtype: torch.dtype | None, *inputs, state: dict | None = None):
    """``net(*inputs)`` computed in ``dtype``; outputs come back in fp32.

    ``dtype=None`` is the plain call.  Otherwise the net runs through
    ``torch.func.functional_call`` on ``state`` (:func:`cast_state`, made
    here when not given), with its floating inputs cast to ``dtype``.
    """
    if dtype is None:
        return net(*inputs)
    if state is None:
        state = cast_state(net, dtype)
    outputs = torch.func.functional_call(net, state, cast_floating(tuple(inputs), dtype))
    return cast_floating(outputs, torch.float32)
