"""Frame-by-frame serving of the causal FRVSR net.

The port's copy of the JAX package's ``runner/streaming.py``.  FRVSR's
recurrence is causal: frame k's SR frame depends on frames <= k through
the carry (previous LR frame, previous SR frame), so it serves exactly one
frame a push, at constant latency, with no clip to assemble, as cine-MRI
frames arrive from a scanner one at a time.  ``FRVSRStream.push(frame_k)``
runs the net's own per-frame step (``FRVSRNet.step``), the one its clip
forward loops over, so it returns frame k of the clip forward.

The flagship RefineNet is bidirectional over the whole cardiac cycle and
has no streaming form.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..models.common import to_conv_layout
from ..models.frvsr_net import FRVSRNet
from ..utils import casting
from . import common


class FRVSRStream:
    """Frame-by-frame FRVSR serving session.

    >>> stream = FRVSRStream(net)
    >>> sr0 = stream.push(lr0)   # (B, h, w, C) -> (B, h*r, w*r, C)
    >>> sr1 = stream.push(lr1)   # carries (lr0, sr0) forward
    >>> stream.reset()           # the next push starts a new sequence

    The first push seeds the carry as the clip forward does: (frame 0,
    zeros).  The stream runs on the net's device.  ``compute_dtype``
    mirrors the predictors' knob: the step runs on a copy of the net in
    that dtype, its carry and inputs cast, its SR frames returned in fp32;
    without it the step reads the net's own weights.  ``aot_cache`` is
    accepted as the predictors accept it (``runner/common.accept_aot_cache``).
    A net with a spatial axis (``parallel/halo.shard_spatially``) streams
    this rank's band of each frame: every rank of the group pushes its
    rows, and the carry keeps them.
    """

    def __init__(self, net: FRVSRNet, compute_dtype=None, aot_cache: str | None = None):
        if not isinstance(net, FRVSRNet):
            raise TypeError(
                f"FRVSRStream serves FRVSRNet (the causal net); got {type(net).__name__}."
            )
        self.compute_dtype = casting.resolve_dtype(compute_dtype)
        common.accept_aot_cache(aot_cache)
        if self.compute_dtype is not None:
            net = copy.deepcopy(net).to(self.compute_dtype)
        self.net = net.eval()
        self.device = next(net.parameters()).device
        self._carry = None

    def reset(self) -> None:
        """Forget the recurrent state; the next push starts a new sequence."""
        self._carry = None

    @torch.inference_mode()
    def push(self, lr_frame) -> torch.Tensor:
        """Feed one LR frame (B, h, w, C), a tensor or an array; returns its
        SR frame (B, h·r, w·r, C) in fp32 on the net's device, not fetched:
        chain pushes and fetch only the frames you consume."""
        frame = (lr_frame if isinstance(lr_frame, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(lr_frame)))
        if frame.dim() != 4:
            raise ValueError(f"push expects one (B, h, w, C) frame; got shape {tuple(frame.shape)}.")
        frame = frame.to(self.device)
        if self.compute_dtype is not None:
            frame = casting.cast_floating(frame, self.compute_dtype)
        x = to_conv_layout(frame)
        if self._carry is None:
            self._carry = self.net.initial_carry(x)
        self._carry, sr, _, _ = self.net.step(self._carry, x)
        return sr.permute(0, 2, 3, 1).float()

    def run(self, lr_frames, lookahead: int = 2):
        """Stream a whole (B, T, h, w, C) sequence, yielding host SR frames
        (numpy), ``lookahead`` pushes in flight before each fetch."""
        pending = []
        for t in range(lr_frames.shape[1]):
            pending.append(self.push(lr_frames[:, t]))
            if len(pending) > max(0, int(lookahead)):
                yield pending.pop(0).cpu().numpy()
        for sr in pending:
            yield sr.cpu().numpy()
