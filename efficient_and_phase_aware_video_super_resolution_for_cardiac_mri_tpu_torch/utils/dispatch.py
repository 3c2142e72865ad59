"""Double-buffered dispatch: finish item k one push behind its dispatch.

The port's copy of the JAX package's ``utils/dispatch.py``.  The eval loops
launch item k+1's forward on the card before they fetch item k's results,
so the next item's host work (loading, normalising, launching) overlaps the
card's compute of the previous item and its device → host copy.  Finish
order is push order, which the exporters rely on (the single-image
predictors assemble a GIF and a NIfTI volume across consecutive items).

On the card, :func:`upload` and :class:`Fetch` keep the two directions of
copy off the stream's critical path: a blocking copy synchronizes the
stream, so fetching item k would wait for item k+1's forward too.  Inputs
go up from pinned memory without blocking; results come down into pinned
memory behind an event recorded after them, and waiting on that event waits
for item k's work alone.

Used by ``runner/predictors.py`` and ``tools/serve.py``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card from pinned memory, without
    blocking."""
    t = torch.from_numpy(x)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class Fetch:
    """Named device tensors on their way to the host (None passes through).
    On the card each is copied into pinned memory without blocking and an
    event is recorded after the copies; ``wait()`` synchronizes on that
    event alone → the same names as numpy arrays."""

    def __init__(self, **tensors):
        self._event = None
        if any(t is not None and t.device.type == "cuda" for t in tensors.values()):
            tensors = {k: None if t is None else t.to("cpu", non_blocking=True)
                       for k, t in tensors.items()}
            self._event = torch.cuda.Event()
            self._event.record()
        self._tensors = tensors

    def wait(self) -> dict:
        if self._event is not None:
            self._event.synchronize()
        return {k: None if t is None else t.numpy() for k, t in self._tensors.items()}


class DoubleBuffer:
    """Hold one item in flight; ``finish`` runs exactly once per pushed item,
    in push order, one push behind (at once when ``eager``)."""

    def __init__(self, finish: Callable, eager: bool = False):
        self._finish = finish
        self._eager = eager
        self._pending = None

    def push(self, item) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._finish(pending)
        if self._eager:
            self._finish(item)
        else:
            self._pending = item

    def drain(self) -> None:
        """Finish the last item in flight (call after the dispatch loop)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._finish(pending)
