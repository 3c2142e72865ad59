"""Load net weights from either kind of checkpoint this system writes.

* A reference / PyTorch ``.pth`` zip holding ``{'net': state_dict}``, read
  with ``torch.load(weights_only=True)``.
* The JAX package's pickle checkpoint (its ``runner/checkpoint.py``
  ``save_checkpoint``): ``payload['net']`` is a flax param tree of numpy
  arrays, carried over by ``utils/jax_weights.py``.

That pickle also holds the optimizer state (optax namedtuples) and a
``SeedState`` dataclass of the JAX package; a plain ``pickle.load`` would
import optax, jax and the JAX package to rebuild them.  The unpickler here
admits numpy and builtins only and turns every other class into an inert
stub, so reading the weights imports nothing of JAX.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import torch

from ..utils.jax_weights import state_dict_from_jax_params

_ADMITTED_ROOTS = {"numpy", "builtins", "collections", "copyreg", "_codecs"}


class _Stub:
    """Stand-in for a class outside the admitted modules: accepts any
    construction and state, holds nothing."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _WeightsUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _ADMITTED_ROOTS:
            return super().find_class(module, name)
        return type(name, (_Stub,), {"__module__": f"stub:{module}"})


def _is_torch_zipfile(path: Path) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"PK"  # torch>=1.6 zip serialization


def load_net_state_dict(path) -> dict[str, torch.Tensor]:
    """The net's state_dict from a ``.pth`` zip or a JAX pickle checkpoint."""
    path = Path(path)
    if _is_torch_zipfile(path):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return ckpt["net"]
    with open(path, "rb") as f:
        payload = _WeightsUnpickler(f).load()
    return state_dict_from_jax_params(payload["net"])
