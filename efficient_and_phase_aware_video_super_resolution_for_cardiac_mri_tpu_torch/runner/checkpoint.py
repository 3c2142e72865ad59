"""Checkpoints: the trainer's save and resume, and the weights both engines load.

The port writes a torch zip ``.pth`` in the reference's layout
(``base_trainer.py:224-252``)::

    {'net': state_dict, 'optimizer': ..., 'lr_scheduler': ..., 'monitor': ...,
     'epoch': int, 'seed_state': {...}}

``net`` has the reference's keys, so the JAX package's
``load_net_variables(path, "RefineNet")`` reads the file as it reads a
reference checkpoint; every other entry is plain values and tensors, so the
port reads it back with ``torch.load(weights_only=True)``.  Files keep the
reference's ``model_{epoch}.pth`` / ``model_best.pth`` names.

It also reads the JAX package's pickle checkpoint (its
``runner/checkpoint.py`` ``save_checkpoint``): ``payload['net']`` is a flax
param tree of numpy arrays, carried over by ``utils/jax_weights.py``.  That
pickle also holds the optimizer state (optax namedtuples) and a ``SeedState``
dataclass of the JAX package; a plain ``pickle.load`` would import optax,
jax and the JAX package to rebuild them.  The unpickler here admits numpy
and builtins only and turns every other class into an inert stub, so reading
the weights imports nothing of JAX.  Resuming from such a file restores the
net only.
"""
from __future__ import annotations

import os
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


def save_checkpoint(path, *, net_state: dict, optimizer_state=None, lr_scheduler_state=None,
                    monitor_state=None, epoch=None, seed_state=None) -> None:
    """Write the checkpoint to a temporary file, then rename it into place,
    so a crash mid-write never leaves a truncated file for
    :func:`find_latest_checkpoint` to pick."""
    payload = {
        "net": {k: v.detach().cpu() for k, v in net_state.items()},
        "optimizer": optimizer_state,
        "lr_scheduler": lr_scheduler_state,
        "monitor": monitor_state,
        "epoch": epoch,
        "seed_state": seed_state,
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path) -> dict:
    """The checkpoint as a dict.  A port ``.pth`` comes back whole; a JAX
    package pickle as ``{'net': state_dict}`` only."""
    path = Path(path)
    if _is_torch_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        payload = _WeightsUnpickler(f).load()
    return {"net": state_dict_from_jax_params(payload["net"])}


def load_net_state_dict(path) -> dict[str, torch.Tensor]:
    """The net's state_dict from a ``.pth`` zip or a JAX pickle checkpoint."""
    return load_checkpoint(path)["net"]


def _peek_epoch(p: Path):
    """Stored epoch of a checkpoint; None if unreadable or not stored."""
    try:
        return load_checkpoint(p).get("epoch")
    except (OSError, EOFError, RuntimeError, KeyError, pickle.UnpicklingError):
        return None


def find_latest_checkpoint(checkpoints_dir) -> Path | None:
    """Newest checkpoint for auto-resume (``loaded_path: 'auto'``): the
    highest-epoch ``model_{N}.pth``, unless the SIGTERM
    ``model_preempted.pth`` records an equal or later epoch (it is written
    after any periodic save and can be up to saved_freq−1 epochs ahead;
    epoch numbers, not mtimes, order checkpoints).  Falls back to
    ``model_best.pth``."""
    d = Path(checkpoints_dir)
    if not d.is_dir():
        return None
    numbered = []
    for p in d.glob("model_*.pth"):
        stem = p.name[len("model_"):-len(".pth")]
        if stem.isdigit() and p.is_file():
            numbered.append((int(stem), p))
    newest_epoch, newest = max(numbered) if numbered else (None, None)
    preempted = d / "model_preempted.pth"
    if preempted.is_file():
        pre_epoch = _peek_epoch(preempted)
        if newest is None or (pre_epoch is not None and pre_epoch >= newest_epoch):
            return preempted
    if newest is not None:
        return newest
    best = d / "model_best.pth"
    return best if best.is_file() else None
