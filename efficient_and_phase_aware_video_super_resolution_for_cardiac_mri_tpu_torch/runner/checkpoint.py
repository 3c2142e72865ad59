"""Checkpoints: the trainer's save and resume, and the weights both engines load.

The port writes a torch zip ``.pth`` in the reference's layout
(``base_trainer.py:224-252``)::

    {'net': state_dict, 'optimizer': ..., 'lr_scheduler': ..., 'monitor': ...,
     'epoch': int, 'seed_state': {...}}

``net`` has the reference's keys, so the JAX package's
``load_net_variables(path, net_name)`` reads the file as it reads a
reference checkpoint; every other entry is plain values and tensors, so the
port reads it back with ``torch.load(weights_only=True)``.  Files keep the
reference's ``model_{epoch}.pth`` / ``model_best.pth`` names.

It also reads the JAX package's pickle checkpoint (its
``runner/checkpoint.py`` ``save_checkpoint``): ``payload['net']`` is a flax
param tree of numpy arrays and ``payload['model_state']`` the other flax
collections (a BatchNorm net's ``batch_stats``), carried over together by
``utils/jax_weights.py``, so a JAX-trained BatchNorm net serves with its
trained running statistics.  That pickle also holds the optimizer state
(optax namedtuples) and a ``SeedState`` dataclass of the JAX package; a
plain ``pickle.load`` would import optax, jax and the JAX package to rebuild
them.  The unpickler here admits numpy and builtins only and turns every
other class into an inert stub, so reading the weights imports nothing of
JAX.  Resuming from such a file restores the net, the epoch, and the
monitor's and the lr scheduler's state where they are plain values (they
are: dicts of numbers, strings and flags); the optimizer and the seed
state start afresh (ROADMAP queue 1, items 5 and 6).
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


def _read_jax_payload(path: Path) -> dict:
    with open(path, "rb") as f:
        return _WeightsUnpickler(f).load()


def _plain(value) -> bool:
    """Whether ``value`` holds only builtins and numpy values (no stub)."""
    if isinstance(value, dict):
        return all(_plain(k) and _plain(v) for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return all(_plain(v) for v in value)
    return not isinstance(value, _Stub)


def load_checkpoint(path, net: str = "RefineNet") -> dict:
    """The checkpoint as a dict.  A port ``.pth`` comes back whole; a JAX
    package pickle of the net named ``net`` as ``{'net': state_dict,
    'epoch': ...}`` plus its ``monitor`` and ``lr_scheduler`` state where
    those are plain values."""
    path = Path(path)
    if _is_torch_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    payload = _read_jax_payload(path)
    variables = {"params": payload["net"], **(payload.get("model_state") or {})}
    out = {"net": state_dict_from_jax_params(variables, net), "epoch": payload.get("epoch")}
    for key in ("monitor", "lr_scheduler"):
        if payload.get(key) is not None and _plain(payload[key]):
            out[key] = payload[key]
    return out


def load_net_state_dict(path, net: str = "RefineNet") -> dict[str, torch.Tensor]:
    """The state_dict of the net named ``net`` from a ``.pth`` zip or a JAX
    pickle checkpoint."""
    return load_checkpoint(path, net)["net"]


def _peek_epoch(p: Path):
    """Stored epoch of a checkpoint, read without building any net's
    state_dict; None if unreadable or not stored."""
    try:
        if _is_torch_zipfile(p):
            return torch.load(p, map_location="cpu", weights_only=True).get("epoch")
        return _read_jax_payload(p).get("epoch")
    except (OSError, EOFError, RuntimeError, KeyError, AttributeError, pickle.UnpicklingError):
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
