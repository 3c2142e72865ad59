"""Checkpoints: the trainer's save and resume, and the weights both engines load.

The port writes a torch zip ``.pth`` in the reference's layout
(``base_trainer.py:224-252``)::

    {'net': state_dict, 'optimizer': ..., 'lr_scheduler': ..., 'monitor': ...,
     'epoch': int, 'seed_state': {...}}

``net`` has the reference's keys, so the JAX package's
``load_net_variables(path, net_name)`` reads the file as it reads a
reference checkpoint; every other entry is plain values and tensors, so the
port reads it back with ``torch.load(weights_only=True)``.  Files keep the
reference's ``model_{epoch}.pth`` / ``model_best.pth`` names.  This is the
``checkpoint_backend: pickle`` of the trainer (its default); under a mesh
the lead rank alone writes it, a model axis's shards gathered first.

``checkpoint_backend: orbax`` / ``orbax_async`` write a directory of the
same name instead, the JAX package's layout with
``torch.distributed.checkpoint`` in orbax's place: ``meta.pt`` (the lr
scheduler, monitor, epoch and seed state, written by the lead rank up
front) and ``arrays/`` (``net`` and ``optimizer``, each rank writing its
own shards, by ``dcp.save`` or ``dcp.async_save``).  A directory counts as
committed only once ``arrays/.metadata``, which ``dcp`` writes last,
exists: :func:`find_latest_checkpoint` skips a half-written one, as the
JAX package's does (its ``runner/checkpoint.py:250-290``).

It also reads the JAX package's pickle checkpoint (its
``runner/checkpoint.py`` ``save_checkpoint``): ``payload['net']`` is a flax
param tree of numpy arrays and ``payload['model_state']`` the other flax
collections (a BatchNorm net's ``batch_stats``), carried over together by
``utils/jax_weights.py``.  The pickle also holds the optimizer state (optax
namedtuples) and a ``SeedState`` dataclass of the JAX package; a plain
``pickle.load`` would import optax, jax and the JAX package to rebuild
them.  The unpickler here admits numpy and builtins only and turns every
other class into a stub that keeps its constructor arguments and state, so
reading the file imports nothing of JAX.  A resume from it restores the
net, the epoch, the monitor's and the lr scheduler's state, the
``SeedState`` (seed, base seed and the per-epoch numpy seeds), the learning
rate, Adam's moments and count (``ScaleByAdamState(count, mu, nu)``, found
under ``InjectHyperparamsState`` and any chain or ``ApplyIfFiniteState``,
carried through the weights' key and layout map as ``exp_avg``,
``exp_avg_sq`` and ``step``) and the ``apply_if_finite`` counters.  The
JAX package's orbax directories are not read: orbax is a JAX library.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from pathlib import Path

import torch

from ..utils.jax_weights import state_dict_from_jax_params
from ..utils.seeding import SeedState

_ADMITTED_ROOTS = {"numpy", "builtins", "collections", "copyreg", "_codecs"}


class _Stub:
    """Stand-in for a class outside the admitted modules: accepts any
    construction and state and keeps them (``args``, ``state``), so the
    optax namedtuples and the ``SeedState`` dataclass can be read back."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args = args
        obj.state = None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _WeightsUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _ADMITTED_ROOTS:
            return super().find_class(module, name)
        return type(name, (_Stub,), {"__module__": f"stub:{module}"})


def _find(tree, name: str):
    """The first stub of class ``name`` in ``tree`` (stubs' arguments,
    tuples, lists and dict values, depth first), or None."""
    if isinstance(tree, _Stub):
        if type(tree).__name__ == name:
            return tree
        children = tree.args
    elif isinstance(tree, (tuple, list)):
        children = tree
    elif isinstance(tree, dict):
        children = tree.values()
    else:
        return None
    for child in children:
        found = _find(child, name)
        if found is not None:
            return found
    return None


def _jax_optimizer(opt_state, net: str) -> dict | None:
    """What a torch optimizer can take from an optax state: ``lr`` (the
    injected learning rate), ``moments`` (``{name: (exp_avg, exp_avg_sq)}``
    and ``step`` from Adam's ``ScaleByAdamState``) and ``nonfinite``
    (``apply_if_finite``'s [consecutive, total])."""
    if opt_state is None:
        return None
    out: dict = {}
    inject = _find(opt_state, "InjectStatefulHyperparamsState") or _find(
        opt_state, "InjectHyperparamsState")
    if inject is not None:
        hyper = inject.args[1]
        if isinstance(hyper, dict) and "learning_rate" in hyper:
            out["lr"] = float(hyper["learning_rate"])
    adam = _find(opt_state, "ScaleByAdamState")
    if adam is not None:
        count, mu, nu = adam.args
        mu = state_dict_from_jax_params(mu, net)
        nu = state_dict_from_jax_params(nu, net)
        from ..config import NETS

        # a parameter the net never uses has no state in torch
        unused = set(getattr(NETS.get(net), "unused_parameters", ()))
        out["moments"] = {k: (mu[k], nu[k]) for k in mu if k not in unused}
        out["step"] = int(count)
    finite = _find(opt_state, "ApplyIfFiniteState")
    if finite is not None:
        notfinite_count, _, total_notfinite = finite.args[:3]
        out["nonfinite"] = [int(notfinite_count), int(total_notfinite)]
    return out


def _jax_seed_state(seed_state) -> dict | None:
    """The JAX package's ``SeedState`` dataclass as the port's state dict."""
    state = getattr(seed_state, "state", None)
    if not isinstance(state, dict):
        return None
    return SeedState(seed=state["seed"], base_int=int(state["base_int"]),
                     np_random_seeds=[int(s) for s in state.get("np_random_seeds") or []]
                     ).state_dict()


def optimizer_state_from_jax(opt: torch.optim.Optimizer, jax_opt: dict,
                             names: list[str]) -> dict:
    """A state dict for ``opt`` (whose parameters are the net's, in the
    order of ``names``) from :func:`_jax_optimizer`'s reading: Adam's
    moments and step per parameter, the learning rate in every group and
    the guard's counters; without moments the state starts afresh."""
    state = opt.state_dict()
    state["state"] = {}
    moments = jax_opt.get("moments")
    if moments is not None:
        for index, name in enumerate(names):
            if name in moments:
                # contiguous, as the parameters are: the layout map leaves
                # transposed strides, which a fused kernel does not follow
                exp_avg, exp_avg_sq = (m.clone(memory_format=torch.contiguous_format)
                                       for m in moments[name])
                state["state"][index] = {"step": torch.tensor(float(jax_opt["step"])),
                                         "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}
    if "lr" in jax_opt:
        for group in state["param_groups"]:
            group["lr"] = jax_opt["lr"]
    if "nonfinite" in jax_opt:
        state["nonfinite"] = jax_opt["nonfinite"]
    return state


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
    if path.is_dir():  # the same name written by a directory backend before
        wait_for_async_saves()
        shutil.rmtree(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


#: the in-flight ``dcp.async_save`` futures
_ASYNC_SAVES: list = []


def wait_for_async_saves() -> None:
    """Block until every in-flight asynchronous directory save has
    committed; a no-op when none was issued."""
    while _ASYNC_SAVES:
        _ASYNC_SAVES.pop(0).result()


def save_directory(path, *, arrays: dict, meta: dict, lead: bool = True,
                   asynchronous: bool = False, process_group=None, barrier=None) -> None:
    """The ``orbax`` / ``orbax_async`` backends: ``meta.pt`` by the lead,
    then ``arrays`` (tensors, DTensors or their state dicts) through
    ``torch.distributed.checkpoint`` by every rank.  ``barrier`` (a
    callable) runs after the lead has cleared the directory, before any
    rank writes."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    if process_group is None and dist.is_initialized() and dist.get_world_size() == 1:
        # a run without a mesh in a process that holds a group of one (an
        # NCCL one on the card): dcp's collectives need a CPU backend
        process_group = _solo_host_group()
    # one save in flight: the previous one commits before this one starts
    wait_for_async_saves()
    path = Path(path)
    if path.exists():
        if lead:
            if path.is_dir():
                shutil.rmtree(path)
            else:
                path.unlink()
    if barrier is not None:
        barrier()
    if lead:
        path.mkdir(parents=True, exist_ok=True)
        torch.save(meta, path / "meta.pt")
    target = str((path / "arrays").resolve())
    if asynchronous:
        _ASYNC_SAVES.append(dcp.async_save(arrays, checkpoint_id=target,
                                           process_group=process_group))
    else:
        dcp.save(arrays, checkpoint_id=target, process_group=process_group)


#: (the default group, a gloo group of this one process in it)
_SOLO_HOST_GROUP = (None, None)


def _solo_host_group():
    """A gloo group of this one process, made once per default group."""
    global _SOLO_HOST_GROUP
    import torch.distributed as dist

    if _SOLO_HOST_GROUP[0] is not dist.group.WORLD:
        _SOLO_HOST_GROUP = (dist.group.WORLD, dist.new_group(backend="gloo"))
    return _SOLO_HOST_GROUP[1]


def _read_directory(path: Path) -> dict:
    """A committed directory checkpoint as one dict of full tensors (the
    meta entries, ``net`` and ``optimizer`` as saved, keyed by name)."""
    from torch.distributed.checkpoint.format_utils import dcp_to_torch_save

    wait_for_async_saves()
    if not _is_committed(path):
        raise FileNotFoundError(
            f"{path} is a half-written directory checkpoint (meta.pt present but "
            "arrays/.metadata never committed); use an older checkpoint — "
            "'loaded_path: auto' skips these automatically.")
    payload = torch.load(path / "meta.pt", map_location="cpu", weights_only=True)
    with tempfile.TemporaryDirectory() as tmp:
        full = Path(tmp) / "arrays.pt"
        dcp_to_torch_save(str((path / "arrays").resolve()), str(full))
        payload.update(torch.load(full, map_location="cpu", weights_only=True))
    return payload


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
    """The checkpoint as a dict.  A port ``.pth`` or directory comes back
    whole (a directory's ``optimizer`` keyed by parameter name, as
    ``torch.distributed.checkpoint.state_dict`` gives it); a JAX package
    pickle of the net named ``net`` as ``{'net': state_dict, 'epoch': ...}``
    plus its ``monitor`` and ``lr_scheduler`` state where those are plain
    values, its ``seed_state`` and, under ``optimizer_jax``, what
    :func:`_jax_optimizer` reads of its optax state."""
    path = Path(path)
    if path.is_dir():
        return _read_directory(path)
    if _is_torch_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    payload = _read_jax_payload(path)
    variables = {"params": payload["net"], **(payload.get("model_state") or {})}
    out = {"net": state_dict_from_jax_params(variables, net), "epoch": payload.get("epoch")}
    for key in ("monitor", "lr_scheduler"):
        if payload.get(key) is not None and _plain(payload[key]):
            out[key] = payload[key]
    seed_state = _jax_seed_state(payload.get("seed_state"))
    if seed_state is not None:
        out["seed_state"] = seed_state
    jax_opt = _jax_optimizer(payload.get("optimizer"), net)
    if jax_opt is not None:
        out["optimizer_jax"] = jax_opt
    return out


def load_net_state_dict(path, net: str = "RefineNet") -> dict[str, torch.Tensor]:
    """The state_dict of the net named ``net`` from a ``.pth`` zip or a JAX
    pickle checkpoint."""
    return load_checkpoint(path, net)["net"]


def _is_committed(p: Path) -> bool:
    """A file checkpoint counts when it exists; a directory checkpoint only
    once both ``meta.pt`` and the arrays' ``.metadata`` (written last by
    ``torch.distributed.checkpoint``) exist."""
    if p.is_dir():
        return (p / "meta.pt").is_file() and (p / "arrays" / ".metadata").is_file()
    return p.is_file()


def _peek_epoch(p: Path):
    """Stored epoch of a checkpoint, read without building any net's
    state_dict; None if unreadable or not stored."""
    try:
        if p.is_dir():
            return torch.load(p / "meta.pt", map_location="cpu", weights_only=True).get("epoch")
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
    epoch numbers, not mtimes, order checkpoints).  Half-written directory
    checkpoints are skipped.  Falls back to ``model_best.pth``."""
    d = Path(checkpoints_dir)
    if not d.is_dir():
        return None
    numbered = []
    for p in d.glob("model_*.pth"):
        stem = p.name[len("model_"):-len(".pth")]
        if stem.isdigit() and _is_committed(p):
            numbered.append((int(stem), p))
    newest_epoch, newest = max(numbered) if numbered else (None, None)
    preempted = d / "model_preempted.pth"
    if _is_committed(preempted):
        pre_epoch = _peek_epoch(preempted)
        if newest is None or (pre_epoch is not None and pre_epoch >= newest_epoch):
            return preempted
    if newest is not None:
        return newest
    best = d / "model_best.pth"
    return best if _is_committed(best) else None
