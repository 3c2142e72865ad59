"""Rank bodies for the port's multi-process tests (``tests/test_torch_parallel*.py``).

``parallel.distributed.spawn`` pickles its target by reference, so the
bodies live in a module the spawned ranks can import without JAX: this
one imports torch, numpy and the port only.  Each body runs on one rank of
a gloo group that ``spawn`` has set up, and returns plain values (rank 0's
come back to the test).
"""
from __future__ import annotations

import numpy as np
import torch

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import (
    losses as PL,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import (
    metrics as PM,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import (
    Dataloader,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import (
    make_mesh,
    mesh as mesh_mod,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.optim import (
    Optimizer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.trainers import (
    MISRTrainer,
    VSRRefineNetTrainer,
)


class ListDataset:
    """In-memory items (channels-last numpy)."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def train_steps(kind: str, net_state: dict, net_kwargs: dict, items: list, batch: int,
                world: int | None, optimizer: tuple = ("Adam", {"lr": 1e-3}),
                model_parallel: int = 1, onednn: bool = True, **trainer_kwargs) -> dict:
    """One epoch over ``items`` (batches of ``batch``, in order) of the
    RefineNet (``kind='refine'``) or DUF (``'duf'``) trainer from the
    weights ``net_state``, under a mesh of ``world`` ranks, ``model_parallel``
    of them a model group (None: no mesh), with oneDNN's convs or without
    them (its bf16 convs keep no fp32 sum) → the epoch's train log, the
    net's state and the data-axis warnings issued."""
    with torch.backends.mkldnn.flags(enabled=onednn):
        return _train_steps(kind, net_state, net_kwargs, items, batch, world, optimizer,
                            model_parallel, **trainer_kwargs)


def _train_steps(kind, net_state, net_kwargs, items, batch, world, optimizer, model_parallel,
                 **trainer_kwargs):
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
        DUFNet,
        RefineNet,
    )

    mesh = make_mesh(world, model_parallel) if world else None
    net_cls, trainer_cls = {"refine": (RefineNet, VSRRefineNetTrainer),
                            "duf": (DUFNet, MISRTrainer)}[kind]
    net = net_cls(**net_kwargs)
    net.load_state_dict(net_state, strict=True)
    loader = Dataloader(ListDataset(items), batch_size=batch, shuffle=False)
    name, kwargs = optimizer
    trainer = trainer_cls(
        device="cpu", train_dataloader=loader, valid_dataloader=loader, net=net,
        loss_fns=[PL.L1Loss() if kind == "refine" else PL.MSELoss()], loss_weights=[1.0],
        metric_fns=[PM.PSNR()], optimizer=Optimizer(name, **kwargs), num_epochs=1,
        mesh=mesh, telemetry=False, **trainer_kwargs)
    mesh_mod._WARNED.clear()
    log, _, _ = trainer._run_epoch("training")
    state = trainer._full_state()[0]  # whole, under a model axis
    return {"log": log, "state": {k: v.detach().clone() for k, v in state.items()},
            "warned": sorted(k[0] for k in mesh_mod._WARNED),
            "mesh": dict(mesh.shape) if mesh is not None else None}
