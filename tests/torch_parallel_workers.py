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
                model_parallel: int = 1, onednn: bool = True, spatial_parallel: int = 1,
                **trainer_kwargs) -> dict:
    """One epoch over ``items`` (batches of ``batch``, in order) of the
    RefineNet (``kind='refine'``) or DUF (``'duf'``) trainer from the
    weights ``net_state``, under a mesh of ``world`` ranks, ``model_parallel``
    of them a model group or ``spatial_parallel`` a spatial group (None: no
    mesh), with oneDNN's convs or without them (its bf16 convs keep no fp32
    sum) → the epoch's train log, the net's state and the data-axis
    warnings issued."""
    with torch.backends.mkldnn.flags(enabled=onednn):
        return _train_steps(kind, net_state, net_kwargs, items, batch, world, optimizer,
                            model_parallel, spatial_parallel, **trainer_kwargs)


def _train_steps(kind, net_state, net_kwargs, items, batch, world, optimizer, model_parallel,
                 spatial_parallel=1, save_to=None, **trainer_kwargs):
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
        DUFNet,
        RefineNet,
    )

    mesh = make_mesh(world, model_parallel, spatial_parallel) if world else None
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
    if save_to is not None:  # every rank calls; the backend decides who writes
        trainer.save(save_to)
    state = trainer._full_state()[0]  # whole, under a model axis
    return {"log": log, "state": {k: v.detach().clone() for k, v in state.items()},
            "warned": sorted(k[0] for k in mesh_mod._WARNED),
            "mesh": dict(mesh.shape) if mesh is not None else None}


# ------------------------------------------------------------ spatial axis
def run_tasks(tasks: list) -> list:
    """Each ``(name, kwargs)`` of ``tasks`` in order on every rank of the
    group; rank 0's results."""
    return [globals()[name](**kwargs) for name, kwargs in tasks]


def halo_errors(seed: int = 0) -> dict:
    """``halo_conv2d`` (NCHW and channels-last) and ``halo_conv3d``
    over every rank of the group against the whole conv on each rank:
    the largest error of the output, the input gradient and the weight
    gradient (summed over the ranks) of any rank, in float64 (the
    exchange copies, so only the sums' order is left to differ)."""
    import torch.distributed as dist

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel.halo import (
        SpatialAxis,
        halo_conv2d,
        halo_conv3d,
    )

    S, i = dist.get_world_size(), dist.get_rank()
    axis = SpatialAxis(dist.new_group(list(range(S))), S, i)
    gen = torch.Generator().manual_seed(seed)
    H = 4 * S
    rows = slice(i * H // S, (i + 1) * H // S)
    errors = {}

    def compare(name, conv, x, w, b, dy, padding, fmt=torch.contiguous_format):
        xw, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        conv(xw, ww, b, padding, None).backward(dy)
        xl = x[..., rows, :].contiguous(memory_format=fmt).requires_grad_()
        wl = w.clone().requires_grad_()
        yl = conv(xl, wl, b, padding, axis)
        yl.backward(dy[..., rows, :])
        dw = wl.grad.clone()
        dist.all_reduce(dw)
        want = conv(x, w, b, padding, None)[..., rows, :]
        errors[name] = {"out": (yl - want).abs().max().item(),
                        "dx": (xl.grad - xw.grad[..., rows, :]).abs().max().item(),
                        "dw": (dw - ww.grad).abs().max().item()}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    for fmt in (torch.contiguous_format, torch.channels_last):
        compare(f"conv2d {fmt}", halo_conv2d, randn(2, 3, H, 5), randn(4, 3, 3, 3), randn(4),
                randn(2, 4, H, 5), 1, fmt)
    compare("conv3d", halo_conv3d, randn(2, 3, 5, H, 4), randn(4, 3, 5, 3, 3), randn(4),
            randn(2, 4, 1, H, 4), (0, 1, 1))
    everyone = [None] * S
    dist.all_gather_object(everyone, errors)
    return {name: {k: max(e[name][k] for e in everyone) for k in errors[name]} for name in errors}


def spatial_forward(net_state: dict, net_kwargs: dict, lr: np.ndarray, pos: np.ndarray,
                    spatial: int, compute_dtype: str | None = None) -> np.ndarray:
    """RefineNet's fused output (in ``compute_dtype``, back in fp32) on a
    (data, spatial) mesh of every rank: each rank its data slice's rows,
    the rows gathered whole; rank 0's slice of the batch comes back."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.casting import (
        forward_in,
        resolve_dtype,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
        RefineNet,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import (
        batch_slice,
        gather_rows,
        shard_spatially,
        spatial_rows,
        take_rows,
    )

    mesh = make_mesh(None, spatial_parallel=spatial)
    net = RefineNet(**net_kwargs)
    net.load_state_dict(net_state, strict=True)
    shard_spatially(net, mesh.spatial_axis)
    items = batch_slice(len(lr), mesh)
    lr, pos = lr[items], pos[items]
    with torch.no_grad():
        out = forward_in(net, resolve_dtype(compute_dtype),
                         torch.from_numpy(take_rows(lr, spatial_rows(lr.shape, mesh))),
                         torch.from_numpy(pos))[-1]
    return gather_rows(out, mesh.spatial_axis).numpy()


def spatial_steps(net_state: dict, net_kwargs: dict, items: list, batch: int, spatial: int,
                  optimizer: tuple) -> dict:
    """One epoch of the RefineNet trainer on a (data, spatial) mesh of every
    rank, plain and with ``remat`` → both logs and states, and the halo
    exchanges a step of each."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import (
        halo,
    )

    out = {}
    for name, remat in (("plain", False), ("remat", True)):
        halo.reset_exchanges()
        out[name] = _train_steps("refine", net_state, {**net_kwargs, "remat": remat}, items, batch,
                                 torch.distributed.get_world_size(), optimizer, 1, spatial)
        out[name]["exchanges"] = dict(halo.EXCHANGES)
    return out


def spatial_knobs(net_state: dict, net_kwargs: dict, items: list, poisoned: list, batch: int,
                  spatial: int, saved_dir: str) -> dict:
    """The trainer's knobs on a (data, spatial) mesh of every rank, each an
    SGD epoch: ``grad_accum_steps: 2`` (saved as a ``.pth`` and as a
    directory checkpoint), ``compute_dtype: bfloat16`` (oneDNN off), and
    ``skip_nonfinite`` over ``poisoned`` items."""
    world, sgd = torch.distributed.get_world_size(), ("SGD", {"lr": 1e-2})
    return {
        "accum": _train_steps("refine", net_state, net_kwargs, items, batch, world, sgd, 1,
                              spatial, save_to=f"{saved_dir}/accum.pth", grad_accum_steps=2),
        "accum_dir": _train_steps("refine", net_state, net_kwargs, items, batch, world, sgd, 1,
                                  spatial, save_to=f"{saved_dir}/accum_dir",
                                  grad_accum_steps=2, checkpoint_backend="orbax"),
        "bf16": train_steps("refine", net_state, net_kwargs, items, batch, world, sgd,
                            onednn=False, spatial_parallel=spatial, compute_dtype="bfloat16"),
        "skip": _train_steps("refine", net_state, net_kwargs, poisoned, batch, world,
                             ("SGD", {"lr": 1e-2, "skip_nonfinite": 3}), 1, spatial),
    }


def predict_from_config(cfg: dict) -> dict:
    """The port's ``main.test_from_config`` on this group → the Test log,
    the mesh and the spatial warnings issued."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import Cfg
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
        test_from_config as run,
    )

    mesh_mod._WARNED.clear()
    predictor = run(Cfg(cfg))
    return {"log": predictor.log, "mesh": dict(predictor.mesh.shape),
            "warned": sorted(k[0] for k in mesh_mod._WARNED), "pad_h": predictor.pad_h}


def train_from_config(cfg: dict) -> dict:
    """The port's ``main.train_from_config`` on this group → the history,
    the mesh and the spatial warnings issued."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import Cfg
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
        train_from_config as run,
    )

    mesh_mod._WARNED.clear()
    trainer = run(Cfg(cfg))
    return {"history": trainer.history, "mesh": dict(trainer.mesh.shape),
            "warned": sorted(k[0] for k in mesh_mod._WARNED)}


def batch_infer(argv: list) -> dict | None:
    """``tools/batch_infer.py`` as a rank of this group runs it (the
    launcher's path) → rank 0's summary."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import (
        batch_infer as tool,
    )

    return tool.main(argv)
