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
    FRVSRTrainer,
    MISRTrainer,
    SISRSRFBTrainer,
    VSRRefineNetTrainer,
    VSRTrainer,
)


class ListDataset:
    """In-memory items (channels-last numpy)."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


#: the losses of a kind's train YAML where they are not an L1
LOSSES = {"duf": [PL.MSELoss()], "frvsr": [PL.FlowLoss(), PL.MSELoss()],
          "edvr": [PL.CharbonnierLoss(epsilon=1e-6)]}


def train_steps(kind: str, net_state: dict, net_kwargs: dict, items: list, batch: int,
                world: int | None, optimizer: tuple = ("Adam", {"lr": 1e-3}),
                model_parallel: int = 1, onednn: bool = True, spatial_parallel: int = 1,
                **trainer_kwargs) -> dict:
    """One epoch over ``items`` (batches of ``batch``, in order) of the
    RefineNet (``kind='refine'``), DUF (``'duf'``), SRFB (``'srfb'``) or
    DRF (``'drf'``) trainer from the weights ``net_state``, under a mesh
    of ``world`` ranks, ``model_parallel`` of them a model group or
    ``spatial_parallel`` a spatial group (None: no mesh), with oneDNN's convs or without them (its bf16 convs keep no fp32
    sum) → the epoch's train log, the net's state and the data-axis
    warnings issued."""
    with torch.backends.mkldnn.flags(enabled=onednn):
        return _train_steps(kind, net_state, net_kwargs, items, batch, world, optimizer,
                            model_parallel, spatial_parallel, **trainer_kwargs)


def _train_steps(kind, net_state, net_kwargs, items, batch, world, optimizer, model_parallel,
                 spatial_parallel=1, save_to=None, **trainer_kwargs):
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
        DRFNet,
        DUFNet,
        EDVRNet,
        FRVSRNet,
        RefineNet,
        SRFBNet,
        TOFlowNet,
    )

    mesh = make_mesh(world, model_parallel, spatial_parallel, device="cpu") if world else None
    net_cls, trainer_cls = {"refine": (RefineNet, VSRRefineNetTrainer),
                            "duf": (DUFNet, MISRTrainer), "srfb": (SRFBNet, SISRSRFBTrainer),
                            "drf": (DRFNet, VSRTrainer), "toflow": (TOFlowNet, MISRTrainer),
                            "frvsr": (FRVSRNet, FRVSRTrainer), "edvr": (EDVRNet, MISRTrainer)}[kind]
    net = net_cls(**net_kwargs)
    net.load_state_dict(net_state, strict=True)
    loader = Dataloader(ListDataset(items), batch_size=batch, shuffle=False)
    name, kwargs = optimizer
    trainer = trainer_cls(
        device="cpu", train_dataloader=loader, valid_dataloader=loader, net=net,
        loss_fns=LOSSES.get(kind, [PL.L1Loss()]), loss_weights=[1.0] * len(LOSSES.get(kind, [0])),
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

    mesh = make_mesh(None, spatial_parallel=spatial, device="cpu")
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


# ---------------------------------------------- the spatial axis of the zoo
def zoo_halo_errors(seed: int = 0) -> dict:
    """Over every rank of the group, against the whole op on each rank, the
    largest error of any rank: the strided ``halo_conv2d`` and
    ``halo_conv_transpose2d`` at each ``PROJ_PARAMS`` factor (output, input
    gradient, weight gradient summed over the ranks; float64, 2 LR rows a
    rank), and the band resizes of ``ops/resize.py`` (bilinear
    ``align_corners=False``, bicubic ``align_corners=True``, ×2, ×3, ×4)
    at 2 rows and 1 row a rank, with the halo each took (None: gathered)."""
    import torch.distributed as dist

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models.common import (
        PROJ_PARAMS,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
        resize,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel.halo import (
        SpatialAxis,
        halo_conv2d,
        halo_conv_transpose2d,
    )

    S, i = dist.get_world_size(), dist.get_rank()
    axis = SpatialAxis(dist.new_group(list(range(S))), S, i)
    gen = torch.Generator().manual_seed(seed)
    errors, halos = {}, {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    def band(t, rows, dim=-2):
        index = [slice(None)] * t.dim()
        index[dim] = slice(i * rows, (i + 1) * rows)
        return t[tuple(index)]

    for r, (k, s, p) in PROJ_PARAMS.items():
        L = 2  # LR rows a rank
        for name, op, rows_in, rows_out, w, width in (
                ("conv", lambda x, w, b, a: halo_conv2d(x, w, b, p, a, s), s * L, L,
                 randn(4, 3, k, k), 2 * s),
                ("deconv", lambda x, w, b, a: halo_conv_transpose2d(x, w, b, s, p, a), L, s * L,
                 randn(3, 4, k, k), 3)):
            x, b = randn(2, 3, S * rows_in, width), randn(4)
            xw, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
            whole = op(xw, ww, b, None)
            dy = randn(*whole.shape)
            whole.backward(dy)
            xl, wl = band(x, rows_in).contiguous().requires_grad_(), w.clone().requires_grad_()
            yl = op(xl, wl, b, axis)
            yl.backward(band(dy, rows_out))
            dw = wl.grad.clone()
            dist.all_reduce(dw)
            errors[f"{name} x{r}"] = {
                "out": (yl - band(whole.detach(), rows_out)).abs().max().item(),
                "dx": (xl.grad - band(xw.grad, rows_in)).abs().max().item(),
                "dw": (dw - ww.grad).abs().max().item()}
    for rows in (2, 1):
        for kind, fn, ac in (("bilinear", resize.upsample_bilinear, False),
                             ("bicubic", resize.upsample_bicubic, True)):
            for r in (2, 3, 4):
                x = torch.randn(2, S * rows, 5, 2, generator=gen)
                whole = fn(x, r, ac)
                got = fn(band(x, rows, -3).contiguous(), r, ac, axis=axis)
                key = f"{kind} x{r} {rows} rows"
                errors[key] = {"out": (got - band(whole, rows * r, -3)).abs().max().item()}
                halos[key] = resize.band_plan(S * rows, S * rows * r, ac,
                                              "linear" if kind == "bilinear" else "cubic", S)[0]
    everyone = [None] * S
    dist.all_gather_object(everyone, errors)
    return {"errors": {name: {k: max(e[name][k] for e in everyone) for k in errors[name]}
                       for name in errors}, "halos": halos}


def zoo_forward(name: str, net_kwargs: dict, net_state: dict, lr: np.ndarray,
                spatial: int) -> dict:
    """The net ``name``'s outputs (each step's, for the feedback nets) on a
    (data, spatial) mesh of every rank: each rank its data slice's rows,
    the rows gathered whole → rank 0's slice of the batch, stacked over the
    outputs, and the halo exchanges of the forward."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
        deform_conv,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import (
        batch_slice,
        gather_rows,
        halo,
        shard_spatially,
        spatial_rows,
        take_rows,
    )

    mesh = make_mesh(None, spatial_parallel=spatial, device="cpu")
    net = getattr(models, name)(**net_kwargs)
    net.load_state_dict(net_state, strict=True)
    shard_spatially(net.eval(), mesh.spatial_axis)
    lr = lr[batch_slice(len(lr), mesh)]
    halo.reset_exchanges()
    deform_conv.SPATIAL_CALLS.update(band=0, frame=0)
    with torch.no_grad():
        out = net(torch.from_numpy(take_rows(lr, spatial_rows(lr.shape, mesh))))
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    return {"out": np.stack([gather_rows(o, mesh.spatial_axis).numpy() for o in outs]),
            "exchanges": dict(halo.EXCHANGES), "gathers": dict(halo.GATHERS),
            "dcn": dict(deform_conv.SPATIAL_CALLS)}


def band_fit(name: str, net_kwargs: dict, net_state: dict, lr: np.ndarray,
             spatial: int) -> dict:
    """``name``'s forward of the LR array ``lr`` as the predictor and the
    trainer run an item on a spatial mesh of every rank: its rows and axis
    from ``parallel.spatial_step``, which replicates an item whose bands
    would not fit the net → the output gathered whole, whether the item
    was sharded, and the warnings issued."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import (
        gather_rows,
        spatial_step,
        take_rows,
    )

    mesh = make_mesh(None, spatial_parallel=spatial, device="cpu")
    net = getattr(models, name)(**net_kwargs)
    net.load_state_dict(net_state, strict=True)
    mesh_mod._WARNED.clear()
    rows, axis = spatial_step(net.eval(), lr.shape, mesh)
    x = lr if rows is None else np.ascontiguousarray(take_rows(lr, rows))
    with torch.no_grad():
        out = gather_rows(net(torch.from_numpy(x)), axis)
    return {"out": out.numpy(), "sharded": rows is not None,
            "warned": sorted(k[0] for k in mesh_mod._WARNED)}


def zoo_steps(kind: str, net_state: dict, net_kwargs: dict, items: list, batch: int,
              spatial: int, optimizer: tuple, remat: tuple = (False,)) -> dict:
    """One epoch of the ``kind`` trainer (``train_steps``) on a (data,
    spatial) mesh of every rank, once per ``remat`` setting → each one's
    log, state, warnings and halo exchanges."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import (
        halo,
    )

    out = {}
    for flag in remat:
        halo.reset_exchanges()
        kwargs = {**net_kwargs, "remat": True} if flag else net_kwargs
        out[flag] = _train_steps(kind, net_state, kwargs, items, batch,
                                 torch.distributed.get_world_size(), optimizer, 1, spatial)
        out[flag]["exchanges"] = dict(halo.EXCHANGES)
        out[flag]["gathers"] = dict(halo.GATHERS)
    return out


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
            "warned": sorted(k[0] for k in mesh_mod._WARNED), "pad_h": predictor.pad_h,
            "telemetry": predictor.telemetry_summary}


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


def video_units(seed: int = 0) -> dict:
    """The pieces of the video nets' spatial axis on each rank's band of a
    frame against the whole op on every rank (float64 operands; the warps'
    and the DCN's coordinates are fp32 either way): the warps (TOFlow's
    ``flow_warp``, FRVSR's ``stn_warp``; windowed with a halo, windowed
    from the gathered frame at a band narrower than the window, exact;
    ``zeros`` and ``border``) in output, input and flow gradients; the
    3×3/s2/p1 conv and FRVSR's k 3, s 2, p 1, output-padding-1 transposed
    conv, with weight gradients summed over the ranks; ``pad_to_multiple``
    with the minimum on rank 1, in value and gradient; TSA's pools; the
    DCN's plain twin on a band (windowed, with its row origin) and on the
    gathered frame (exact, and windowed at a narrow band), in output and
    in the gradients of x, the offsets, the mask and the weight.  → the
    largest error of each over the ranks, and the DCN's calls by operand."""
    import torch.distributed as dist

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models.common import (
        pad_to_multiple,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models.edvr_net import (
        TSAFusion,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
        deform_conv,
        warp,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel.halo import (
        GATHERS,
        SpatialAxis,
        halo_conv2d,
        halo_conv_transpose2d,
        reset_exchanges,
    )

    S, i = dist.get_world_size(), dist.get_rank()
    axis = SpatialAxis(dist.new_group(list(range(S))), S, i)
    gen = torch.Generator().manual_seed(seed)
    errors = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    def band(t, rows, dim=-2):
        index = [slice(None)] * t.dim()
        index[dim] = slice(i * rows, (i + 1) * rows)
        return t[tuple(index)]

    def compare(name, op, operands, dims, rows, out_dim=-2, out_rows=None, shared=()):
        """op(*operands, axis) on the bands against op(*operands, None):
        the output and each operand's gradient (a ``shared`` operand's
        summed over the ranks)."""
        whole_in = [t.clone().requires_grad_() for t in operands]
        whole = op(*whole_in, None)
        dy = randn(*whole.shape)
        whole.backward(dy)
        local = [t.clone().requires_grad_() if j in shared else
                 band(t, rows, d).contiguous().requires_grad_()
                 for j, (t, d) in enumerate(zip(operands, dims))]
        y = op(*local, axis)
        y.backward(band(dy, out_rows or rows, out_dim))
        err = {"out": (y - band(whole.detach(), out_rows or rows, out_dim)).abs().max().item()}
        for j, (w, l, d) in enumerate(zip(whole_in, local, dims)):
            g = l.grad.clone()
            if j in shared:
                dist.all_reduce(g)
                err[f"d{j}"] = (g - w.grad).abs().max().item()
            else:
                err[f"d{j}"] = (g - band(w.grad, rows, d)).abs().max().item()
        errors[name] = err

    W = 6
    for rows, label in ((4, "halo"), (2, "gathered")):
        H = S * rows
        x = randn(2, 3, H, W)
        for mode in ("zeros", "border"):
            flow = randn(2, H, W, 2) * 1.5
            for R in (2, None):
                path = "exact" if R is None else label
                compare(f"flow_warp {mode} {path} {rows} rows",
                        lambda a, f, ax, m=mode, r=R: warp.flow_warp(a, f, m, r, axis=ax),
                        (x, flow), (-2, -3), rows)
                u, v = randn(2, H, W) * 0.3, randn(2, H, W) * 0.3
                compare(f"stn_warp {mode} {path} {rows} rows",
                        lambda a, p, q, ax, m=mode, r=R: warp.stn_warp(a, p, q, m, r, axis=ax),
                        (x, u, v), (-2, -2, -2), rows)
    # the pyramid's strided conv and FRVSR's transposed conv
    b3, b4 = randn(3), randn(4)
    compare("conv k3 s2 p1",
            lambda a, w, ax: halo_conv2d(a, w, b4, 1, ax, 2),
            (randn(2, 3, S * 4, W), randn(4, 3, 3, 3)), (-2, None), 4, out_rows=2,
            shared=(1,))
    compare("deconv k3 s2 p1 op1",
            lambda a, w, ax: halo_conv_transpose2d(a, w, b3, 2, 1, ax, output_padding=1),
            (randn(2, 4, S * 2, 5), randn(4, 3, 3, 3)), (-2, None), 2, out_rows=4,
            shared=(1,))
    # the pad's minimum on rank 1: over 2 ranks a height that needs a pad
    # (10 rows to a multiple of 4: one row on each), over 4 one that needs
    # none; the width pads either way
    rows = 5 if S == 2 else 2
    x = randn(2, 3, S * rows, 5, 1)
    x[1, 2, rows + 1, 3, 0] = -50.0
    whole_in = x.clone().requires_grad_()
    padded, _ = pad_to_multiple(whole_in, 4, dims=(-3, -2))
    dy = randn(*padded.shape)
    (padded * dy).sum().backward()
    local = band(x, rows, -3).contiguous().requires_grad_()
    got, crops = pad_to_multiple(local, 4, dims=(-3, -2), axis=axis)
    prows = got.shape[-3]
    (got * band(dy, prows, -3)).sum().backward()
    errors["pad_to_multiple"] = {
        "out": (got - band(padded.detach(), prows, -3)).abs().max().item(),
        "d0": (local.grad - band(whole_in.grad, rows, -3)).abs().max().item(),
        "rows": prows, "crop": [crops[-3].start, crops[-3].stop]}
    compare("tsa pools", lambda a, ax: TSAFusion._pools(a, ax), (randn(2, 3, S * 4, W),),
            (-2,), 4, out_rows=2)
    # the DCN: offsets up to ~±3 px, half of them exactly 0 (a sample on a
    # pixel: the outer test at the frame's border decides its gradient)
    calls = {}
    for R, rows in ((1, 4), (2, 2), (None, 4)):
        H = S * rows
        off = randn(2, 2 * 18, H, W) * 1.5
        off = off * (torch.rand(off.shape, generator=gen, dtype=torch.float64) > 0.5)
        mask = torch.sigmoid(randn(2, 18, H, W))
        dcn = deform_conv.ModulatedDeformConv(4, 3, 3, padding=1, deformable_groups=2,
                                              max_offset=R).double()

        deform_conv.SPATIAL_CALLS.update(band=0, frame=0)
        reset_exchanges()
        compare(f"dcn R={R} {rows} rows",
                lambda a, o, m, w, ax, dcn=dcn: _dcn_call(dcn, a, o, m, w, ax),
                (randn(2, 4, H, W), off, mask, dcn.weight.detach().clone()),
                (-2, -2, -2, None), rows, shared=(3,))
        calls[f"dcn R={R} {rows} rows"] = {**deform_conv.SPATIAL_CALLS,
                                           "gathers": dict(GATHERS)}
    everyone = [None] * S
    dist.all_gather_object(everyone, errors)
    return {"errors": {name: {k: max(e[name][k] for e in everyone) if k not in ("rows", "crop")
                              else errors[name][k] for k in errors[name]}
                       for name in errors}, "dcn_calls": calls}


def _dcn_call(dcn, x, offset, mask, weight, axis):
    """``dcn`` (a ``ModulatedDeformConv``) with ``weight`` in place of its
    own, on this rank's band under ``axis``."""
    dcn.spatial_axis = axis
    return torch.func.functional_call(dcn, {"weight": weight, "bias": dcn.bias},
                                      (x, offset, mask))


def frvsr_stream(net_kwargs: dict, net_state: dict, lr: np.ndarray) -> dict:
    """``FRVSRStream`` of a net sharded over every rank, fed this rank's
    band of each frame, against the clip forward on the same band → the
    largest difference (fp32) and the bf16 stream's frame shape (its cast
    copy keeps the axis)."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
        FRVSRNet,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import (
        shard_spatially,
        spatial_rows,
        take_rows,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.streaming import (
        FRVSRStream,
    )

    mesh = make_mesh(None, spatial_parallel=torch.distributed.get_world_size(), device="cpu")
    net = FRVSRNet(**net_kwargs)
    net.load_state_dict(net_state, strict=True)
    shard_spatially(net.eval(), mesh.spatial_axis)
    band = torch.from_numpy(np.ascontiguousarray(take_rows(lr, spatial_rows(lr.shape, mesh))))
    with torch.no_grad():
        clip = net(band)
    stream = FRVSRStream(net)
    frames = torch.stack([stream.push(band[:, t]) for t in range(band.shape[1])], dim=1)
    bf16 = FRVSRStream(net, compute_dtype="bfloat16").push(band[:, 0])
    return {"diff": (frames - clip).abs().max().item(), "bf16_shape": tuple(bf16.shape),
            "band_shape": tuple(band.shape)}
