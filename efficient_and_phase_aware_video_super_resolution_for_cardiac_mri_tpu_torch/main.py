"""Composition root of the PyTorch port: train or test from a config.

    python -m efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main CONFIG [--test]

The reference's RefineNet, single-image (Bicubic, EDSR, SRFB), multi-frame
(DUF, RBPN, TOFlow) and plain video (DRF, FRVSR) ``configs/train|test/**.yaml``
files load unchanged.  The device is the
trainer's or the predictor's ``device`` kwarg: ``cuda:0`` (or any ``cuda``)
is the card, ``cpu`` the CPU, and no device means ``cuda``.  A CUDA device on a machine without one raises; nothing
falls back to the CPU.  On the card the fp32 path keeps TF32 off for
convolutions and matrix products: the JAX package computes the SSIM filter
at full precision, and the recurrent spine would accumulate TF32 rounding
over its 42 steps (and, in training, over its backward).

A ``parallel:`` section (``num_devices``, ``model_parallel``,
``spatial_parallel``, ``pad_h``, ``multi_host``, ``coordinator_address``,
``num_processes``, ``process_id``) runs over ``torch.distributed``, one
process (rank) per device, NCCL on the card and gloo on the CPU
(``parallel/``):

* ``main`` spawns ``num_devices`` ranks itself (a multi-host run: this
  host's share, ranks ``process_id · local + i``), each running the train
  or test path on its device and slice of the data; rank 0's history or
  log comes back to the caller;
* under ``torchrun`` (or with ``WORLD_SIZE`` and ``RANK`` set) the process
  joins that group instead and runs its own rank;
* ``num_devices: 1`` runs in this process, in a process group of one,
  the net still wrapped.  That group belongs to the run: it is destroyed
  when ``train_from_config`` or ``test_from_config`` returns or raises (a
  group the caller made stays the caller's), so the engine they return
  holds a wrapped net whose group is gone; its ``net`` still runs.

More CUDA devices than are visible, ``spatial_parallel`` with
``model_parallel``, and a device count that ``spatial_parallel ×
model_parallel`` does not divide raise ``ValueError`` as the JAX
package's mesh does, before any rank starts.  Every net of the zoo
takes ``spatial_parallel > 1``.
``pad_h`` sets the predictor's knob, as in the JAX package's
``main``.  A multi-host run defaults to ``checkpoint_backend:
orbax_async``, as in the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import logging
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.distributed as dist

from .config import (
    DATALOADERS,
    DATASETS,
    LOGGERS,
    LOSSES,
    METRICS,
    MONITORS,
    NETS,
    PREDICTORS,
    TRAINERS,
    Cfg,
    load_config,
)
from .utils.seeding import seed_everything

logger = logging.getLogger(__name__)


def _import_components():
    # populate the registries
    from . import data, losses, metrics, models  # noqa: F401
    from .runner import loggers, monitor, predictors, trainers  # noqa: F401


def resolve_device(device_str: str | None) -> torch.device:
    """The config's device string → ``torch.device``; ``None`` means CUDA."""
    device = torch.device(device_str or "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device_str or 'cuda'!r} asked for CUDA, but torch.cuda.is_available() "
                "is False; set `device: cpu` to run on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {device_str!r}")
    return device


def _build_losses(cfg: Cfg):
    loss_fns, loss_weights = [], []
    for c in cfg.losses:
        loss_fns.append(LOSSES.build(c))
        loss_weights.append(c.get("weight", 1.0))
    return loss_fns, loss_weights


def _build_metrics(cfg: Cfg):
    return [METRICS.build(c) for c in cfg.get("metrics", [])]


def _check_parallel(cfg: Cfg, device: torch.device) -> dict:
    """The config's ``parallel:`` section ({} without one) after the JAX
    package's refusals (``ValueError``): more CUDA devices than are
    visible, ``spatial_parallel`` with ``model_parallel``, a device count
    their product does not divide."""
    from .parallel import check_axes, check_devices

    parallel = dict(cfg.get("parallel") or {})
    if not parallel:
        return {}
    n = parallel.get("num_devices") or (torch.cuda.device_count() if device.type == "cuda" else 1)
    if not dist.is_initialized() or dist.get_backend() == "nccl":
        # (the ranks of a gloo group made by the caller may share a card)
        check_devices(int(n), device)
    sp = int(parallel.get("spatial_parallel") or 1)
    check_axes(int(n), sp, parallel.get("model_parallel", 1))
    return parallel


def _launch_plan(cfg: Cfg, device: torch.device) -> dict | None:
    """How many ranks this process spawns, and their address, world size
    and first rank; None to run here (no section, one device, or a group
    to join)."""
    from .parallel.distributed import NO_COORDINATOR, cluster_env_present

    parallel = _check_parallel(cfg, device)
    if not parallel or cluster_env_present() or dist.is_initialized():
        return None
    n = int(parallel.get("num_devices") or (torch.cuda.device_count() if device.type == "cuda" else 1))
    if parallel.get("multi_host"):
        if not parallel.get("coordinator_address"):
            raise ValueError(NO_COORDINATOR)
        hosts = int(parallel.get("num_processes") or 1)
        if n % hosts:
            raise ValueError(f"parallel.num_devices={n} not divisible by num_processes={hosts}.")
        local = n // hosts
        return {"address": parallel["coordinator_address"], "world": n, "local": local,
                "first": int(parallel.get("process_id") or 0) * local}
    if n == 1:
        return None
    return {"world": n, "local": n, "first": 0}


def _run_rank(cfg: dict, test: bool) -> dict:
    """One spawned rank's run → rank 0's summary."""
    cfg = Cfg(cfg)
    return _summary(test_from_config(cfg) if test else train_from_config(cfg))


def _summary(out) -> dict:
    """What a spawned rank 0 hands back of its trainer or predictor."""
    keys = ("history", "epoch", "log", "throughput", "grad_accum_steps")
    summary = {k: getattr(out, k) for k in keys if hasattr(out, k)}
    mesh = getattr(out, "mesh", None)
    summary["mesh"] = dict(mesh.shape) if mesh is not None else None
    return summary


def run(cfg: Cfg, test: bool = False):
    """The train or test path of ``cfg``: here, or in the ranks that its
    ``parallel:`` section asks for (then rank 0's summary comes back as a
    namespace of ``history``/``log``, ``epoch``, ``throughput`` and
    ``mesh``)."""
    engine = cfg.predictor if test else cfg.trainer
    device = resolve_device((engine.get("kwargs") or {}).get("device"))
    plan = _launch_plan(cfg, device)
    if plan is None:
        return test_from_config(cfg) if test else train_from_config(cfg)
    from .parallel.distributed import spawn

    out = spawn(_run_rank, (cfg.to_dict(), test), device=device, **plan)
    return SimpleNamespace(**out) if out is not None else None


@contextlib.contextmanager
def build_mesh(cfg: Cfg, device: torch.device):
    """The run's mesh from its ``parallel:`` section (None without one),
    joining the launcher's group, or making a group of one, as needed;
    yields (mesh, device of this rank).  A group of one made here is the
    run's own: it is destroyed when the run returns or raises."""
    from .parallel import distributed_initialize, make_mesh
    from .parallel.distributed import free_port, local_device
    from .runner.checkpoint import wait_for_async_saves

    parallel = _check_parallel(cfg, device)
    if not parallel:
        yield None, device
        return
    multi_host = bool(parallel.get("multi_host"))
    own = False
    if not dist.is_initialized():
        # a multi-host run joins its launcher's group (``run`` spawns one)
        if not distributed_initialize(device=device, require=multi_host) \
                and not dist.is_initialized():
            # one device: a process group of one, so the step is the wrapped one
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo",
                init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
            own = True
    try:
        device = local_device(device)
        hosts = int(parallel.get("num_processes") or 1) if multi_host else 1
        mesh = make_mesh(parallel.get("num_devices"), parallel.get("model_parallel", 1),
                         parallel.get("spatial_parallel", 1), device, hosts=hosts)
        logger.info("parallel: mesh %s, rank %d on %s.", mesh.shape, mesh.rank, device)
        yield mesh, device
    finally:
        if own:
            wait_for_async_saves()
            dist.destroy_process_group()


def train_from_config(cfg: Cfg):
    _import_components()
    trainer_kwargs = dict(cfg.trainer.get("kwargs") or {})
    device = resolve_device(trainer_kwargs.pop("device", None))
    with build_mesh(cfg, device) as (mesh, device):
        return _train(cfg, trainer_kwargs, mesh, device)


def _train(cfg: Cfg, trainer_kwargs: dict, mesh, device: torch.device):
    from .runner.checkpoint import find_latest_checkpoint
    from .runner.optim import build_lr_scheduler, build_optimizer

    lead = mesh is None or mesh.is_lead
    saved_dir = Path(cfg.main.saved_dir)
    saved_dir.mkdir(parents=True, exist_ok=True)
    if lead:
        cfg.to_yaml(saved_dir / "config.yaml")
    if mesh is not None and mesh.hosts > 1:
        # the JAX package's multi-host default: every rank writes its shards
        trainer_kwargs.setdefault("checkpoint_backend", "orbax_async")

    num_epochs = trainer_kwargs.get("num_epochs", 1)
    seed_state = seed_everything(cfg.main.get("random_seed", "vsr"), num_epochs)

    logger.info("Create the training and validation datasets.")
    data_dir = Path(cfg.dataset.kwargs.data_dir)
    train_ds = DATASETS.build(cfg.dataset, data_dir=data_dir, type="train")
    valid_ds = DATASETS.build(cfg.dataset, data_dir=data_dir, type="valid")

    logger.info("Create the training and validation dataloaders.")
    dl_kwargs = dict(cfg.dataloader.get("kwargs") or {})
    train_bs = dl_kwargs.pop("train_batch_size", dl_kwargs.pop("batch_size", 1))
    valid_bs = dl_kwargs.pop("valid_batch_size", 1)
    dl_cls = DATALOADERS.get(cfg.dataloader.name)
    train_loader = dl_cls(train_ds, batch_size=train_bs, **dl_kwargs)
    # as in the JAX package, and unlike the reference (which reuses the train
    # kwargs, shuffle included), validation is deterministic
    dl_kwargs["shuffle"] = False
    valid_loader = dl_cls(valid_ds, batch_size=valid_bs, **dl_kwargs)

    logger.info("Create the network architecture.")
    net = NETS.build(cfg.net, generator=seed_state.torch_generator())

    logger.info("Create the loss and metric functions.")
    loss_fns, loss_weights = _build_losses(cfg)
    metric_fns = _build_metrics(cfg)

    logger.info("Create the optimizer and the lr scheduler.")
    optimizer = build_optimizer(cfg.optimizer)
    lr_scheduler = build_lr_scheduler(cfg.get("lr_scheduler"), optimizer.base_lr)

    logger.info("Create the logger and the monitor.")
    tb_logger = None
    if cfg.get("logger") and lead:
        logger_kwargs = dict(cfg.logger.get("kwargs") or {})
        logger_kwargs.pop("dummy_input", None)
        tb_logger = LOGGERS.get(cfg.logger.name)(log_dir=saved_dir / "log", net=net, **logger_kwargs)
    monitor = MONITORS.build(cfg.monitor, checkpoints_dir=saved_dir / "checkpoints")

    logger.info("Create the trainer.")
    trainer = TRAINERS.get(cfg.trainer.name)(
        device=device,
        train_dataloader=train_loader,
        valid_dataloader=valid_loader,
        net=net,
        loss_fns=loss_fns,
        loss_weights=loss_weights,
        metric_fns=metric_fns,
        optimizer=optimizer,
        lr_scheduler=lr_scheduler,
        logger=tb_logger,
        monitor=monitor,
        seed_state=seed_state,
        mesh=mesh,
        **trainer_kwargs,
    )

    loaded_path = cfg.main.get("loaded_path")
    if loaded_path == "auto":
        # failure recovery: resume from the newest checkpoint if any exists
        loaded_path = find_latest_checkpoint(saved_dir / "checkpoints")
        logger.info(f"Auto-resume: {'found ' + str(loaded_path) if loaded_path else 'no checkpoint, fresh start'}.")
    if loaded_path:
        logger.info(f'Load the previous checkpoint from "{loaded_path}".')
        trainer.load(Path(loaded_path))
        logger.info("Resume training.")
    else:
        logger.info("Start training.")
    trainer.train()
    logger.info("End training.")
    return trainer


def test_from_config(cfg: Cfg):
    _import_components()
    pred_kwargs = dict(cfg.predictor.get("kwargs") or {})
    device = resolve_device(pred_kwargs.pop("device", None))
    with build_mesh(cfg, device) as (mesh, device):
        return _test(cfg, pred_kwargs, mesh, device)


def _test(cfg: Cfg, pred_kwargs: dict, mesh, device: torch.device):
    saved_dir = Path(cfg.main.saved_dir)
    saved_dir.mkdir(parents=True, exist_ok=True)
    if mesh is None or mesh.is_lead:
        cfg.to_yaml(saved_dir / "config.yaml")

    logger.info("Create the testing dataset and dataloader.")
    data_dir = Path(cfg.dataset.kwargs.data_dir)
    test_ds = DATASETS.build(cfg.dataset, data_dir=data_dir, type="test")
    dl_kwargs = dict(cfg.dataloader.get("kwargs") or {})
    test_loader = DATALOADERS.get(cfg.dataloader.name)(test_ds, **dl_kwargs)

    logger.info("Create the network architecture.")
    net = NETS.build(cfg.net)

    loss_fns, loss_weights = _build_losses(cfg)
    metric_fns = _build_metrics(cfg)

    logger.info("Create the predictor.")
    # parallel: {pad_h: true} edge-extends the heights that spatial_parallel
    # does not divide (the JAX package's main)
    if (cfg.get("parallel") or {}).get("pad_h"):
        pred_kwargs.setdefault("pad_h", True)
    predictor = PREDICTORS.get(cfg.predictor.name)(
        device=device,
        test_dataloader=test_loader,
        net=net,
        loss_fns=loss_fns,
        loss_weights=loss_weights,
        metric_fns=metric_fns,
        parallel=dict(cfg.get("parallel") or {}),
        mesh=mesh,
        **pred_kwargs,
    )

    # Bicubic has no weights: no checkpoint is read (reference ``src/main.py:154``)
    if cfg.net.name != "Bicubic":
        logger.info(f'Load the previous checkpoint from "{cfg.main.loaded_path}".')
        predictor.load(Path(cfg.main.loaded_path))
    logger.info("Start testing.")
    predictor.predict()
    logger.info("End testing.")
    return predictor


def main(config_path, test: bool = False):
    return run(load_config(config_path), test)


def _parse_args():
    parser = argparse.ArgumentParser(description="The script for the training and the testing.")
    parser.add_argument("config_path", type=Path, help="The path of the config file.")
    parser.add_argument("--test", action="store_true", help="Run the test path.")
    return parser.parse_args()


def cli():
    logging.basicConfig(
        format="%(asctime)s | %(levelname)s | %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    args = _parse_args()
    main(args.config_path, args.test)


if __name__ == "__main__":
    cli()
