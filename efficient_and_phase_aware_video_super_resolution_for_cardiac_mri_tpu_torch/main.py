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

A ``parallel:`` section runs on the one device when it asks for one
(``num_devices: 1``, no spatial, model or multi-host axis); more CUDA
devices than are visible raise ``ValueError`` as the JAX package's mesh
does, and a multi-device mesh is still to port.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch

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


#: the keys of a ``parallel:`` section that a one-device run may carry, at
#: the value that leaves it one device
_ONE_DEVICE = {"spatial_parallel": 1, "model_parallel": 1, "multi_host": False, "pad_h": False}


def _check_parallel(cfg: Cfg, device: torch.device):
    """The config's ``parallel:`` section if it asks for one device (then
    the run is the single-device one), else raise: ``ValueError`` for more
    CUDA devices than are visible (the JAX package's ``make_mesh``),
    ``NotImplementedError`` for a mesh of several devices or any axis (on
    the CPU the JAX package provisions a virtual mesh of any size, which the
    port does not have)."""
    parallel = cfg.get("parallel")
    if not parallel:
        return None
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    n = parallel.get("num_devices") or visible
    if device.type == "cuda" and n > visible:
        raise ValueError(
            f"parallel.num_devices={n} but only {visible} device(s) are visible "
            f"({device.type}). Lower num_devices."
        )
    others = {k: v for k, v in parallel.items()
              if k != "num_devices" and (k not in _ONE_DEVICE or v != _ONE_DEVICE[k])}
    if n != 1 or others:
        raise NotImplementedError(
            f"the PyTorch port runs a `parallel:` section on one device only (num_devices: 1, "
            f"no spatial, model or multi-host axis); got {dict(parallel)} "
            "(ROADMAP queue 1, item 10)"
        )
    logger.info("parallel: num_devices 1, run on the one device %s.", device)
    return parallel


def train_from_config(cfg: Cfg):
    _import_components()
    from .runner.checkpoint import find_latest_checkpoint
    from .runner.optim import build_lr_scheduler, build_optimizer

    trainer_kwargs = dict(cfg.trainer.get("kwargs") or {})
    device = resolve_device(trainer_kwargs.pop("device", None))
    _check_parallel(cfg, device)

    saved_dir = Path(cfg.main.saved_dir)
    saved_dir.mkdir(parents=True, exist_ok=True)
    cfg.to_yaml(saved_dir / "config.yaml")

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
    if cfg.get("logger"):
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
    parallel = _check_parallel(cfg, device)

    saved_dir = Path(cfg.main.saved_dir)
    saved_dir.mkdir(parents=True, exist_ok=True)
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
    predictor = PREDICTORS.get(cfg.predictor.name)(
        device=device,
        test_dataloader=test_loader,
        net=net,
        loss_fns=loss_fns,
        loss_weights=loss_weights,
        metric_fns=metric_fns,
        parallel=parallel,
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
    cfg = load_config(config_path)
    return test_from_config(cfg) if test else train_from_config(cfg)


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
