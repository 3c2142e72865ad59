"""Composition root of the PyTorch port: run the test path from a config.

    python -m efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main CONFIG --test

The reference's ``configs/test/**.yaml`` files load unchanged.  The device
is the predictor's ``device`` kwarg: ``cuda:0`` (or any ``cuda``) is the
card, ``cpu`` the CPU, and no device means ``cuda``.  A CUDA device on a
machine without one raises; nothing falls back to the CPU.  On the card the
fp32 path keeps TF32 off for convolutions and matrix products: the JAX
package computes the SSIM filter at full precision, and the recurrent spine
would accumulate TF32 rounding over its 42 steps.

Training is ported in a later slice.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch

from .config import DATALOADERS, DATASETS, LOSSES, METRICS, NETS, PREDICTORS, Cfg, load_config

logger = logging.getLogger(__name__)


def _import_components():
    # populate the registries
    from . import data, losses, metrics, models  # noqa: F401
    from .runner import predictors  # noqa: F401


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


def train_from_config(cfg: Cfg):
    raise NotImplementedError("training is ported in a later slice")


def test_from_config(cfg: Cfg):
    _import_components()
    if cfg.get("parallel"):
        raise NotImplementedError("the `parallel:` section is not implemented in the PyTorch port yet")
    pred_kwargs = dict(cfg.predictor.get("kwargs") or {})
    device = resolve_device(pred_kwargs.pop("device", None))

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
        **pred_kwargs,
    )

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
