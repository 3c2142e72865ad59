"""Helpers shared by the engines (the predictor in this slice; the trainer
of the training slice reuses them)."""
from __future__ import annotations

import torch

from ..utils.stats import denormalize


def denorm_uint8(x: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """Reference denormalize (``src/utils.py:19``): back to rounded, clipped
    [0, 255] intensity before metric computation."""
    return denormalize(x, mean=mean, std=std)


def init_log(loss_fns, metric_fns) -> dict:
    """Zeroed epoch log: Loss + one entry per loss/metric, reference order."""
    log = {"Loss": 0.0}
    for fn in loss_fns:
        log[fn.name] = 0.0
    for fn in metric_fns:
        log[fn.name] = 0.0
    return log


def register_dataset_variants(registry, workload: str, suffix: str, cls) -> None:
    """Register the Acdc/Dsb15 twins of a workload engine under the
    reference's naming scheme (e.g. ``AcdcVSRRefineNetPredictor``) with the
    matching dataset stats baked in."""
    for prefix, stats in (("Acdc", "acdc"), ("Dsb15", "dsb15")):
        name = f"{prefix}{workload}{suffix}"
        registry.add(name, type(name, (cls,), {"dataset_stats": stats}))
