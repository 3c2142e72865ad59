"""Dataset statistics and denormalization (numpy arrays or torch tensors)."""
from __future__ import annotations

import numpy as np
import torch

# Reference values: src/utils.py:13-16 of the original framework.
DATASET_STATS = {
    "acdc": {"mean": 54.089, "std": 48.084},
    "dsb15": {"mean": 51.193, "std": 52.671},
}


def get_stats(dataset: str) -> tuple[float, float]:
    if dataset not in DATASET_STATS:
        raise ValueError(
            f"The name of the dataset should be one of {sorted(DATASET_STATS)}. Got {dataset}."
        )
    s = DATASET_STATS[dataset]
    return s["mean"], s["std"]


def denormalize(imgs, dataset: str = "acdc", mean: float | None = None, std: float | None = None):
    """``(x * std + mean).round().clamp(0, 255)`` on a numpy array or a tensor."""
    if mean is None or std is None:
        mean, std = get_stats(dataset)
    if isinstance(imgs, torch.Tensor):
        return torch.clamp(torch.round(imgs * std + mean), 0, 255)
    return np.clip(np.round(imgs * std + mean), 0, 255)
