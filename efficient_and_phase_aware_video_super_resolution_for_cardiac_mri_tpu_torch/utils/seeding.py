"""Deterministic per-item randomness for the data loader."""
from __future__ import annotations

import numpy as np


def item_rng(epoch_seed: int, index: int) -> np.random.Generator:
    """Deterministic per-item Generator for augmentations: a pure function of
    (epoch seed, item index), so runs are reproducible whatever the loader's
    parallelism."""
    return np.random.default_rng(np.random.SeedSequence([epoch_seed, index]))
