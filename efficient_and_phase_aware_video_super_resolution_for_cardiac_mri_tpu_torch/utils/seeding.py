"""Deterministic seeding discipline.

The port's copy of the JAX package's ``utils/seeding.py``: python's
``random`` is seeded with the config seed (possibly a string such as
``'vsr'``), the integer base seed is ``random.getstate()[1][1]``, and numpy
is reseeded per epoch from a pre-sampled list (reference ``src/main.py:31-36``,
``src/runner/trainers/base_trainer.py:49-54``).  Where the JAX package fans
the base seed out into a threefry key, the port makes a ``torch.Generator``;
the two give different weights from the same seed, so a parity test carries
the JAX package's initial weights across instead.
"""
from __future__ import annotations

import random
from dataclasses import asdict, dataclass, field

import numpy as np
import torch


@dataclass
class SeedState:
    """All RNG state derived from the config seed."""

    seed: object
    base_int: int
    np_random_seeds: list[int] = field(default_factory=list)

    def torch_generator(self) -> torch.Generator:
        """The CPU generator the net's initial weights are drawn from."""
        return torch.Generator().manual_seed(self.base_int % (2**31 - 1))

    def state_dict(self) -> dict:
        """Plain values, so a checkpoint loads with ``weights_only=True``."""
        return asdict(self)

    @classmethod
    def from_state_dict(cls, state: dict) -> "SeedState":
        return cls(**state)


def seed_everything(seed: object, num_epochs: int = 0) -> SeedState:
    """Seed python ``random`` and derive the integer base seed.

    Accepts the reference's string seeds (e.g. ``'vsr'``,
    ``configs/train/refine_net/exp1_x4.yaml:2``).  ``np_random_seeds`` is the
    per-epoch numpy reseeding list (``base_trainer.py:49-50``), checkpointed
    so resume is reproducible.
    """
    random.seed(seed)
    base_int = random.getstate()[1][1]
    np_random_seeds = random.sample(range(10000000), k=num_epochs) if num_epochs else []
    return SeedState(seed=seed, base_int=base_int, np_random_seeds=np_random_seeds)


def epoch_rng(state: SeedState, epoch: int) -> np.random.Generator:
    """Per-epoch numpy Generator (epoch is 1-based, as in the reference)."""
    if state.np_random_seeds:
        seed = state.np_random_seeds[epoch - 1]
    else:
        seed = (state.base_int + epoch) % (2**31 - 1)
    return np.random.default_rng(seed)


def item_rng(epoch_seed: int, index: int) -> np.random.Generator:
    """Deterministic per-item Generator for augmentations: a pure function of
    (epoch seed, item index), so runs are reproducible whatever the loader's
    parallelism."""
    return np.random.default_rng(np.random.SeedSequence([epoch_seed, index]))
