"""Checkpoint policy monitor (reference ``src/callbacks/monitor.py:4-63``).

The port's copy of the JAX package's ``runner/monitor.py``: periodic saves
every ``saved_freq`` epochs to ``model_{epoch}.pth``, best-tracking on a
validation log key to ``model_best.pth``, early stop after ``early_stop``
non-improving epochs (0 = never).  Its state goes into checkpoints so the
best score survives a resume (reference ``base_trainer.py:233``).
"""
from __future__ import annotations

import math
from pathlib import Path

from ..config import MONITORS


@MONITORS.register()
class Monitor:
    def __init__(self, checkpoints_dir, mode, target, saved_freq, early_stop=0):
        if mode not in ("max", "min"):
            raise ValueError(f"The mode should be 'max' or 'min'. Got {mode}.")
        self.checkpoints_dir = Path(checkpoints_dir)
        self.mode = mode
        self.target = target
        self.saved_freq = saved_freq
        self.early_stop = math.inf if early_stop == 0 else early_stop
        self.best = -math.inf if mode == "max" else math.inf
        self.not_improved_count = 0
        self.checkpoints_dir.mkdir(parents=True, exist_ok=True)

    def is_saved(self, epoch: int) -> Path | None:
        if epoch % self.saved_freq == 0:
            return self.checkpoints_dir / f"model_{epoch}.pth"
        return None

    def is_best(self, valid_log: dict) -> Path | None:
        score = valid_log[self.target]
        improved = score > self.best if self.mode == "max" else score < self.best
        if improved:
            self.best = score
            self.not_improved_count = 0
            return self.checkpoints_dir / "model_best.pth"
        self.not_improved_count += 1
        return None

    def is_early_stopped(self) -> bool:
        return self.not_improved_count == self.early_stop

    def state_dict(self) -> dict:
        return {
            "mode": self.mode,
            "target": self.target,
            "saved_freq": self.saved_freq,
            "early_stop": self.early_stop,
            "best": self.best,
            "not_improved_count": self.not_improved_count,
        }

    def load_state_dict(self, state: dict):
        for k, v in state.items():
            setattr(self, k, v)
