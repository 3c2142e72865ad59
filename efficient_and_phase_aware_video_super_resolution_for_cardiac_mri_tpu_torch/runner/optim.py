"""Optimizers and LR schedulers under the reference's torch names.

The port's counterpart of the JAX package's ``runner/optim.py``.  Configs
name ``torch.optim`` classes (``optimizer: {name: 'Adam', ...}``, reference
``src/main.py:75-79``); here they are those classes themselves, which the
JAX package's optax variants imitate (its Adam is torch's coupled-L2 Adam,
``tests/test_optim_torch_parity.py``).
:class:`Optimizer` keeps the JAX package's surface: the config is read
first, ``init(params)`` makes the optimizer over the net's parameters, and
``set_lr`` is what an epoch-level scheduler calls.  ``grad_clip_norm`` clips
the global gradient norm before each update; ``skip_nonfinite`` is not
ported yet.

The schedulers are copies of the JAX package's, with torch's per-epoch
semantics, including the ``ReduceLROnPlateau`` branch the reference declares
but cannot run (``base_trainer.py:67``, SURVEY.md §5 quirk 1).
"""
from __future__ import annotations

import math

import torch

from ..config import LR_SCHEDULERS

# torch's per-class default lr (used when a config omits ``lr``, mirroring the
# reference's reflection call with defaulted kwargs)
_DEFAULT_LR = {
    "Adam": 1e-3, "AdamW": 1e-3, "SGD": 1e-3, "RMSprop": 1e-2,
    "Adagrad": 1e-2, "Adadelta": 1.0, "Adamax": 2e-3, "NAdam": 2e-3,
}


class Optimizer:
    """A ``torch.optim`` class by name, its kwargs and the base lr."""

    def __init__(self, name: str, **kwargs):
        if name not in _DEFAULT_LR:
            raise KeyError(f"Unknown optimizer {name!r}. Available: {sorted(_DEFAULT_LR)}")
        if kwargs.pop("skip_nonfinite", 0):
            raise NotImplementedError(
                "optimizer knob skip_nonfinite is not implemented in the PyTorch port yet "
                "(ROADMAP queue 1, item 6)"
            )
        lr = kwargs.pop("lr", None)
        self.name = name
        self.base_lr = _DEFAULT_LR[name] if lr is None else float(lr)
        self.grad_clip_norm = kwargs.pop("grad_clip_norm", None)
        self.kwargs = kwargs

    def init(self, params) -> torch.optim.Optimizer:
        """The torch optimizer over ``params``, at the base lr."""
        return getattr(torch.optim, self.name)(list(params), lr=self.base_lr, **self.kwargs)

    def step(self, opt: torch.optim.Optimizer) -> None:
        """One update from the gradients in ``.grad``, clipped first when
        ``grad_clip_norm`` is set."""
        if self.grad_clip_norm:
            params = [p for group in opt.param_groups for p in group["params"]]
            torch.nn.utils.clip_grad_norm_(params, self.grad_clip_norm)
        opt.step()

    @staticmethod
    def set_lr(opt: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
        for group in opt.param_groups:
            group["lr"] = float(lr)
        return opt


class LRScheduler:
    """Epoch-indexed lr schedule with torch state-dict semantics."""

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.last_epoch = 0

    def step(self, valid_loss: float | None = None) -> float:
        self.last_epoch += 1
        return self.get_lr()

    def get_lr(self) -> float:
        raise NotImplementedError

    def state_dict(self) -> dict:
        return dict(self.__dict__)

    def load_state_dict(self, state: dict):
        self.__dict__.update(state)


@LR_SCHEDULERS.register()
class StepLR(LRScheduler):
    def __init__(self, base_lr, step_size, gamma=0.1):
        super().__init__(base_lr)
        self.step_size, self.gamma = step_size, gamma

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


@LR_SCHEDULERS.register()
class MultiStepLR(LRScheduler):
    def __init__(self, base_lr, milestones, gamma=0.1):
        super().__init__(base_lr)
        self.milestones, self.gamma = sorted(milestones), gamma

    def get_lr(self):
        n = sum(1 for m in self.milestones if m <= self.last_epoch)
        return self.base_lr * self.gamma**n


@LR_SCHEDULERS.register()
class ExponentialLR(LRScheduler):
    def __init__(self, base_lr, gamma):
        super().__init__(base_lr)
        self.gamma = gamma

    def get_lr(self):
        return self.base_lr * self.gamma**self.last_epoch


@LR_SCHEDULERS.register()
class CosineAnnealingLR(LRScheduler):
    def __init__(self, base_lr, T_max, eta_min=0.0):
        super().__init__(base_lr)
        self.T_max, self.eta_min = T_max, eta_min

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)
        ) / 2


@LR_SCHEDULERS.register()
class ReduceLROnPlateau(LRScheduler):
    """torch ``ReduceLROnPlateau`` semantics: default ``threshold_mode='rel'``
    (improvement must beat ``best·(1∓threshold)``, not ``best∓threshold``)
    plus the ``cooldown`` epochs after each LR drop during which bad epochs
    are not counted."""

    def __init__(self, base_lr, mode="min", factor=0.1, patience=10, min_lr=0.0,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, eps=1e-8):
        super().__init__(base_lr)
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold_mode should be 'rel' or 'abs'. Got {threshold_mode}.")
        self.mode, self.factor, self.patience = mode, factor, patience
        self.min_lr, self.threshold = min_lr, threshold
        self.threshold_mode, self.cooldown = threshold_mode, cooldown
        self.eps = eps
        self.current_lr = base_lr
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad = 0
        self.cooldown_counter = 0

    def _is_better(self, value):
        # torch lr_scheduler.ReduceLROnPlateau.is_better
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return value < self.best * (1.0 - self.threshold)
            return value < self.best - self.threshold
        if self.threshold_mode == "rel":
            return value > self.best * (1.0 + self.threshold)
        return value > self.best + self.threshold

    def step(self, valid_loss=None):
        self.last_epoch += 1
        if valid_loss is None:
            return self.current_lr
        # exact statement order of torch's ReduceLROnPlateau.step: the bad
        # count increments regardless, cooldown then zeroes it (and ticks
        # down even on improving epochs)
        if self._is_better(valid_loss):
            self.best = valid_loss
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            new_lr = max(self.min_lr, self.current_lr * self.factor)
            if self.current_lr - new_lr > self.eps:  # torch _reduce_lr eps
                self.current_lr = new_lr
            self.num_bad = 0
            self.cooldown_counter = self.cooldown
        return self.current_lr

    def get_lr(self):
        return self.current_lr


def build_optimizer(config) -> Optimizer:
    return Optimizer(config["name"], **dict(config.get("kwargs") or {}))


def build_lr_scheduler(config, base_lr: float) -> LRScheduler | None:
    if not config:
        return None
    cls = LR_SCHEDULERS.get(config["name"])
    return cls(base_lr, **dict(config.get("kwargs") or {}))
