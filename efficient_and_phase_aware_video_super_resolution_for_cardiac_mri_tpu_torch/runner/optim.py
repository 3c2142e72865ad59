"""Optimizers and LR schedulers under the reference's torch names.

The port's counterpart of the JAX package's ``runner/optim.py``.  Configs
name ``torch.optim`` classes (``optimizer: {name: 'Adam', ...}``, reference
``src/main.py:75-79``); here they are those classes themselves, which the
JAX package's optax variants imitate (its Adam is torch's coupled-L2 Adam,
``tests/test_optim_torch_parity.py``).
:class:`Optimizer` keeps the JAX package's surface: the config is read
first, ``init(params)`` makes the optimizer over the net's parameters, and
``set_lr`` is what an epoch-level scheduler calls.  ``grad_clip_norm`` clips
the global gradient norm before each update.

``skip_nonfinite: N`` is the JAX package's ``optax.apply_if_finite`` guard
(with optax's give-up-and-apply disabled): a step whose gradients hold a
NaN or an inf applies no update, so the parameters, the optimizer's state
and its step count are left as they were, and the clip sits inside the
guard.  The check, the skip and the two counters stay on the device, so a
step adds no host sync: one fused non-finite scan of the gradients
(``torch._amp_foreach_non_finite_check_and_unscale_`` at scale 1, which is
exact) gives a ``found_inf`` flag; Adam, AdamW and SGD then run fused and
take that flag themselves (their kernels skip the update and take back the
step increment on the device); the other optimizers run as configured and
their new parameters and state tensors are selected against the old ones
with ``torch.where``.  :meth:`Optimizer.check_nonfinite`, at an epoch
boundary, fetches the counters once.

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


#: the optimizers whose fused kernels take a ``found_inf`` flag
_FUSED_FOUND_INF = {"Adam", "AdamW", "SGD"}


class Optimizer:
    """A ``torch.optim`` class by name, its kwargs and the base lr."""

    def __init__(self, name: str, **kwargs):
        if name not in _DEFAULT_LR:
            raise KeyError(f"Unknown optimizer {name!r}. Available: {sorted(_DEFAULT_LR)}")
        lr = kwargs.pop("lr", None)
        self.name = name
        self.base_lr = _DEFAULT_LR[name] if lr is None else float(lr)
        self.grad_clip_norm = kwargs.pop("grad_clip_norm", None)
        self.skip_nonfinite = int(kwargs.pop("skip_nonfinite", 0) or 0)
        self.kwargs = kwargs

    def init(self, params) -> torch.optim.Optimizer:
        """The torch optimizer over ``params``, at the base lr; with
        ``skip_nonfinite`` it carries the guard's device counters
        ``nonfinite`` = [consecutive, total] skipped steps."""
        params = list(params)
        kwargs = dict(self.kwargs)
        if self.skip_nonfinite and self.name in _FUSED_FOUND_INF:
            kwargs["fused"] = True
        opt = getattr(torch.optim, self.name)(params, lr=self.base_lr, **kwargs)
        if self.skip_nonfinite:
            device = params[0].device if params else torch.device("cpu")
            opt.nonfinite = torch.zeros(2, dtype=torch.int64, device=device)
        return opt

    def step(self, opt: torch.optim.Optimizer) -> None:
        """One update from the gradients in ``.grad``, clipped first when
        ``grad_clip_norm`` is set; with ``skip_nonfinite`` none at all when
        a gradient is not finite."""
        params = [p for group in opt.param_groups for p in group["params"]]
        if not self.skip_nonfinite:
            if self.grad_clip_norm:
                torch.nn.utils.clip_grad_norm_(params, self.grad_clip_norm)
            opt.step()
            return
        found_inf = _found_inf(params, opt.nonfinite.device)
        if self.grad_clip_norm:
            torch.nn.utils.clip_grad_norm_(params, self.grad_clip_norm)
        if self.name in _FUSED_FOUND_INF:
            opt.found_inf = found_inf
            try:
                opt.step()
            finally:
                del opt.found_inf
        else:
            _masked_step(opt, params, found_inf)
        bad = found_inf.to(torch.int64)
        consecutive, total = opt.nonfinite.unbind()
        opt.nonfinite.copy_(torch.stack([(consecutive + 1) * bad, total + bad]))

    def check_nonfinite(self, opt: torch.optim.Optimizer) -> int:
        """Epoch-boundary guard for ``skip_nonfinite``: raise once N
        consecutive steps had non-finite gradients (every one of them was
        skipped, so the parameters are still clean), else return the total
        of skipped steps so far.  Costs one fetch of two integers."""
        if not self.skip_nonfinite or getattr(opt, "nonfinite", None) is None:
            return 0
        consecutive, total = (int(v) for v in opt.nonfinite.tolist())
        if consecutive >= self.skip_nonfinite:
            raise RuntimeError(
                f"{consecutive} consecutive non-finite gradient steps (the "
                f"configured skip_nonfinite limit is {self.skip_nonfinite}). "
                f"Every bad update was skipped — params and checkpoints are "
                f"finite — but the run has diverged; aborting."
            )
        return total

    @staticmethod
    def set_lr(opt: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
        for group in opt.param_groups:
            group["lr"] = float(lr)
        return opt

    @staticmethod
    def state_dict(opt: torch.optim.Optimizer) -> dict:
        """``opt.state_dict()`` plus the guard's counters (as integers)."""
        state = opt.state_dict()
        if getattr(opt, "nonfinite", None) is not None:
            state["nonfinite"] = [int(v) for v in opt.nonfinite.tolist()]
        return state

    @staticmethod
    def load_state_dict(opt: torch.optim.Optimizer, state: dict) -> None:
        state = dict(state)
        counters = state.pop("nonfinite", None)
        opt.load_state_dict(state)
        if counters is not None and getattr(opt, "nonfinite", None) is not None:
            opt.nonfinite.copy_(torch.tensor(counters, dtype=torch.int64))


def _found_inf(params, device) -> torch.Tensor:
    """1.0 on the device when any gradient holds a NaN or an inf, else 0.0
    (the unscale by 1 leaves every gradient bit for bit as it was)."""
    found = torch.zeros((), dtype=torch.float32, device=device)
    grads = [p.grad for p in params if p.grad is not None]
    by_device: dict = {}
    for g in grads:
        by_device.setdefault((g.device, g.dtype), []).append(g)
    for (dev, _), group in by_device.items():
        flag = torch.zeros((), dtype=torch.float32, device=dev)
        torch._amp_foreach_non_finite_check_and_unscale_(
            group, flag, torch.ones((), dtype=torch.float32, device=dev))
        found = torch.maximum(found, flag.to(device))
    return found


def _masked_step(opt: torch.optim.Optimizer, params, found_inf: torch.Tensor) -> None:
    """``opt.step()`` whose parameters and state tensors are kept as they
    were where ``found_inf`` is set (the optimizers without a fused flag)."""
    keep = found_inf.bool()
    old_params = [p.detach().clone() for p in params]
    old_state = {id(p): {k: v.clone() for k, v in opt.state[p].items()
                         if isinstance(v, torch.Tensor)}
                 for p in params if p in opt.state}
    opt.step()
    with torch.no_grad():
        for p, old in zip(params, old_params):
            p.copy_(torch.where(keep.to(p.device), old, p))
            for k, v in opt.state[p].items():
                if not isinstance(v, torch.Tensor):
                    continue
                before = old_state.get(id(p), {}).get(k)
                if before is None:  # first step: the state starts at zero
                    before = torch.zeros_like(v)
                v.copy_(torch.where(keep.to(v.device), before, v))


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
