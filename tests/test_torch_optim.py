"""The port's seeding, optimizer, LR schedulers and checkpoint monitor against
the JAX package's.

* ``seed_everything('vsr', 5)`` gives the JAX package's base seed and
  per-epoch numpy seeds; ``epoch_rng`` the same draws.
* Each scheduler gives the same lr, epoch by epoch, over a scripted sequence
  of valid losses (exactly: the same Python arithmetic), also across a
  ``state_dict`` round trip.
* The ``Monitor`` makes the same save / best / early-stop decisions.
* The optimizer: torch's Adam (coupled L2) and the JAX package's optax
  transform take the same steps from the same gradients, with an lr change
  and a global-norm clip, at rtol 1e-5 (float32, different operation order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner import (
    optim as jax_optim,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.monitor import (
    Monitor as JaxMonitor,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.seeding import (
    epoch_rng as jax_epoch_rng,
    seed_everything as jax_seed_everything,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import (
    LR_SCHEDULERS,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import optim
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.monitor import (
    Monitor,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.seeding import (
    SeedState,
    epoch_rng,
    seed_everything,
)

VALID_LOSSES = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.85, 0.86, 0.87, 0.88, 0.89, 0.9, 0.5, 0.5]


@pytest.mark.parametrize("seed", ["vsr", 7])
def test_seed_everything_equals_jax(seed):
    got, want = seed_everything(seed, 5), jax_seed_everything(seed, 5)
    assert (got.seed, got.base_int, got.np_random_seeds) == (
        want.seed, want.base_int, want.np_random_seeds)
    for epoch in (1, 5):
        np.testing.assert_array_equal(epoch_rng(got, epoch).random(4),
                                      jax_epoch_rng(want, epoch).random(4))
    assert SeedState.from_state_dict(got.state_dict()) == got
    a, b = got.torch_generator(), got.torch_generator()
    assert torch.equal(torch.rand(3, generator=a), torch.rand(3, generator=b))


@pytest.mark.parametrize("name,kwargs", [
    ("StepLR", {"step_size": 3, "gamma": 0.5}),
    ("MultiStepLR", {"milestones": [5, 2, 9], "gamma": 0.3}),
    ("ExponentialLR", {"gamma": 0.9}),
    ("CosineAnnealingLR", {"T_max": 7, "eta_min": 1e-4}),
    ("ReduceLROnPlateau", {"patience": 1, "cooldown": 2, "factor": 0.5}),
    ("ReduceLROnPlateau", {"mode": "max", "patience": 0, "threshold_mode": "abs",
                           "threshold": 0.01}),
])
def test_scheduler_equals_jax(name, kwargs):
    got = LR_SCHEDULERS.get(name)(0.1, **kwargs)
    want = jax_optim.LR_SCHEDULERS.get(name)(0.1, **kwargs)
    lrs_got, lrs_want = [], []
    for i, loss in enumerate(VALID_LOSSES):
        lrs_got.append(got.step(loss))
        lrs_want.append(want.step(loss))
        if i == 6:  # resume mid-run from the state_dict
            fresh = LR_SCHEDULERS.get(name)(0.1, **kwargs)
            fresh.load_state_dict(got.state_dict())
            got = fresh
    assert lrs_got == lrs_want
    assert len(set(lrs_got)) > 1  # the schedule moves


def test_monitor_decisions_equal_jax(tmp_path):
    kwargs = dict(mode="min", target="Loss", saved_freq=2, early_stop=3)
    got, want = Monitor(tmp_path / "a", **kwargs), JaxMonitor(tmp_path / "b", **kwargs)
    decisions = []
    for epoch, loss in enumerate(VALID_LOSSES, 1):
        row = []
        for m in (got, want):
            saved, best = m.is_saved(epoch), m.is_best({"Loss": loss})
            row.append((saved and saved.name, best and best.name, m.is_early_stopped()))
        assert row[0] == row[1], epoch
        decisions.append(row[0])
        if row[0][2]:
            break
    assert decisions[-1][2] and any(d[1] for d in decisions) and any(d[0] for d in decisions)
    assert got.state_dict() == want.state_dict()
    fresh = Monitor(tmp_path / "c", mode="max", target="PSNR", saved_freq=1)
    fresh.load_state_dict(got.state_dict())
    assert fresh.state_dict() == got.state_dict()


@pytest.mark.parametrize("kwargs", [
    {"lr": 1e-2, "weight_decay": 1e-2},
    {"lr": 1e-2, "betas": (0.8, 0.99), "grad_clip_norm": 0.5},
])
def test_adam_steps_equal_jax(kwargs):
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(6)]

    opt = optim.Optimizer("Adam", **kwargs)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    state = opt.init([w])
    jopt = jax_optim.Optimizer("Adam", **kwargs)
    params = {"w": jnp.asarray(w0)}
    jstate = jopt.init(params)
    for i, g in enumerate(grads):
        if i == 3:  # an epoch-level scheduler's lr change
            opt.set_lr(state, 3e-3)
            jstate = jopt.set_lr(jstate, 3e-3)
        w.grad = torch.from_numpy(g.copy())
        opt.step(state)
        updates, jstate = jopt.update({"w": jnp.asarray(g)}, jstate, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]), rtol=1e-5,
                                   atol=1e-6, err_msg=f"step {i}")
    assert not np.allclose(w.detach().numpy(), w0)


def test_optimizer_names_defaults_and_deferred_knob():
    for name in ("Adam", "AdamW", "SGD", "RMSprop", "Adagrad", "Adadelta", "Adamax", "NAdam"):
        opt = optim.Optimizer(name)
        assert opt.base_lr == jax_optim.Optimizer(name).base_lr  # torch's default lr
        assert type(opt.init([torch.nn.Parameter(torch.zeros(2))])) is getattr(torch.optim, name)
    with pytest.raises(KeyError):
        optim.Optimizer("LBFGS")
    with pytest.raises(NotImplementedError, match="skip_nonfinite"):
        optim.Optimizer("Adam", skip_nonfinite=3)
    assert optim.build_lr_scheduler(None, 0.1) is None
