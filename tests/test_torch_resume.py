"""The training remainders against the JAX package: ``skip_nonfinite`` and a
full resume of a JAX run.

* ``skip_nonfinite``: the same gradient sequence, with non-finite steps,
  through the JAX package's ``Optimizer`` (``optax.apply_if_finite``) and
  the port's, in the four optax nestings (with and without
  ``grad_clip_norm``, with and without ``weight_decay``): parameters and
  Adam's moments within 1e-6, counts and counters equal, and
  ``check_nonfinite`` raising at the same step.
* Resume: the JAX trainer trains and writes its pickle at epoch 1; the port
  resumes it (from other initial weights and other seeds) and its second
  epoch follows the JAX run's within ``tests/test_torch_train.py``'s
  trajectory tolerances (loss 1e-5, PSNR/SSIM 1e-4 relative), with Adam's
  ``step`` equal to optax's ``count`` and the seed state carried, in the
  four nestings of ``grad_clip_norm`` and ``skip_nonfinite``.
"""
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import losses as JL
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import metrics as JM
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.data.loader import (
    Dataloader as JaxDataloader,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.models import (
    RefineNet as JaxRefineNet,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner import (
    optim as jax_optim,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.monitor import (
    Monitor as JaxMonitor,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.trainers import (
    VSRRefineNetTrainer as JaxTrainer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import losses as PL
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import metrics as PM
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import (
    Dataloader,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
    RefineNet,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import (
    checkpoint as ckpt_io,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import optim
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.monitor import (
    Monitor,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.trainers import (
    VSRRefineNetTrainer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.seeding import (
    seed_everything,
)

sys.path.insert(0, str(Path(__file__).parent))
from torch_parallel_workers import ListDataset  # noqa: E402

NESTINGS = [{}, {"grad_clip_norm": 1.0}, {"weight_decay": 0.1},
            {"grad_clip_norm": 1.0, "weight_decay": 0.1}]
NESTING_IDS = ["adam", "clip", "decay", "clip_decay"]


def _optax_parts(state):
    """(ScaleByAdamState, ApplyIfFiniteState) of a JAX ``Optimizer`` state."""
    adam = [s for s in jax.tree.leaves(state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
    return adam[0], jax_optim._find_apply_if_finite(state)


@pytest.mark.parametrize("kwargs", NESTINGS, ids=NESTING_IDS)
def test_skip_nonfinite_matches_apply_if_finite(kwargs):
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(8)]
    grads[2][1, 1] = np.nan
    grads[5][0, 2] = np.inf
    grads[6][3, 0] = -np.inf
    grads[7][2, 2] = np.nan  # the third in a row: the limit of 3
    w0 = rng.standard_normal((4, 3)).astype(np.float32)

    jopt = jax_optim.Optimizer("Adam", lr=1e-2, skip_nonfinite=3, **kwargs)
    params = {"w": jnp.asarray(w0)}
    jstate = jopt.init(params)
    opt = optim.Optimizer("Adam", lr=1e-2, skip_nonfinite=3, **kwargs)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    state = opt.init([w])
    for i, g in enumerate(grads):
        w.grad = torch.from_numpy(g.copy())
        before = (w.detach().clone(), {k: v.clone() for k, v in state.state[w].items()})
        opt.step(state)
        updates, jstate = jopt.update({"w": jnp.asarray(g)}, jstate, params)
        params = optax.apply_updates(params, updates)
        adam, finite = _optax_parts(jstate)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]), rtol=1e-6,
                                   atol=1e-6, err_msg=f"step {i}")
        if adam.count:
            np.testing.assert_allclose(state.state[w]["exp_avg"].numpy(), np.asarray(adam.mu["w"]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(state.state[w]["exp_avg_sq"].numpy(),
                                       np.asarray(adam.nu["w"]), rtol=1e-6, atol=1e-7)
        assert int(state.state[w]["step"]) == int(adam.count)
        assert state.nonfinite.tolist() == [int(finite.notfinite_count),
                                            int(finite.total_notfinite)]
        if not np.isfinite(g).all():  # nothing moved, bit for bit
            assert torch.equal(w.detach(), before[0])
            for key, value in before[1].items():
                assert torch.equal(state.state[w][key], value), key
        if i < 7:
            assert opt.check_nonfinite(state) == jopt.check_nonfinite(jstate)
    with pytest.raises(RuntimeError, match="3 consecutive"):
        jopt.check_nonfinite(jstate)
    with pytest.raises(RuntimeError, match="3 consecutive"):
        opt.check_nonfinite(state)


def test_fused_guard_agrees_with_the_foreach_path():
    """``skip_nonfinite`` runs Adam fused (its ``found_inf``); on finite
    gradients the trajectory is the plain (foreach) Adam's within 1e-6."""
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((8, 5)).astype(np.float32)
    runs = []
    for kwargs in ({}, {"skip_nonfinite": 2}):
        opt = optim.Optimizer("Adam", lr=1e-2, **kwargs)
        w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        state = opt.init([w])
        assert bool(state.defaults["fused"]) == bool(kwargs)
        for i in range(12):
            w.grad = torch.from_numpy(np.random.default_rng(i).standard_normal((8, 5)).astype(np.float32))
            opt.step(state)
        runs.append(w.detach().numpy())
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-6, atol=1e-6)


def test_masked_optimizers_skip_bit_for_bit():
    """The optimizers without a fused flag (RMSprop here) keep their
    parameters and state through a non-finite step, and go on as a run
    that never saw it."""
    rng = np.random.default_rng(2)
    w0 = rng.standard_normal((3, 3)).astype(np.float32)
    grads = [rng.standard_normal((3, 3)).astype(np.float32) for _ in range(4)]
    bad = grads[1].copy()
    bad[0, 0] = np.nan
    runs = []
    for sequence in ([grads[0], bad, *grads[1:]], grads):
        opt = optim.Optimizer("RMSprop", lr=1e-2, skip_nonfinite=2)
        w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        state = opt.init([w])
        for g in sequence:
            w.grad = torch.from_numpy(g.copy())
            opt.step(state)
        runs.append((w.detach().clone(), {k: v.clone() for k, v in state.state[w].items()},
                     state.nonfinite.tolist()))
    (w_a, s_a, n_a), (w_b, s_b, n_b) = runs
    assert torch.equal(w_a, w_b) and n_a == [0, 1] and n_b == [0, 0]
    for key in s_b:
        assert torch.equal(s_a[key], s_b[key]), key


# --------------------------------------------------------------- trainers
TC, U, HW, SCALE, BATCH, LR = 3, 2, 6, 4, 4, 1e-3
NET = dict(in_channels=1, out_channels=1, num_features=[4, 4], num_stages=1,
           refine_window_size=5, upscale_factor=SCALE, update_memory=True,
           num_updated_frames=U, positional_encoding=True)


def _items(n=8, seed=4, poison=()):
    rng = np.random.default_rng(seed)
    T = TC + 2 * U
    items = [{"lr_imgs": rng.standard_normal((T, HW, HW, 1)).astype(np.float32),
              "hr_imgs": rng.standard_normal((TC, HW * SCALE, HW * SCALE, 1)).astype(np.float32),
              "pos_code": rng.uniform(-1, 1, (T, 1)).astype(np.float32)} for _ in range(n)]
    for i in poison:  # a NaN input: every gradient it reaches is NaN
        items[i]["lr_imgs"][0, 0, 0, 0] = np.nan
    return items


@pytest.fixture(scope="module")
def jax_params():
    items = _items(1)
    params = jax.jit(JaxRefineNet(**NET).init)(
        jax.random.PRNGKey(0), items[0]["lr_imgs"][None], items[0]["pos_code"][None])["params"]
    return jax.tree.map(np.asarray, params)


def _port_trainer(items, num_epochs, opt_kwargs, net_state=None, **kwargs):
    net = RefineNet(**NET)
    if net_state is not None:
        net.load_state_dict(net_state, strict=True)
    loader = Dataloader(ListDataset(items), batch_size=BATCH, shuffle=True)
    return VSRRefineNetTrainer(
        device="cpu", train_dataloader=loader, valid_dataloader=loader, net=net,
        loss_fns=[PL.L1Loss()], loss_weights=[1.0], metric_fns=[PM.PSNR(), PM.SSIM()],
        optimizer=optim.Optimizer("Adam", lr=LR, **opt_kwargs), num_epochs=num_epochs,
        telemetry=False, **kwargs)


def test_trainer_checks_nonfinite_at_the_epoch_boundary(caplog):
    """A poisoned batch is skipped and warned about after the train log;
    two consecutive poisoned batches with ``skip_nonfinite: 2`` abort at
    the epoch boundary, the parameters still finite."""
    trainer = _port_trainer(_items(poison=(0,)), 1, {"skip_nonfinite": 2})
    trainer.train_dataloader.shuffle = False
    with caplog.at_level(logging.WARNING):
        trainer.train()
    assert any("1 non-finite gradient steps skipped so far" in r.message for r in caplog.records)
    assert trainer.opt.nonfinite.tolist() == [0, 1]

    trainer = _port_trainer(_items(poison=(0, 4)), 1, {"skip_nonfinite": 2})
    trainer.train_dataloader.shuffle = False
    before = {k: v.clone() for k, v in trainer.net.state_dict().items()}
    with pytest.raises(RuntimeError, match="2 consecutive"):
        trainer.train()
    for key, value in trainer.net.state_dict().items():
        assert torch.equal(value, before[key]), key


RESUMES = [{}, {"grad_clip_norm": 0.5}, {"skip_nonfinite": 3},
           {"grad_clip_norm": 0.5, "skip_nonfinite": 3}]


@pytest.mark.parametrize("opt_kwargs", RESUMES, ids=["adam", "clip", "skip", "clip_skip"])
def test_port_resumes_a_jax_pickle(tmp_path, jax_params, opt_kwargs):
    items = _items(seed=7)
    loader = JaxDataloader(ListDataset(items), batch_size=BATCH, shuffle=True)
    jopt = jax_optim.Optimizer("Adam", lr=LR, **opt_kwargs)

    def jax_trainer(directory):
        return JaxTrainer(
            device="cpu", train_dataloader=loader, valid_dataloader=loader,
            net=JaxRefineNet(**NET), loss_fns=[JL.L1Loss()], loss_weights=[1.0],
            metric_fns=[JM.PSNR(), JM.SSIM()], optimizer=jopt, num_epochs=2,
            monitor=JaxMonitor(directory, "min", "Loss", saved_freq=1), telemetry=False)

    straight = jax_trainer(tmp_path / "jax")
    straight.params = jax.tree.map(jnp.asarray, jax_params)
    straight.opt_state = jopt.init(straight.params)
    straight.train()
    pickle_path = tmp_path / "jax" / "model_1.pth"
    assert not ckpt_io._is_torch_zipfile(pickle_path)

    # other weights and other seeds: only the checkpoint can bring them back
    port = _port_trainer(items, 2, opt_kwargs, seed_state=seed_everything("other", 2),
                         monitor=Monitor(tmp_path / "port", "min", "Loss", saved_freq=1))
    port.load(pickle_path)
    adam, finite = _optax_parts(straight_opt_state_at_epoch_1(pickle_path))
    assert port.epoch == 2
    assert port.seed_state.np_random_seeds == straight.seed_state.np_random_seeds
    assert port.seed_state.base_int == straight.seed_state.base_int
    states = list(port.opt.state.values())
    assert states and all(int(s["step"]) == int(adam.count) for s in states)
    assert port.opt.param_groups[0]["lr"] == pytest.approx(LR)
    if opt_kwargs.get("skip_nonfinite"):
        assert port.opt.nonfinite.tolist() == [int(finite.notfinite_count),
                                              int(finite.total_notfinite)]
    port.train()

    want, got = straight.history, port.history
    for split in ("train", "valid"):
        assert len(got[split]) == 1
        for key, tol in (("Loss", 1e-5), ("L1Loss", 1e-5), ("PSNR", 1e-4), ("SSIM", 1e-4)):
            assert got[split][0][key] == pytest.approx(want[split][1][key], rel=tol, abs=1e-7), \
                (split, key)
    want_state = state_dict_from_jax_params(jax.tree.map(np.asarray, straight.params))
    for name, value in port.net.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want_state[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)

    if not opt_kwargs:  # the JAX trainer resumes its own pickle the same way
        resumed = jax_trainer(tmp_path / "jax_resumed")
        resumed.load(pickle_path)
        resumed.train()
        assert resumed.history["train"][0]["Loss"] == pytest.approx(
            want["train"][1]["Loss"], rel=1e-6)


def straight_opt_state_at_epoch_1(path):
    """The optax state the JAX pickle holds (read with the JAX package's
    own loader)."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.checkpoint import (
        load_checkpoint,
    )

    return load_checkpoint(path)["optimizer"]
