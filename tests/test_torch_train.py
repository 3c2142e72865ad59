"""The PyTorch port's training path against the JAX package's, on the CPU.

* Trajectory: the JAX ``VSRRefineNetTrainer`` and the port's, from the same
  initial weights (JAX's ``PRNGKey(0)`` init carried across by
  ``state_dict_from_jax_params``), over the same 8 numpy items at batch 4
  for 6 epochs (12 Adam steps at lr 1e-4), through the whole epoch protocol
  (``train()``: reseed, train epoch, valid epoch).  The per-epoch train
  ``Loss`` and the validation tail (every epoch's valid ``Loss``) must agree
  at rtol 1e-5 / atol 1e-7, the tolerance of
  ``tests/test_train_dynamics_parity.py`` (measured: 5.7e-7 train, 7.5e-7
  valid); PSNR/SSIM on denormalised uint8 frames at rtol 1e-4 (a rounding to
  uint8 may flip on an ulp; measured 1.8e-7 / 4.4e-6).  The trajectory must
  move by more than 1e-4.
* Gradients of one step: every parameter's gradient equals ``jax.grad`` of
  the JAX trainer's own stage-discounted loss at atol 5e-5 / rtol 1e-4 (the
  gradient tolerance of ``tests/test_torch_refine_net.py``).
* Resume: 3 epochs straight equal 2 epochs, a preemption checkpoint, a fresh
  trainer loaded from it and 1 more epoch, exactly; the wall-clock budget
  preempts after an epoch, and auto-resume prefers that checkpoint.
* CLI: ``train_from_config`` on a ``make_acdc_tree`` tree writes
  ``model_best.pth``; the JAX package's ``load_net_variables(path,
  "RefineNet")`` reads it and its forward equals the port's; ``loaded_path:
  auto`` resumes at epoch 3.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import losses as JL
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import metrics as JM
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.data.loader import (
    Dataloader as JaxDataloader,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.models import (
    RefineNet as JaxRefineNet,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.checkpoint import (
    load_net_variables,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.optim import (
    Optimizer as JaxOptimizer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.trainers import (
    VSRRefineNetTrainer as JaxTrainer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import losses as PL
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import metrics as PM
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import Cfg
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import (
    Dataloader,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
    train_from_config,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
    RefineNet,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.checkpoint import (
    find_latest_checkpoint,
    load_checkpoint,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.monitor import (
    Monitor,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.optim import (
    Optimizer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.trainers import (
    VSRRefineNetTrainer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)
from fixtures import make_acdc_tree

LR, N_ITEMS, BATCH, EPOCHS = 1e-4, 8, 4, 6  # 2 steps an epoch × 6 = 12 Adam steps
TC, U, HW, SCALE = 5, 3, 8, 4
NET = dict(in_channels=1, out_channels=1, num_features=[6, 6], num_stages=2,
           refine_window_size=5, upscale_factor=SCALE, update_memory=True,
           num_updated_frames=U, memory=True, positional_encoding=True)


class _ListDataset:
    """In-memory items (channels-last numpy), for both frameworks' loaders."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _items(seed=4, n=N_ITEMS):
    rng = np.random.default_rng(seed)
    T = TC + 2 * U
    return [{
        "lr_imgs": rng.standard_normal((T, HW, HW, 1)).astype(np.float32),
        "hr_imgs": rng.standard_normal((TC, HW * SCALE, HW * SCALE, 1)).astype(np.float32),
        "pos_code": rng.uniform(-1, 1, (T, 1)).astype(np.float32),
    } for _ in range(n)]


@pytest.fixture(scope="module")
def jax_params():
    items = _items()
    lr = np.stack([it["lr_imgs"] for it in items[:BATCH]])
    pos = np.stack([it["pos_code"] for it in items[:BATCH]])
    params = jax.jit(JaxRefineNet(**NET).init)(jax.random.PRNGKey(0), lr, pos)["params"]
    return jax.tree.map(np.asarray, params)


def _port_net(jax_params):
    net = RefineNet(**NET)
    net.load_state_dict(state_dict_from_jax_params(jax_params), strict=True)
    return net


def _port_trainer(net, items, num_epochs, shuffle=False, **kwargs):
    loader = Dataloader(_ListDataset(items), batch_size=BATCH, shuffle=shuffle)
    return VSRRefineNetTrainer(
        device="cpu", train_dataloader=loader, valid_dataloader=loader, net=net,
        loss_fns=[PL.L1Loss()], loss_weights=[1.0], metric_fns=[PM.PSNR(), PM.SSIM()],
        optimizer=Optimizer("Adam", lr=LR, weight_decay=0), num_epochs=num_epochs, **kwargs,
    )


def test_trajectory_matches_jax_trainer(jax_params):
    items = _items()
    jax_loader = JaxDataloader(_ListDataset(items), batch_size=BATCH, shuffle=False)
    optimizer = JaxOptimizer("Adam", lr=LR, weight_decay=0)
    jax_trainer = JaxTrainer(
        device="cpu", train_dataloader=jax_loader, valid_dataloader=jax_loader,
        net=JaxRefineNet(**NET), loss_fns=[JL.L1Loss()], loss_weights=[1.0],
        metric_fns=[JM.PSNR(), JM.SSIM()], optimizer=optimizer, num_epochs=EPOCHS,
    )
    jax_trainer.params = jax.tree.map(jnp.asarray, jax_params)
    jax_trainer.opt_state = optimizer.init(jax_trainer.params)
    jax_trainer.train()

    trainer = _port_trainer(_port_net(jax_params), items, EPOCHS)
    trainer.train()

    for split in ("train", "valid"):
        want, got = jax_trainer.history[split], trainer.history[split]
        assert len(got) == len(want) == EPOCHS
        assert [list(g) for g in got] == [list(w) for w in want] == [["Loss", "L1Loss", "PSNR", "SSIM"]] * EPOCHS
        for key, tol in (("Loss", 1e-5), ("L1Loss", 1e-5), ("PSNR", 1e-4), ("SSIM", 1e-4)):
            np.testing.assert_allclose([g[key] for g in got], [w[key] for w in want],
                                       rtol=tol, atol=1e-7, err_msg=f"{split} {key}")
    train_loss = [h["Loss"] for h in trainer.history["train"]]
    assert abs(train_loss[0] - train_loss[-1]) > 1e-4  # the trajectory moves
    assert trainer.throughput["frames_per_sec"] > 0


def test_one_step_gradients_match_jax_grad(jax_params):
    items = _items(seed=9)[:BATCH]
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    jax_net = JaxRefineNet(**NET)
    jax_trainer = JaxTrainer(device="cpu", net=jax_net, loss_fns=[JL.L1Loss()], num_epochs=1)

    def total(params):
        outputs = jax_net.apply({"params": params}, batch["lr_imgs"], batch["pos_code"])
        return sum(jax_trainer._compute_losses(outputs, batch, True))

    params = jax.tree.map(jnp.asarray, jax_params)
    want_loss, jax_grads = jax.jit(jax.value_and_grad(total))(params)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jax_grads))

    trainer = _port_trainer(_port_net(jax_params), items, 1)
    loss, *_ = trainer._forward(batch, True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    grads = {name: p.grad for name, p in trainer.net.named_parameters()}
    assert grads.pop("refine_block.prelu.weight") is None  # dead parameter (quirk 3)
    assert grads.keys() <= want.keys() and len(grads) == len(want) - 1
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-5, rtol=1e-4,
                                   err_msg=name)


def test_resume_reproduces_the_uninterrupted_run(tmp_path, jax_params):
    items = _items(seed=5)
    straight = _port_trainer(_port_net(jax_params), items, 3, shuffle=True,
                             monitor=Monitor(tmp_path / "a", "min", "Loss", saved_freq=1))
    straight.train()

    first = _port_trainer(_port_net(jax_params), items, 3, shuffle=True, preempt_after_epochs=2,
                          monitor=Monitor(tmp_path / "b", "min", "Loss", saved_freq=1))
    first.train()
    assert len(first.history["train"]) == 2
    preempted = tmp_path / "b" / "model_preempted.pth"
    assert load_checkpoint(preempted)["epoch"] == 2

    fresh = RefineNet(**NET, generator=torch.Generator().manual_seed(99))
    resumed = _port_trainer(fresh, items, 3, shuffle=True,
                            monitor=Monitor(tmp_path / "b", "min", "Loss", saved_freq=1))
    resumed.load(preempted)
    assert resumed.epoch == 3
    resumed.train()
    assert len(resumed.history["train"]) == 1
    assert resumed.history["train"][0] == straight.history["train"][2]
    assert resumed.history["valid"][0] == straight.history["valid"][2]
    for (name, a), b in zip(straight.net.state_dict().items(), resumed.net.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)
    assert resumed.monitor.state_dict() == straight.monitor.state_dict()


def test_wall_clock_budget_preempts_and_auto_resume_prefers_the_preemption_checkpoint(
        tmp_path, jax_params):
    trainer = _port_trainer(_port_net(jax_params), _items(seed=6), 3, preempt_after_seconds=1e-9,
                            monitor=Monitor(tmp_path, "min", "Loss", saved_freq=1))
    trainer.train()
    assert len(trainer.history["train"]) == 1  # the budget is checked after each epoch
    assert {p.name for p in tmp_path.iterdir()} == {"model_1.pth", "model_best.pth",
                                                    "model_preempted.pth"}
    assert find_latest_checkpoint(tmp_path) == tmp_path / "model_preempted.pth"
    (tmp_path / "model_preempted.pth").unlink()
    assert find_latest_checkpoint(tmp_path) == tmp_path / "model_1.pth"
    assert find_latest_checkpoint(tmp_path / "missing") is None


def _cli_cfg(tree, saved_dir, num_epochs, loaded_path=None):
    return {
        "main": {"random_seed": "vsr", "saved_dir": str(saved_dir), "loaded_path": loaded_path},
        "dataset": {
            "name": "AcdcVSRRefineNetDataset",
            "kwargs": {
                "data_dir": str(tree["videos_dir"]), "downscale_factor": SCALE,
                "transforms": [
                    {"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                    {"name": "ToTensor"},
                ],
                "augments": [
                    {"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
                    {"name": "RandomCropPatch", "kwargs": {"size": [6, 6], "ratio": SCALE}},
                ],
                "num_frames": 3, "num_updated_frames": 2,
                "pos_code_path": str(tree["pos_code_path"]),
            },
        },
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"train_batch_size": 4, "valid_batch_size": 1, "shuffle": True,
                                  "num_workers": 2}},
        "net": {"name": "RefineNet",
                "kwargs": {**NET, "num_features": [4, 4], "num_updated_frames": 2}},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [{"name": "PSNR"}, {"name": "SSIM"}],
        "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-3, "weight_decay": 0}},
        "logger": {"name": "AcdcVSRLogger", "kwargs": {"dummy_input": [4, 1, 6, 6]}},
        "monitor": {"name": "Monitor",
                    "kwargs": {"mode": "min", "target": "Loss", "saved_freq": 2, "early_stop": 0}},
        "trainer": {"name": "AcdcVSRRefineNetTrainer",
                    "kwargs": {"device": "cpu", "num_epochs": num_epochs}},
    }


def test_train_from_config_writes_checkpoints_jax_reads_and_auto_resumes(tmp_path):
    tree = make_acdc_tree(tmp_path / "acdc", patients_per_split=1, slices=2, frames=6,
                          hr_size=(32, 32), splits=("train", "valid"))
    saved = tmp_path / "run"
    trainer = train_from_config(Cfg(_cli_cfg(tree, saved, 2)))
    assert trainer.device == torch.device("cpu")
    assert len(trainer.history["train"]) == 2
    assert all(np.isfinite(v) for h in trainer.history["train"] + trainer.history["valid"]
               for v in h.values())
    ckpts = saved / "checkpoints"
    assert (ckpts / "model_best.pth").is_file() and (ckpts / "model_2.pth").is_file()
    assert any((saved / "log").iterdir())  # the tensorboardX event file

    # the JAX package reads the port's checkpoint; its forward equals the port's
    best = load_checkpoint(ckpts / "model_best.pth")
    variables = load_net_variables(ckpts / "model_best.pth", "RefineNet")
    net_kwargs = _cli_cfg(tree, saved, 2)["net"]["kwargs"]
    net = RefineNet(**net_kwargs)
    net.load_state_dict(best["net"], strict=True)
    rng = np.random.default_rng(3)
    lr = rng.standard_normal((1, 3 + 4, 6, 6, 1)).astype(np.float32)
    pos = rng.uniform(-1, 1, (1, 3 + 4, 1)).astype(np.float32)
    want = jax.jit(JaxRefineNet(**net_kwargs).apply)(variables, lr, pos)
    with torch.inference_mode():
        got = net(torch.from_numpy(lr), torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5, rtol=1e-4)

    # model_2.pth is the newest: the resumed run trains epoch 3 only
    resumed = train_from_config(Cfg(_cli_cfg(tree, saved, 3, loaded_path="auto")))
    assert len(resumed.history["train"]) == 1 and resumed.epoch == 4
