"""The PyTorch port's multi-frame workload (DUF, RBPN, TOFlow) against the JAX package's, on the CPU.

* Data: ``_window`` (every branch of the reference's circular wrap, a
  window longer than the sequence included) and ``MISRDataset`` items and
  shuffled, augmented ``Dataloader`` batches exactly equal to the JAX
  package's on one ``make_acdc_tree`` videos tree.
* Serving: ``test_from_config`` of each net from a ``{'net': state_dict}``
  ``.pth`` of the JAX init (BatchNorm statistics moved off their init
  values), and of DUF from the JAX package's pickle checkpoint, whose
  ``model_state['batch_stats']`` it must serve with.  The Test log and
  ``results.csv`` match the JAX predictor's at rtol/atol 2e-3 and the
  PNG/GIF pixels within one gray level, as ``tests/test_torch_sisr_runner.py``
  holds the single-image family; the files have the JAX package's names.
* Training: the JAX ``MISRTrainer`` and the port's from the same weights
  over the same 8 numpy windows at batch 4 for 6 epochs (12 Adam steps at
  lr 1e-4): every epoch's train and valid log at the tolerances below, and
  the running statistics at the end.
* bf16: one RBPN step (SGD, so the update is the gradient) with
  ``compute_dtype: bfloat16`` and ``grad_accum_steps: 2``, and TOFlow's
  ``max_flow: 4`` serving forward in bf16, each by the ratio rule of
  ``tests/test_torch_tpu_knobs.py``: the port's bf16-vs-fp32 gap is 0.6-1.5×
  JAX's.  A bf16 DUF step moves the fp32 running statistics as the fp32 step
  does.
* Fault repairs: a checkpoint directory written by the JAX package's
  ``save_checkpoint`` (``model_5.pth``, ``model_preempted.pth`` at epoch 7)
  resumes from the preempted file at epoch 8 under ``loaded_path: auto``;
  the frame logger writes its events through ``torch.utils.tensorboard``
  where tensorboardX does not import.
* The zoo: every duf/rbp/toflow YAML of ``configs/`` (29) resolves, and its
  net (at the published width, with the JAX net's parameter count and a
  forward), losses, metrics, dataset (one item), dataloader and trainer or
  predictor construct through the port's registries.
"""
import csv
import functools
import math
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
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import models as jax_models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.config import (
    Cfg as JaxCfg,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.data import (
    Dataloader as JaxDataloader,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.data import (
    datasets as jax_datasets,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.main import (
    test_from_config as run_jax_test,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner import (
    trainers as jax_trainers,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.optim import (
    Optimizer as JaxOptimizer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.casting import (
    cast_floating as jax_cast_floating,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.seeding import (
    seed_everything as jax_seed_everything,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import losses as PL
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import metrics as PM
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import (
    DATALOADERS,
    DATASETS,
    LOGGERS,
    LOSSES,
    METRICS,
    MONITORS,
    NETS,
    PREDICTORS,
    TRAINERS,
    Cfg,
    load_config,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import (
    Dataloader,
    MISRDataset,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import (
    datasets,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
    _import_components,
    test_from_config as run_port_test,
    train_from_config,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import (
    loggers,
    trainers,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.checkpoint import (
    find_latest_checkpoint,
    load_checkpoint,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.optim import (
    Optimizer,
    build_optimizer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.casting import (
    forward_in,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)
from fixtures import make_acdc_tree
from gray_frames import gif_frames, png_frame
from jax_data_caches import empty_jax_data_caches  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FRAMES, SCALE, LR_HW = 8, 4, 8
NORM = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
        {"name": "ToTensor"}]
NETS_SMALL = {  # the nets of tests/test_torch_misr_nets.py at x4
    "DUFNet": dict(in_channels=1, out_channels=1, num_frames=7, size_filter=5, upscale_factor=SCALE,
                   backbone="_DenseLayer16"),
    "RBPNet": dict(in_channels=1, out_channels=1, base_filter=16, feat=8, num_stages=3,
                   num_resblocks=2, num_frames=5, upscale_factor=SCALE),
    "TOFlowNet": dict(in_channels=1, out_channels=1, num_frames=3, upscale_factor=SCALE),
}
BN_NETS = {"DUFNet", "TOFlowNet"}
MISR_CONFIGS = sorted(p for sub in ("test", "train") for net in ("duf_net", "rbp_net", "toflow_net")
                      for p in (REPO / "configs" / sub / net).glob("*.yaml"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (test workers run side by
    side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_acdc_tree(tmp_path_factory.mktemp("acdc"), patients_per_split=1, slices=2,
                          frames=FRAMES, hr_size=(LR_HW * SCALE, LR_HW * SCALE))


@functools.lru_cache(maxsize=None)
def _jax_variables(name):
    """The JAX init from ``PRNGKey(0)``, BatchNorm statistics moved off their
    init values so that serving reads them."""
    T = NETS_SMALL[name]["num_frames"]
    x = np.zeros((1, T, LR_HW, LR_HW, 1), np.float32)
    variables = jax.tree.map(np.asarray, getattr(jax_models, name)(**NETS_SMALL[name]).init(
        jax.random.PRNGKey(0), x))
    if "batch_stats" in variables:
        rng = np.random.default_rng(11)
        variables["batch_stats"] = jax.tree.map(
            lambda a: (a + rng.uniform(0.05, 0.3, a.shape)).astype(np.float32),
            variables["batch_stats"])
    return variables


def _port_net(name, **overrides):
    net = getattr(models, name)(**{**NETS_SMALL[name], **overrides})
    net.load_state_dict(state_dict_from_jax_params(_jax_variables(name), name), strict=True)
    return net


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("start,end", [(-3, 4), (-2, 12), (0, 5), (3, 8), (5, 11), (6, 9)])
def test_window_equals_jax(start, end):
    vol = np.arange(2 * 3 * 1 * FRAMES, dtype=np.float32).reshape(2, 3, 1, FRAMES)
    got = datasets._window(start, end, vol)
    np.testing.assert_array_equal(got, jax_datasets._window(start, end, vol))
    if start < 0 and end > FRAMES:  # longer than the sequence: the wrapped start, then all
        assert got.shape[-1] == -start + FRAMES


AUGMENTS = [  # configs/train/*/exp1_x4.yaml, with a crop that fits the tree
    {"name": "RandomHorizontalFlip"},
    {"name": "RandomVerticalFlip"},
    {"name": "RandomCropPatch", "kwargs": {"size": [6, 6], "ratio": SCALE}},
]


def _ds_kwargs(tree, split, num_frames, augments=None, temporal_order="middle"):
    return dict(data_dir=tree["videos_dir"], type=split, downscale_factor=SCALE, transforms=NORM,
                augments=augments, num_frames=num_frames, temporal_order=temporal_order)


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        va, vb = np.asarray(a[key]), np.asarray(b[key])
        assert va.dtype == vb.dtype and va.shape == vb.shape, key
        np.testing.assert_array_equal(va, vb, err_msg=key)


@pytest.mark.parametrize("num_frames,order", [(7, "middle"), (4, "middle"), (3, "last")])
def test_misr_items_and_augmented_batches_equal_jax(tree, num_frames, order):
    for split in ("train", "test"):
        kwargs = _ds_kwargs(tree, split, num_frames, temporal_order=order)
        port, ref = MISRDataset(**kwargs), jax_datasets.MISRDataset(**kwargs)
        assert len(port) == len(ref) == 2 * FRAMES
        assert port.data == ref.data
        for i in range(len(ref)):
            _assert_same(port[i], ref[i])
        assert port[0]["lr_imgs"].shape == (num_frames, LR_HW, LR_HW, 1)
        assert port[0]["hr_img"].shape == (LR_HW * SCALE, LR_HW * SCALE, 1)
    assert DATASETS.get("AcdcMISRDataset") is DATASETS.get("Dsb15MISRDataset") is MISRDataset

    kwargs = _ds_kwargs(tree, "train", num_frames, AUGMENTS, order)
    port = Dataloader(MISRDataset(**kwargs), batch_size=4, shuffle=True, num_workers=2)
    ref = JaxDataloader(jax_datasets.MISRDataset(**kwargs), batch_size=4, shuffle=True,
                        num_workers=2)
    for seed in jax_seed_everything("vsr", 2).np_random_seeds:
        port.set_epoch(seed)
        ref.set_epoch(seed)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            _assert_same(a, b)
        assert got[0]["lr_imgs"].shape == (4, num_frames, 6, 6, 1)
        assert got[0]["hr_img"].shape == (4, 24, 24, 1)


# ----------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    paths = {}
    for name in NETS_SMALL:
        paths[name, "pth"] = root / f"{name}.pth"
        torch.save({"net": _port_net(name).state_dict()}, paths[name, "pth"])
    variables = _jax_variables("DUFNet")
    paths["DUFNet", "pickle"] = root / "DUFNet_pickle.pth"
    jax_save_checkpoint(paths["DUFNet", "pickle"], params=variables["params"],
                        model_state={"batch_stats": variables["batch_stats"]},
                        opt_state=optax.adam(1e-3).init(variables["params"]), epoch=3,
                        seed_state=jax_seed_everything("vsr", 2))
    return paths


def _test_cfg(tree, saved_dir, loaded_path, name, **net_overrides):
    coords = str(tree["coordinates_path"])
    return {
        "main": {"saved_dir": str(saved_dir), "loaded_path": str(loaded_path)},
        "dataset": {"name": "AcdcMISRDataset",
                    "kwargs": {"data_dir": str(tree["videos_dir"]), "downscale_factor": SCALE,
                               "transforms": NORM, "num_frames": NETS_SMALL[name]["num_frames"]}},
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"batch_size": 1, "shuffle": False, "num_workers": 2}},
        "net": {"name": name, "kwargs": {**NETS_SMALL[name], **net_overrides}},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [
            {"name": "PSNR"}, {"name": "SSIM"},
            {"name": "CardiacPSNR", "kwargs": {"coordinates_path": coords}},
            {"name": "CardiacSSIM", "kwargs": {"coordinates_path": coords}},
        ],
        "predictor": {"name": "AcdcMISRPredictor",
                      "kwargs": {"device": "cpu", "saved_dir": str(saved_dir), "exported": True}},
    }


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _files(root):
    return {str(p.relative_to(root)) for p in Path(root).rglob("*")
            if p.is_file() and p.name != "config.yaml"}


SERVE_CASES = [("DUFNet", "pth"), ("DUFNet", "pickle"), ("RBPNet", "pth"), ("TOFlowNet", "pth")]


@pytest.mark.parametrize("name,kind", SERVE_CASES, ids=[f"{n}-{k}" for n, k in SERVE_CASES])
def test_predict_matches_jax(tree, checkpoints, tmp_path, name, kind):
    ckpt = checkpoints[name, kind]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_log = run_jax_test(JaxCfg(_test_cfg(tree, jax_dir, ckpt, name))).log
    predictor = run_port_test(Cfg(_test_cfg(tree, port_dir, ckpt, name)))
    assert predictor.log.keys() == jax_log.keys()
    for key in jax_log:
        np.testing.assert_allclose(predictor.log[key], jax_log[key], rtol=2e-3, atol=2e-3,
                                   err_msg=key)
    assert predictor.throughput["frames"] == 2 * FRAMES
    if name in BN_NETS:  # the trained statistics, not the initial ones, were served
        sd = predictor.net.state_dict()
        want = state_dict_from_jax_params(_jax_variables(name), name)
        assert all(torch.equal(sd[k].cpu(), want[k]) for k in sd if "running" in k)

    header_j, rows_j = _read_csv(jax_dir / "results.csv")
    header_p, rows_p = _read_csv(port_dir / "results.csv")
    assert header_p == header_j
    assert [r[0] for r in rows_p] == [r[0] for r in rows_j]
    assert len(rows_p) == 2 * FRAMES and rows_p[0][0] == "patient003_2d_slice01_frame01"
    np.testing.assert_allclose(np.array([[float(x) for x in r[1:]] for r in rows_p]),
                               np.array([[float(x) for x in r[1:]] for r in rows_j]),
                               rtol=2e-3, atol=2e-3)

    files = _files(jax_dir)
    assert _files(port_dir) == files
    assert sum(f.endswith(".png") for f in files) == 2 * FRAMES
    assert "imgs/patient003/slice01_frame01.png" in files
    assert sorted(f for f in files if f.endswith(".gif")) == [
        "videos/patient003/sequence01.gif", "videos/patient003/sequence02.gif"]
    for rel in sorted(files):
        if rel.endswith(".png"):
            a = np.asarray(png_frame(jax_dir / rel), np.int16)
            b = np.asarray(png_frame(port_dir / rel), np.int16)
            assert a.shape == b.shape == (LR_HW * SCALE,) * 2 and np.abs(a - b).max() <= 1, rel
        elif rel.endswith(".gif"):
            fa = [np.asarray(f, np.int16) for f in gif_frames(jax_dir / rel)]
            fb = [np.asarray(f, np.int16) for f in gif_frames(port_dir / rel)]
            assert len(fa) == len(fb) == FRAMES, rel
            assert all(np.abs(a - b).max() <= 1 for a, b in zip(fa, fb)), rel


# ---------------------------------------------------------------- training
LR_RATE, N_ITEMS, BATCH, EPOCHS = 1e-4, 8, 4, 6  # 2 steps an epoch × 6 = 12 Adam steps


class _ListDataset:
    """In-memory items (channels-last numpy), for both frameworks' loaders."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _items(name, seed=4, n=N_ITEMS, hw=LR_HW):
    T = NETS_SMALL[name]["num_frames"]
    rng = np.random.default_rng(seed)
    return [{"lr_imgs": rng.standard_normal((T, hw, hw, 1)).astype(np.float32),
             "hr_img": rng.standard_normal((hw * SCALE, hw * SCALE, 1)).astype(np.float32)}
            for _ in range(n)]


def _trained_pair(name, items, num_epochs, optimizer=("Adam", LR_RATE), **knobs):
    """The JAX trainer and the port's, trained from the same weights and
    running statistics."""
    opt_name, lr = optimizer
    jax_loader = JaxDataloader(_ListDataset(items), batch_size=BATCH, shuffle=False)
    jax_opt = JaxOptimizer(opt_name, lr=lr, weight_decay=0)
    ref = jax_trainers.MISRTrainer(
        device="cpu", train_dataloader=jax_loader, valid_dataloader=jax_loader,
        net=getattr(jax_models, name)(**NETS_SMALL[name]), loss_fns=[JL.L1Loss()],
        loss_weights=[1.0], metric_fns=[JM.PSNR(), JM.SSIM()], optimizer=jax_opt,
        num_epochs=num_epochs, **knobs)
    variables = _jax_variables(name)
    ref.params = jax.tree.map(jnp.asarray, variables["params"])
    ref.model_state = {k: jax.tree.map(jnp.asarray, v) for k, v in variables.items()
                       if k != "params"}
    ref.opt_state = jax_opt.init(ref.params)
    ref.train()

    loader = Dataloader(_ListDataset(items), batch_size=BATCH, shuffle=False)
    port = trainers.MISRTrainer(
        device="cpu", train_dataloader=loader, valid_dataloader=loader, net=_port_net(name),
        loss_fns=[PL.L1Loss()], loss_weights=[1.0], metric_fns=[PM.PSNR(), PM.SSIM()],
        optimizer=Optimizer(opt_name, lr=lr, weight_decay=0), num_epochs=num_epochs, **knobs)
    port.train()
    return port, ref


def _jax_state_dict(ref, name):
    return state_dict_from_jax_params(
        {"params": jax.tree.map(np.asarray, ref.params),
         **jax.tree.map(np.asarray, ref.model_state)}, name)


# (rtol, atol) by log key over the 12 steps.  RBPN as
# tests/test_torch_sisr_runner.py holds the single-image trainers (measured:
# Loss 4.5e-7, PSNR 1.2e-7, SSIM 1.3e-5 relative).  The BatchNorm nets'
# trajectories are chaotic at the 1e-5 level: their exact gradients agree
# with JAX's to 2e-6 relative, but Adam turns the sign noise of near-zero
# gradient elements (a conv bias before a training-mode BatchNorm has a
# true gradient of 0; both compute ~1e-10) into steps, and the port against
# itself with its weights perturbed by 1e-7 moves DUF's train Loss by
# 1.6e-5 in 3 epochs.  So their first epoch is held at the single-image
# tolerances (measured: Loss 5.2e-7 DUF, 6.8e-7 TOFlow) and the later ones
# at ~3x the deviation measured (DUF: Loss 2.8e-5, PSNR 3.9e-5, SSIM 1.9e-4
# absolute; TOFlow: Loss 1.8e-4, PSNR 1.8e-4, SSIM 2.4e-4 absolute), TOFlow
# at rtol 2e-3, the trajectory tolerance of
# tests/test_train_dynamics_parity.py for its warp chain (size−1 divisions
# that XLA:CPU rounds 1 ulp off IEEE, fed back through the trained flows).
FIRST_EPOCH_TOL = {"Loss": (1e-5, 1e-7), "L1Loss": (1e-5, 1e-7), "PSNR": (1e-4, 1e-7),
                   "SSIM": (1e-4, 2e-5)}
TRAJECTORY_TOL = {
    "RBPNet": FIRST_EPOCH_TOL,
    "DUFNet": {"Loss": (1e-4, 1e-7), "L1Loss": (1e-4, 1e-7), "PSNR": (1e-4, 1e-7),
               "SSIM": (0.0, 6e-4)},
    "TOFlowNet": {"Loss": (2e-3, 1e-7), "L1Loss": (2e-3, 1e-7), "PSNR": (2e-3, 1e-7),
                  "SSIM": (0.0, 1e-3)},
}


@pytest.mark.parametrize("name", list(NETS_SMALL))
def test_trajectory_matches_jax_trainer(name):
    port, ref = _trained_pair(name, _items(name), EPOCHS)
    for split in ("train", "valid"):  # valid runs in eval: it reads the running statistics
        want, got = ref.history[split], port.history[split]
        assert len(got) == len(want) == EPOCHS
        assert [list(g) for g in got] == [list(w) for w in want] == [
            ["Loss", "L1Loss", "PSNR", "SSIM"]] * EPOCHS
        for key, (rtol, atol) in FIRST_EPOCH_TOL.items():
            np.testing.assert_allclose(got[0][key], want[0][key], rtol=rtol, atol=atol,
                                       err_msg=f"{split} epoch 1 {key}")
        for key, (rtol, atol) in TRAJECTORY_TOL[name].items():
            np.testing.assert_allclose([g[key] for g in got], [w[key] for w in want],
                                       rtol=rtol, atol=atol, err_msg=f"{split} {key}")
    train_loss = [h["Loss"] for h in port.history["train"]]
    assert abs(train_loss[0] - train_loss[-1]) > 1e-5  # the trajectory moves
    # B·T LR frames a batch
    assert port._frame_count(next(iter(port.train_dataloader))) == (
        BATCH * NETS_SMALL[name]["num_frames"])


#: the running statistics after one epoch (2 steps), relative to each
#: buffer's largest value: ~3x the deviation measured (3.3e-4 DUF, 2.7e-4
#: TOFlow); the 12-step trajectory reads them through its valid logs
STATS_TOL = 1e-3


@pytest.mark.parametrize("name", sorted(BN_NETS))
def test_running_statistics_after_an_epoch_match_jax(name):
    port, ref = _trained_pair(name, _items(name), 1)
    want, got = _jax_state_dict(ref, name), port.net.state_dict()
    start = state_dict_from_jax_params(_jax_variables(name), name)
    running = [k for k in got if "running" in k]
    assert running and all(not torch.equal(got[k], start[k]) for k in running)
    for k in running:
        assert ((got[k] - want[k]).abs().max() / want[k].abs().max()).item() <= STATS_TOL, k


BF16_GAP_RATIO = (0.6, 1.5)  # tests/test_torch_tpu_knobs.py


def BF16_CPU():
    """bf16 convs on the CPU through ATen's own kernels, which sum in fp32
    as XLA:CPU and cuDNN do (oneDNN's bf16 conv does not)."""
    return torch.backends.mkldnn.flags(enabled=False)


def _gap(a: dict, b: dict, keys) -> float:
    return math.sqrt(sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in keys))


def test_bf16_rbpn_step_with_grad_accum_tracks_jax():
    """configs/train/rbp_net/exp1_x4_tpu.yaml's knobs (bf16, 2 microbatches)
    on one SGD step: the update is the gradient, so the parameters' bf16 -
    fp32 gap is the gradients' (times the lr).

    The ratio rule holds on the conv and transposed-conv kernels (measured
    1.03), whose gradients both frameworks compute as convs of bf16 operands
    summed in fp32.  The biases' and PReLU weights' gradients are sums of a
    whole bf16 cotangent: JAX's XLA:CPU reduces them in bf16, torch in fp32,
    so there the port's gap is the smaller (measured 0.20 and 0.06 of JAX's)
    and is held to at most JAX's.

    The port runs with oneDNN off (``BF16_CPU``): oneDNN's bf16 conv on the
    CPU does not keep an fp32 sum (one of RBPN's 8×8 stride-4 projections
    measured 0.047 off on outputs of 0.053, against 1.2e-4 through ATen's
    own conv), where XLA:CPU and cuDNN on the card round the operands and
    the output only; with it on, the port's gap was 1.71× JAX's."""
    items = _items("RBPNet", seed=5, n=BATCH)
    runs = {}
    for knobs in ({}, {"compute_dtype": "bfloat16", "grad_accum_steps": 2}):
        with BF16_CPU():
            port, ref = _trained_pair("RBPNet", items, 1, optimizer=("SGD", 1.0), **knobs)
        runs[bool(knobs)] = ({k: v.float() for k, v in port.net.state_dict().items()},
                             _jax_state_dict(ref, "RBPNet"), port, ref)
    p32, j32, _, _ = runs[False]
    p16, j16, port16, ref16 = runs[True]
    kernels = [k for k in p32 if p32[k].dim() > 1]
    sums = [k for k in p32 if p32[k].dim() <= 1]
    assert len(kernels) + len(sums) == len(p32) and sums
    ratio = _gap(p16, p32, kernels) / _gap(j16, j32, kernels)
    assert BF16_GAP_RATIO[0] <= ratio <= BF16_GAP_RATIO[1], ratio
    assert _gap(p16, p32, sums) <= _gap(j16, j32, sums)
    assert _gap(p32, j32, p32) / _gap(j16, j32, p32) < 0.1  # fp32 port and JAX: far nearer
    assert all(p.dtype == torch.float32 for p in port16.net.parameters())
    assert port16.grad_accum_steps == ref16.grad_accum_steps == 2
    np.testing.assert_allclose(port16.history["train"][0]["Loss"],
                               ref16.history["train"][0]["Loss"], rtol=1e-2)


def test_bf16_toflow_windowed_serving_tracks_jax():
    """configs/test/toflow_net/exp1_x4_tpu.yaml's net (``max_flow: 4``) in
    bf16 against fp32, port and JAX: the resize matrices are fp32, so both
    run the net in fp32 on bf16-rounded weights and inputs."""
    name = "TOFlowNet"
    variables = _jax_variables(name)
    jax_net = getattr(jax_models, name)(**NETS_SMALL[name], max_flow=4)
    net = _port_net(name, max_flow=4).eval()
    x = np.random.default_rng(5).standard_normal((2, 3, LR_HW, LR_HW, 1)).astype(np.float32)
    apply = jax.jit(lambda v, a: jax_net.apply(v, a, train=False))
    j32 = np.asarray(apply(variables, x))
    j16 = np.asarray(apply(jax_cast_floating(jax.tree.map(jnp.asarray, variables), jnp.bfloat16),
                           jnp.asarray(x, jnp.bfloat16)), np.float32)
    with torch.inference_mode():
        p32 = net(torch.from_numpy(x))
        p16 = forward_in(net, torch.bfloat16, torch.from_numpy(x))
    np.testing.assert_allclose(p32.numpy(), j32, atol=5e-5, rtol=1e-4)
    ratio = np.sqrt(np.mean((p16.numpy() - p32.numpy()) ** 2) / np.mean((j16 - j32) ** 2))
    assert BF16_GAP_RATIO[0] <= ratio <= BF16_GAP_RATIO[1], ratio


def test_bf16_duf_step_moves_the_fp32_running_statistics():
    """The bf16 forward updates bf16 copies of the statistics; the trainer
    carries them back into the fp32 buffers, near the fp32 step's."""
    items = _items("DUFNet", seed=6, n=BATCH)
    stats = {}
    for dtype in ("float32", "bfloat16"):
        loader = Dataloader(_ListDataset(items), batch_size=BATCH, shuffle=False)
        trainer = trainers.MISRTrainer(
            device="cpu", train_dataloader=loader, valid_dataloader=loader,
            net=_port_net("DUFNet"), loss_fns=[PL.L1Loss()], metric_fns=[PM.PSNR()],
            optimizer=Optimizer("Adam", lr=LR_RATE, weight_decay=0), num_epochs=1,
            compute_dtype=dtype)
        trainer.net.train()
        trainer._train_step(next(iter(loader)))
        stats[dtype] = {k: v.clone() for k, v in trainer.net.state_dict().items() if "running" in k}
    start = state_dict_from_jax_params(_jax_variables("DUFNet"), "DUFNet")
    for k, v in stats["bfloat16"].items():
        v32 = stats["float32"][k]
        assert v.dtype == torch.float32 and not torch.equal(v, start[k]), k
        # bf16 rounds the statistics before and after the update (2^-8 to
        # 2^-7 relative spacing; measured 1.03% off at most), and the batch it
        # measures: within two bf16 steps of the fp32 step's
        assert (v - v32).abs().max() <= 2.0 ** -6 * v32.abs().max(), k


# ------------------------------------------------------------ fault repairs
def _train_cfg(tree, saved_dir, name, loaded_path=None, num_epochs=2):
    """configs/train/*/exp1_x4.yaml on the small tree, with its logger, on
    the CPU."""
    return {
        "main": {"random_seed": "vsr", "saved_dir": str(saved_dir), "loaded_path": loaded_path},
        "dataset": {"name": "AcdcMISRDataset",
                    "kwargs": {"data_dir": str(tree["videos_dir"]), "downscale_factor": SCALE,
                               "transforms": NORM, "augments": AUGMENTS,
                               "num_frames": NETS_SMALL[name]["num_frames"]}},
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"train_batch_size": 4, "valid_batch_size": 1, "shuffle": True,
                                  "num_workers": 2}},
        "net": {"name": name, "kwargs": NETS_SMALL[name]},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [{"name": "PSNR"}, {"name": "SSIM"}],
        "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-4, "weight_decay": 0}},
        "logger": {"name": "AcdcMISRLogger", "kwargs": {"dummy_input": [4, 1, 6, 6]}},
        "monitor": {"name": "Monitor",
                    "kwargs": {"mode": "min", "target": "Loss", "saved_freq": 1, "early_stop": 0}},
        "trainer": {"name": "AcdcMISRTrainer",
                    "kwargs": {"device": "cpu", "num_epochs": num_epochs}},
    }


def test_jax_checkpoint_directory_resumes_at_its_epoch(tree, tmp_path):
    """model_5.pth and model_preempted.pth (epoch 7) written by the JAX
    package: the port picks the preempted file without building a net, and
    resumes at epoch 8 with the JAX net's weights, statistics and monitor."""
    saved = tmp_path / "run"
    ckpts = saved / "checkpoints"
    variables = _jax_variables("DUFNet")
    monitor = {"mode": "min", "target": "Loss", "saved_freq": 1, "early_stop": 0,
               "best": 0.25, "not_improved_count": 2}
    for epoch, fname in ((5, "model_5.pth"), (7, "model_preempted.pth")):
        jax_save_checkpoint(ckpts / fname, params=variables["params"],
                            model_state={"batch_stats": variables["batch_stats"]},
                            opt_state=optax.adam(1e-4).init(variables["params"]),
                            monitor_state=monitor, epoch=epoch,
                            seed_state=jax_seed_everything("vsr", 8))
    assert find_latest_checkpoint(ckpts) == ckpts / "model_preempted.pth"
    loaded = load_checkpoint(ckpts / "model_preempted.pth", "DUFNet")
    assert loaded["epoch"] == 7 and loaded["monitor"]["not_improved_count"] == 2
    # optax's Adam state and the SeedState are read too (ROADMAP item 6)
    assert "optimizer" not in loaded and loaded["optimizer_jax"]["step"] == 0
    assert loaded["seed_state"]["np_random_seeds"] == jax_seed_everything("vsr", 8).np_random_seeds

    seen = {}
    orig_load = trainers.BaseTrainer.load

    def spy(self, path):
        orig_load(self, path)
        seen.update(path=path, epoch=self.epoch, best=self.monitor.best,
                    sd={k: v.clone() for k, v in self.net.state_dict().items()})

    trainers.BaseTrainer.load = spy
    try:
        trainer = train_from_config(Cfg(_train_cfg(tree, saved, "DUFNet", loaded_path="auto",
                                                   num_epochs=8)))
    finally:
        trainers.BaseTrainer.load = orig_load
    assert seen["path"] == ckpts / "model_preempted.pth" and seen["epoch"] == 8
    assert seen["best"] == 0.25
    want = state_dict_from_jax_params(variables, "DUFNet")
    assert all(torch.equal(seen["sd"][k], want[k]) for k in want)
    assert len(trainer.history["train"]) == 1  # epoch 8 of 8
    assert load_checkpoint(ckpts / "model_8.pth")["epoch"] == 8


def test_logger_falls_back_to_torch_tensorboard(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # import raises ImportError
    logger = LOGGERS.get("AcdcMISRLogger")(log_dir=tmp_path / "log")
    assert type(logger.writer).__module__.startswith("torch.utils.tensorboard")
    batch = {"hr_img": np.random.default_rng(0).uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)}
    logger.write(1, {"Loss": 0.5}, batch, batch["hr_img"], {"Loss": 0.4}, batch, batch["hr_img"])
    logger.close()
    events = list((tmp_path / "log").rglob("events.out.tfevents.*"))
    assert events and all(e.stat().st_size > 0 for e in events)
    assert LOGGERS.get("Dsb15MISRLogger") is loggers.FrameLogger


def test_train_from_config_writes_bn_statistics_the_jax_package_reads(tree, tmp_path):
    """A DUF train config with its logger: model_best.pth carries the running
    statistics, which the JAX package's loader reads back."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.checkpoint import (
        load_net_variables,
    )

    saved = tmp_path / "run"
    trainer = train_from_config(Cfg(_train_cfg(tree, saved, "DUFNet")))
    assert all(np.isfinite(v) for h in trainer.history["train"] + trainer.history["valid"]
               for v in h.values())
    assert any((saved / "log").iterdir())
    best = saved / "checkpoints" / "model_best.pth"
    sd = load_checkpoint(best)["net"]
    net = models.DUFNet(**NETS_SMALL["DUFNet"])
    net.load_state_dict(sd, strict=True)
    start = state_dict_from_jax_params(_jax_variables("DUFNet"), "DUFNet")
    assert not torch.equal(sd["denseLayer.conv0.bn1.running_mean"],
                           torch.zeros_like(start["denseLayer.conv0.bn1.running_mean"]))
    variables = load_net_variables(best, "DUFNet")
    x = np.random.default_rng(3).standard_normal((1, 7, LR_HW, LR_HW, 1)).astype(np.float32)
    want = jax_models.DUFNet(**NETS_SMALL["DUFNet"]).apply(variables, x)
    with torch.inference_mode():
        got = net.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=1e-4)


# --------------------------------------------------------------------- zoo
@pytest.fixture(scope="module")
def zoo_cwd(tmp_path_factory):
    """A cwd where the zoo's relative ./data/... paths resolve to a small
    videos tree: HR 132 is divisible by every factor and each LR admits the
    train configs' 32×32 crop; 7 frames a sequence."""
    root = tmp_path_factory.mktemp("zoo_cwd")
    tree = make_acdc_tree(root / "fixture", patients_per_split=1, slices=1, frames=7,
                          hr_size=(132, 132), factors=(2, 3, 4))
    for prep, crop in (("acdc_preprocessed", "acdc_cropped"),
                       ("dsb15_preprocessed", "dsb15_cropped")):
        (root / "data" / prep).mkdir(parents=True)
        (root / "data" / prep / "videos").symlink_to(tree["videos_dir"])
        (root / "data" / crop).mkdir(parents=True)
        (root / "data" / crop / "coordinates.pkl").symlink_to(tree["coordinates_path"])
    return root


@functools.lru_cache(maxsize=None)
def _jax_param_count(name, kwargs_items):
    kwargs = dict(kwargs_items)
    net = getattr(jax_models, name)(**kwargs)
    x = np.zeros((1, kwargs["num_frames"], 8, 8, 1), np.float32)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), x)
    return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))


def test_the_misr_zoo_is_complete():
    assert len(MISR_CONFIGS) == 29


@pytest.mark.parametrize("path", MISR_CONFIGS,
                         ids=[str(p.relative_to(REPO / "configs")) for p in MISR_CONFIGS])
def test_misr_zoo_config_constructs(path, zoo_cwd, monkeypatch):
    _import_components()
    monkeypatch.chdir(zoo_cwd)
    cfg = load_config(path)
    net = NETS.build(cfg.net, generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in net.parameters())
    assert n_params == _jax_param_count(cfg.net.name, tuple(sorted(cfg.net.kwargs.items())))
    r, T = cfg.net.kwargs.upscale_factor, cfg.net.kwargs.num_frames
    assert T == cfg.dataset.kwargs.num_frames
    with torch.inference_mode():
        out = net.eval()(torch.zeros(1, T, 8, 8, 1))
    assert tuple(out.shape) == (1, 8 * r, 8 * r, 1)
    loss_fns = [LOSSES.build(c) for c in cfg.losses]
    metric_fns = [METRICS.build(c) for c in cfg.get("metrics", [])]
    dl_kwargs = dict(cfg.dataloader.kwargs)
    kwargs = dict(net=net, loss_fns=loss_fns, metric_fns=metric_fns, device="cpu")
    if "predictor" in cfg:
        ds = DATASETS.build(cfg.dataset, type="test")
        loader = DATALOADERS.get(cfg.dataloader.name)(ds, **dl_kwargs)
        engine = PREDICTORS.get(cfg.predictor.name)(
            test_dataloader=loader, **{**cfg.predictor.kwargs, **kwargs})
        assert engine.dataset_stats == ("dsb15" if cfg.predictor.name.startswith("Dsb15")
                                        else "acdc")
    else:
        ds = DATASETS.build(cfg.dataset, type="train")
        train_bs = dl_kwargs.pop("train_batch_size")
        dl_kwargs.pop("valid_batch_size")
        loader = DATALOADERS.get(cfg.dataloader.name)(ds, batch_size=train_bs, **dl_kwargs)
        monitor = MONITORS.build(cfg.monitor, checkpoints_dir=zoo_cwd / "checkpoints")
        engine = TRAINERS.get(cfg.trainer.name)(
            train_dataloader=loader, valid_dataloader=loader, monitor=monitor,
            optimizer=build_optimizer(cfg.optimizer), **{**cfg.trainer.kwargs, **kwargs})
        assert cfg.logger.name in LOGGERS
    item = ds[0]
    assert item["lr_imgs"].shape[0] == T and item["lr_imgs"].shape[-1] == 1
    assert item["hr_img"].shape[0] == item["lr_imgs"].shape[1] * r
    assert type(engine).__name__ == (cfg.get("predictor") or cfg.get("trainer")).name
