"""The PyTorch port's plain video workload (DRF, FRVSR) against the JAX package's, on the CPU.

* Data: ``VSRDataset`` training windows (per (sequence, t), ``num_frames``
  and ``temporal_order`` as the configs set them, a window longer than the
  sequence included) and whole test sequences, and shuffled, augmented
  ``Dataloader`` batches, exactly equal to the JAX package's on one
  ``make_acdc_tree`` videos tree; registered under the Acdc and Dsb15 names.
* Serving: ``test_from_config`` of DRF (``AcdcVSRPredictor``) and FRVSR
  (``AcdcFRVSRPredictor``, ``is_prediction`` as the test configs set it,
  and with ``max_flow: 4``) from a ``{'net': state_dict}`` ``.pth`` of the
  JAX init: the Test log and ``results.csv`` at rtol/atol 2e-3, the PNG/GIF
  pixels within one gray level, the file names the JAX package's, and the
  ``max_flow`` run's telemetry summary equal to the JAX predictor's.
* Training: the JAX ``VSRTrainer`` / ``FRVSRTrainer`` and the port's from
  the same weights over the same 8 numpy sequences of 3 frames at batch 4
  for 6 epochs (12 Adam steps at lr 1e-4): every epoch's train and valid
  log at the tolerances of ``TRAJECTORY_TOL`` below; FRVSR's two heads
  (``FlowLoss`` on the warped LR frames against the LR frames, ``MSELoss``
  on the SR frames) logged under their names, weighted by B·T.
* The zoo: every drf/frvsr YAML of ``configs/`` (13) resolves, and its net
  (at the published width, with the JAX net's parameter count and a
  forward), losses, metrics, dataset (one item), dataloader and trainer or
  predictor construct through the port's registries.
"""
import csv
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.optim import (
    Optimizer as JaxOptimizer,
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
    VSRDataset,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
    _import_components,
    test_from_config as run_port_test,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import (
    trainers,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.optim import (
    Optimizer,
    build_optimizer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)
from fixtures import make_acdc_tree
from gray_frames import gif_frames, png_frame
from jax_data_caches import empty_jax_data_caches  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FRAMES, SCALE, LR_HW = 6, 4, 8
NORM = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
        {"name": "ToTensor"}]
NETS_SMALL = {
    "DRFNet": dict(in_channels=1, out_channels=1, num_features=8, num_groups=2,
                   upscale_factor=SCALE),
    "FRVSRNet": dict(in_channels=1, out_channels=1, num_resblocks=2, upscale_factor=SCALE),
}
WORKLOAD = {"DRFNet": "VSR", "FRVSRNet": "FRVSR"}
VSR_CONFIGS = sorted(p for sub in ("test", "train") for net in ("drf_net", "frvsr_net")
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
    x = np.zeros((1, 3, LR_HW, LR_HW, 1), np.float32)
    return jax.tree.map(np.asarray, getattr(jax_models, name)(**NETS_SMALL[name]).init(
        jax.random.PRNGKey(0), x))


def _port_net(name):
    net = getattr(models, name)(**NETS_SMALL[name])
    net.load_state_dict(state_dict_from_jax_params(_jax_variables(name), name), strict=True)
    return net


# -------------------------------------------------------------------- data
AUGMENTS = [  # configs/train/*/exp1_x4.yaml, with a crop that fits the tree
    {"name": "RandomHorizontalFlip"},
    {"name": "RandomVerticalFlip"},
    {"name": "RandomCropPatch", "kwargs": {"size": [6, 6], "ratio": SCALE}},
]


def _ds_kwargs(tree, split, num_frames, augments=None, temporal_order="last"):
    return dict(data_dir=tree["videos_dir"], type=split, downscale_factor=SCALE, transforms=NORM,
                augments=augments, num_frames=num_frames, temporal_order=temporal_order)


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        va, vb = np.asarray(a[key]), np.asarray(b[key])
        assert va.dtype == vb.dtype and va.shape == vb.shape, key
        np.testing.assert_array_equal(va, vb, err_msg=key)


@pytest.mark.parametrize("num_frames,order", [(3, "last"), (4, "middle"), (7, "last")])
def test_vsr_items_and_augmented_batches_equal_jax(tree, num_frames, order):
    for split in ("train", "test"):
        kwargs = _ds_kwargs(tree, split, num_frames, temporal_order=order)
        port, ref = VSRDataset(**kwargs), jax_datasets.VSRDataset(**kwargs)
        assert port.data == ref.data
        assert len(port) == (2 * FRAMES if split == "train" else 2)
        for i in range(len(ref)):
            _assert_same(port[i], ref[i])
        T = port[0]["lr_imgs"].shape[0]
        if split == "test":  # whole sequences
            assert T == FRAMES
        elif num_frames <= FRAMES:  # training windows of num_frames
            assert T == num_frames
        assert port[0]["hr_imgs"].shape == (T, LR_HW * SCALE, LR_HW * SCALE, 1)
    assert DATASETS.get("AcdcVSRDataset") is DATASETS.get("Dsb15VSRDataset") is VSRDataset
    with pytest.raises(ValueError, match="temporal_order"):
        VSRDataset(**_ds_kwargs(tree, "train", 3, temporal_order="first"))

    kwargs = _ds_kwargs(tree, "train", num_frames, AUGMENTS, order)
    port = Dataloader(VSRDataset(**kwargs), batch_size=4, shuffle=True, num_workers=2)
    ref = JaxDataloader(jax_datasets.VSRDataset(**kwargs), batch_size=4, shuffle=True,
                        num_workers=2)
    for seed in jax_seed_everything("vsr", 2).np_random_seeds:
        port.set_epoch(seed)
        ref.set_epoch(seed)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _assert_same(a, b)
        assert got[0]["hr_imgs"].shape[2:] == (24, 24, 1)


# ----------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    paths = {}
    for name in NETS_SMALL:
        paths[name] = root / f"{name}.pth"
        torch.save({"net": _port_net(name).state_dict()}, paths[name])
    return paths


def _test_cfg(tree, saved_dir, loaded_path, name, **net_overrides):
    coords = str(tree["coordinates_path"])
    return {
        "main": {"saved_dir": str(saved_dir), "loaded_path": str(loaded_path)},
        "dataset": {"name": "AcdcVSRDataset",
                    "kwargs": {"data_dir": str(tree["videos_dir"]), "downscale_factor": SCALE,
                               "transforms": NORM, "num_frames": 3}},
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"batch_size": 1, "shuffle": False, "num_workers": 2}},
        "net": {"name": name, "kwargs": {**NETS_SMALL[name], **net_overrides}},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [
            {"name": "PSNR"}, {"name": "SSIM"},
            {"name": "CardiacPSNR", "kwargs": {"coordinates_path": coords}},
            {"name": "CardiacSSIM", "kwargs": {"coordinates_path": coords}},
        ],
        "predictor": {"name": f"Acdc{WORKLOAD[name]}Predictor",
                      "kwargs": {"device": "cpu", "saved_dir": str(saved_dir), "exported": True}},
    }


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _files(root):
    return {str(p.relative_to(root)) for p in Path(root).rglob("*")
            if p.is_file() and p.name != "config.yaml"}


SERVE_CASES = [("DRFNet", {}), ("FRVSRNet", {"is_prediction": True}),
               ("FRVSRNet", {"max_flow": 4})]


@pytest.mark.parametrize("name,overrides", SERVE_CASES,
                         ids=["DRFNet", "FRVSRNet", "FRVSRNet-max_flow4"])
def test_predict_matches_jax(tree, checkpoints, tmp_path, name, overrides):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_pred = run_jax_test(JaxCfg(_test_cfg(tree, jax_dir, checkpoints[name], name, **overrides)))
    predictor = run_port_test(Cfg(_test_cfg(tree, port_dir, checkpoints[name], name, **overrides)))
    jax_log = jax_pred.log
    assert predictor.log.keys() == jax_log.keys()
    for key in jax_log:
        np.testing.assert_allclose(predictor.log[key], jax_log[key], rtol=2e-3, atol=2e-3,
                                   err_msg=key)
    assert predictor.throughput["frames"] == 2 * FRAMES
    # the windowed warps' exceedance, as the JAX predictor measured it
    got, want = predictor.telemetry_summary, jax_pred.telemetry_summary
    assert sorted(got) == sorted(want) == (
        ["lr_flow_window", "sr_flow_window"] if "max_flow" in overrides else [])
    for site in want:
        assert got[site]["n"] == want[site]["n"]
        assert round(got[site]["frac_out"] * got[site]["n"]) == round(
            want[site]["frac_out"] * want[site]["n"])
        assert abs(got[site]["max_abs"] - want[site]["max_abs"]) <= 1e-5 * max(
            1.0, want[site]["max_abs"])

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
LR_RATE, N_ITEMS, BATCH, EPOCHS, T_TRAIN = 1e-4, 8, 4, 6, 3  # 12 Adam steps


class _ListDataset:
    """In-memory items (channels-last numpy), for both frameworks' loaders."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _items(seed=4, n=N_ITEMS, hw=LR_HW):
    rng = np.random.default_rng(seed)
    return [{"lr_imgs": rng.standard_normal((T_TRAIN, hw, hw, 1)).astype(np.float32),
             "hr_imgs": rng.standard_normal((T_TRAIN, hw * SCALE, hw * SCALE, 1)
                                            ).astype(np.float32)}
            for _ in range(n)]


def _losses(name, lib):
    if name == "FRVSRNet":
        return [lib.FlowLoss(), lib.MSELoss()]
    return [lib.L1Loss()]


def _trained_pair(name, items, num_epochs):
    """The JAX trainer and the port's, trained from the same weights."""
    trainer = {"DRFNet": "VSRTrainer", "FRVSRNet": "FRVSRTrainer"}[name]
    jax_loader = JaxDataloader(_ListDataset(items), batch_size=BATCH, shuffle=False)
    jax_opt = JaxOptimizer("Adam", lr=LR_RATE, weight_decay=0)
    ref = getattr(jax_trainers, trainer)(
        device="cpu", train_dataloader=jax_loader, valid_dataloader=jax_loader,
        net=getattr(jax_models, name)(**NETS_SMALL[name]), loss_fns=_losses(name, JL),
        loss_weights=[1.0] * len(_losses(name, JL)), metric_fns=[JM.PSNR(), JM.SSIM()],
        optimizer=jax_opt, num_epochs=num_epochs)
    ref.params = jax.tree.map(jnp.asarray, _jax_variables(name)["params"])
    ref.opt_state = jax_opt.init(ref.params)
    ref.train()

    loader = Dataloader(_ListDataset(items), batch_size=BATCH, shuffle=False)
    port = getattr(trainers, trainer)(
        device="cpu", train_dataloader=loader, valid_dataloader=loader, net=_port_net(name),
        loss_fns=_losses(name, PL), loss_weights=[1.0] * len(_losses(name, PL)),
        metric_fns=[PM.PSNR(), PM.SSIM()],
        optimizer=Optimizer("Adam", lr=LR_RATE, weight_decay=0), num_epochs=num_epochs)
    port.train()
    return port, ref


#: (rtol, atol) by log key over the 12 steps, train and valid: ~3x the
#: largest deviation measured on these items (DRF: Loss 2.0e-6, PSNR
#: 1.7e-7, SSIM 1.8e-6 relative; FRVSR: Loss 1.35e-6, FlowLoss 5.7e-7,
#: MSELoss 2.8e-6, PSNR 3.3e-6 relative, SSIM 2.07e-5 absolute on values of
#: 0.036, where a rounding flip of the uint8 display moves it).  The
#: recurrent warp feeds the rounding of one step into the next, so FRVSR's
#: deviation grows over the steps (its first epoch: 1.5e-7 to 3.2e-6).
TRAJECTORY_TOL = {
    "DRFNet": {"Loss": (6e-6, 0.0), "L1Loss": (6e-6, 0.0), "PSNR": (5e-7, 0.0),
               "SSIM": (6e-6, 0.0)},
    "FRVSRNet": {"Loss": (4e-6, 0.0), "FlowLoss": (2e-6, 0.0), "MSELoss": (9e-6, 0.0),
                 "PSNR": (1e-5, 0.0), "SSIM": (0.0, 6e-5)},
}


@pytest.mark.parametrize("name", list(NETS_SMALL))
def test_trajectory_matches_jax_trainer(name):
    port, ref = _trained_pair(name, _items(), EPOCHS)
    keys = ["Loss", *[fn.name for fn in _losses(name, PL)], "PSNR", "SSIM"]
    for split in ("train", "valid"):
        want, got = ref.history[split], port.history[split]
        assert len(got) == len(want) == EPOCHS
        assert [list(g) for g in got] == [list(w) for w in want] == [keys] * EPOCHS
        for key, (rtol, atol) in TRAJECTORY_TOL[name].items():
            np.testing.assert_allclose([g[key] for g in got], [w[key] for w in want],
                                       rtol=rtol, atol=atol, err_msg=f"{split} {key}")
    train_loss = [h["Loss"] for h in port.history["train"]]
    assert abs(train_loss[0] - train_loss[-1]) > 1e-5  # the trajectory moves
    batch = next(iter(port.train_dataloader))
    assert port._frame_count(batch) == BATCH * T_TRAIN  # B·T LR frames a batch
    assert port._log_weight(batch, "training") == BATCH * T_TRAIN


# --------------------------------------------------------------------- zoo
@pytest.fixture(scope="module")
def zoo_cwd(tmp_path_factory):
    """A cwd where the zoo's relative ./data/... paths resolve to a small
    videos tree: HR 132 is divisible by every factor and each LR admits the
    train configs' 32×32 crop; 10 frames a sequence (FRVSR trains on 10)."""
    root = tmp_path_factory.mktemp("zoo_cwd")
    tree = make_acdc_tree(root / "fixture", patients_per_split=1, slices=1, frames=10,
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
    net = getattr(jax_models, name)(**dict(kwargs_items))
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), np.zeros((1, 2, 8, 8, 1), np.float32))
    return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))


def test_the_vsr_zoo_is_complete():
    assert len(VSR_CONFIGS) == 13


@pytest.mark.parametrize("path", VSR_CONFIGS,
                         ids=[str(p.relative_to(REPO / "configs")) for p in VSR_CONFIGS])
def test_vsr_zoo_config_constructs(path, zoo_cwd, monkeypatch):
    _import_components()
    monkeypatch.chdir(zoo_cwd)
    cfg = load_config(path)
    net = NETS.build(cfg.net, generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in net.parameters())
    assert n_params == _jax_param_count(cfg.net.name, tuple(sorted(cfg.net.kwargs.items())))
    r = cfg.net.kwargs.upscale_factor
    with torch.inference_mode():
        out = net.eval()(torch.zeros(1, 2, 8, 8, 1))
    out = out[0] if isinstance(out, tuple) else out
    assert tuple(out.shape) == (1, 2, 8 * r, 8 * r, 1)
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
        T = 10  # a whole sequence
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
        T = cfg.dataset.kwargs.num_frames
    item = ds[0]
    assert item["lr_imgs"].shape[0] == item["hr_imgs"].shape[0] == T
    assert item["hr_imgs"].shape[1] == item["lr_imgs"].shape[1] * r
    assert type(engine).__name__ == (cfg.get("predictor") or cfg.get("trainer")).name
