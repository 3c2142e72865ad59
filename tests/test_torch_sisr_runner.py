"""The PyTorch port's single-image workload against the JAX package's, on the CPU.

* Data: ``SISRDataset`` items and shuffled, augmented ``Dataloader``
  batches (flips and ``RandomCropPatch`` from each item's ``item_rng``)
  exactly equal to the JAX package's on one ``make_acdc_tree`` tree.
* Serving: ``test_from_config`` for EDSR (from a ``{'net': state_dict}``
  ``.pth`` and from the JAX package's pickle checkpoint), SRFB, and Bicubic
  (no checkpoint: its ``loaded_path`` does not exist), Bicubic also under
  the Dsb15 names.  The Test log and ``results.csv`` match the JAX
  predictor's at rtol/atol 2e-3 and the PNG/GIF pixels within one gray
  level, as ``tests/test_torch_predict.py`` holds the RefineNet path.
* Training: the JAX ``SISRTrainer`` / ``SISRSRFBTrainer`` and the port's,
  from the same weights, over the same 8 numpy items at batch 4 for 6
  epochs (12 Adam steps at lr 1e-4): every epoch's train and valid log at
  rtol 1e-5 (``tests/test_torch_train.py``), PSNR/SSIM at rtol 1e-4.  One
  EDSR epoch with ``compute_dtype: bfloat16`` against JAX's bf16 at the
  deviation rules of ``tests/test_torch_tpu_knobs.py``.
* The CLI: ``train_from_config`` of an EDSR and an SRFB train config (with
  its frame logger) writes ``model_best.pth``, which the JAX package's
  ``load_net_variables`` reads into a net whose forward equals the port's.
* The zoo: every SISR YAML of ``configs/`` (Bicubic, EDSR, SRFB; 24 files)
  resolves and its net (at the published width, with the JAX net's
  parameter count and a forward), losses, metrics, dataset (one item),
  dataloader and trainer or predictor construct through the port's
  registries.
"""
import csv
import functools
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
    SISRDataset as JaxSISRDataset,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.main import (
    test_from_config as run_jax_test,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner import (
    trainers as jax_trainers,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.checkpoint import (
    load_net_variables,
    save_checkpoint as jax_save_checkpoint,
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
    SISRDataset,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
    _import_components,
    test_from_config as run_port_test,
    train_from_config,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import (
    trainers,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.checkpoint import (
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
FRAMES, SCALE, LR_HW = 3, 4, 16
NORM = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
        {"name": "ToTensor"}]
NETS_SMALL = {
    "EDSRNet": dict(in_channels=1, out_channels=1, num_resblocks=2, num_features=16,
                    upscale_factor=SCALE, res_scale=0.1),
    "SRFBNet": dict(in_channels=1, out_channels=1, num_steps=2, num_features=8, num_groups=2,
                    upscale_factor=SCALE),
    "Bicubic": dict(upscale_factor=SCALE),
}
SISR_CONFIGS = sorted(p for sub in ("test", "train") for net in ("bicubic", "edsr_net", "srfb_net")
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
def _jax_params(name):
    x = np.zeros((1, LR_HW, LR_HW, 1), np.float32)
    params = getattr(jax_models, name)(**NETS_SMALL[name]).init(jax.random.PRNGKey(0), x)
    return jax.tree.map(np.asarray, params["params"])


def _port_net(name):
    net = getattr(models, name)(**NETS_SMALL[name])
    net.load_state_dict(state_dict_from_jax_params(_jax_params(name), name), strict=True)
    return net


# -------------------------------------------------------------------- data
AUGMENTS = [  # configs/train/edsr_net/exp1_x4.yaml, with a crop that fits the tree
    {"name": "RandomHorizontalFlip"},
    {"name": "RandomVerticalFlip"},
    {"name": "RandomCropPatch", "kwargs": {"size": [6, 6], "ratio": SCALE}},
]


def _ds_kwargs(tree, split, augments=None):
    return dict(data_dir=tree["imgs_dir"], type=split, downscale_factor=SCALE, transforms=NORM,
                augments=augments)


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        va, vb = np.asarray(a[key]), np.asarray(b[key])
        assert va.dtype == vb.dtype and va.shape == vb.shape, key
        np.testing.assert_array_equal(va, vb, err_msg=key)


def test_sisr_items_and_augmented_batches_equal_jax(tree):
    for split in ("train", "test"):
        port, ref = SISRDataset(**_ds_kwargs(tree, split)), JaxSISRDataset(**_ds_kwargs(tree, split))
        assert len(port) == len(ref) == 2 * FRAMES
        assert port.data == ref.data
        for i in range(len(ref)):
            _assert_same(port[i], ref[i])
        assert port[0]["lr_img"].shape == (LR_HW, LR_HW, 1)
        assert port[0]["hr_img"].shape == (LR_HW * SCALE, LR_HW * SCALE, 1)
    assert DATASETS.get("AcdcSISRDataset") is DATASETS.get("Dsb15SISRDataset") is SISRDataset

    port = Dataloader(SISRDataset(**_ds_kwargs(tree, "train", AUGMENTS)), batch_size=4,
                      shuffle=True, num_workers=2)
    ref = JaxDataloader(JaxSISRDataset(**_ds_kwargs(tree, "train", AUGMENTS)), batch_size=4,
                        shuffle=True, num_workers=2)
    for seed in jax_seed_everything("vsr", 2).np_random_seeds:
        port.set_epoch(seed)
        ref.set_epoch(seed)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            _assert_same(a, b)
        assert got[0]["lr_img"].shape == (4, 6, 6, 1)
        assert got[0]["hr_img"].shape == (4, 24, 24, 1)


# ----------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    paths = {}
    for name in ("EDSRNet", "SRFBNet"):
        paths[name, "pth"] = root / f"{name}.pth"
        torch.save({"net": _port_net(name).state_dict()}, paths[name, "pth"])
    params = _jax_params("EDSRNet")
    paths["EDSRNet", "pickle"] = root / "EDSRNet_pickle.pth"
    jax_save_checkpoint(paths["EDSRNet", "pickle"], params=params,
                        opt_state=optax.adam(1e-3).init(params), epoch=1,
                        seed_state=jax_seed_everything("vsr", 2))
    paths["Bicubic", None] = root / "missing.pth"  # never read
    return paths


def _test_cfg(tree, saved_dir, loaded_path, name, prefix="Acdc"):
    coords = str(tree["coordinates_path"])
    workload = "SISRSRFB" if name == "SRFBNet" else "SISR"
    return {
        "main": {"saved_dir": str(saved_dir), "loaded_path": str(loaded_path)},
        "dataset": {"name": f"{prefix}SISRDataset",
                    "kwargs": {"data_dir": str(tree["imgs_dir"]), "downscale_factor": SCALE,
                               "transforms": NORM}},
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"batch_size": 1, "shuffle": False, "num_workers": 2}},
        "net": {"name": name, "kwargs": NETS_SMALL[name]},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [
            {"name": "PSNR"}, {"name": "SSIM"},
            {"name": "CardiacPSNR", "kwargs": {"coordinates_path": coords}},
            {"name": "CardiacSSIM", "kwargs": {"coordinates_path": coords}},
        ],
        "predictor": {"name": f"{prefix}{workload}Predictor",
                      "kwargs": {"device": "cpu", "saved_dir": str(saved_dir), "exported": True}},
    }


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _files(root):
    return {str(p.relative_to(root)) for p in Path(root).rglob("*")
            if p.is_file() and p.name != "config.yaml"}


SERVE_CASES = [("EDSRNet", "pth", "Acdc"), ("EDSRNet", "pickle", "Acdc"),
               ("SRFBNet", "pth", "Acdc"), ("Bicubic", None, "Acdc"), ("Bicubic", None, "Dsb15")]


@pytest.mark.parametrize("name,kind,prefix", SERVE_CASES,
                         ids=[f"{n}-{k}-{p}" for n, k, p in SERVE_CASES])
def test_predict_matches_jax(tree, checkpoints, tmp_path, name, kind, prefix):
    ckpt = checkpoints[name, kind]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_log = run_jax_test(JaxCfg(_test_cfg(tree, jax_dir, ckpt, name, prefix))).log
    predictor = run_port_test(Cfg(_test_cfg(tree, port_dir, ckpt, name, prefix)))
    assert predictor.log.keys() == jax_log.keys()
    for key in jax_log:
        np.testing.assert_allclose(predictor.log[key], jax_log[key], rtol=2e-3, atol=2e-3,
                                   err_msg=key)
    assert predictor.throughput["frames"] == 2 * FRAMES
    assert predictor.dataset_stats == prefix.lower()

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


def test_export_nifti_still_raises(tmp_path):
    """``export_nifti`` is ported: like the JAX predictor, it raises only
    without a ``saved_dir`` to write into (``tests/test_torch_host_io.py``
    holds its files to the JAX package's)."""
    cls = PREDICTORS.get("AcdcSISRPredictor")
    with pytest.raises(TypeError):
        cls(device="cpu", export_nifti=True)
    assert cls(device="cpu", export_nifti=True, saved_dir=str(tmp_path)).export_nifti is True


# ---------------------------------------------------------------- training
LR_RATE, N_ITEMS, BATCH, EPOCHS = 1e-4, 8, 4, 6  # 2 steps an epoch × 6 = 12 Adam steps
TRAINERS_OF = {"EDSRNet": "SISRTrainer", "SRFBNet": "SISRSRFBTrainer"}


class _ListDataset:
    """In-memory items (channels-last numpy), for both frameworks' loaders."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _items(seed=4, n=N_ITEMS, hw=8):
    rng = np.random.default_rng(seed)
    return [{"lr_img": rng.standard_normal((hw, hw, 1)).astype(np.float32),
             "hr_img": rng.standard_normal((hw * SCALE, hw * SCALE, 1)).astype(np.float32)}
            for _ in range(n)]


def _trained_pair(name, items, num_epochs, **knobs):
    """The JAX trainer and the port's, trained from the same weights."""
    cls = TRAINERS_OF[name]
    jax_loader = JaxDataloader(_ListDataset(items), batch_size=BATCH, shuffle=False)
    optimizer = JaxOptimizer("Adam", lr=LR_RATE, weight_decay=0)
    ref = getattr(jax_trainers, cls)(
        device="cpu", train_dataloader=jax_loader, valid_dataloader=jax_loader,
        net=getattr(jax_models, name)(**NETS_SMALL[name]), loss_fns=[JL.L1Loss()],
        loss_weights=[1.0], metric_fns=[JM.PSNR(), JM.SSIM()], optimizer=optimizer,
        num_epochs=num_epochs, **knobs)
    ref.params = jax.tree.map(jnp.asarray, _jax_params(name))
    ref.opt_state = optimizer.init(ref.params)
    ref.train()

    loader = Dataloader(_ListDataset(items), batch_size=BATCH, shuffle=False)
    port = getattr(trainers, cls)(
        device="cpu", train_dataloader=loader, valid_dataloader=loader, net=_port_net(name),
        loss_fns=[PL.L1Loss()], loss_weights=[1.0], metric_fns=[PM.PSNR(), PM.SSIM()],
        optimizer=Optimizer("Adam", lr=LR_RATE, weight_decay=0), num_epochs=num_epochs, **knobs)
    port.train()
    return port, ref


# (key, rtol, atol).  Measured over the 12 steps, relative: Loss 3.7e-7 (EDSR)
# and 7.5e-7 (SRFB); PSNR up to 1.7e-6.  PSNR/SSIM score frames rounded to
# uint8, where an ulp can flip one pixel by a gray level: in one EDSR valid
# epoch that moved the SSIM of these noise frames (~0.04) by 1.3e-5 absolute
# (3.1e-4 relative) while every other epoch stayed within 2.1e-6 relative;
# the SSIM's atol admits about one such flip.
TRAJECTORY_TOL = (("Loss", 1e-5, 1e-7), ("L1Loss", 1e-5, 1e-7), ("PSNR", 1e-4, 1e-7),
                  ("SSIM", 1e-4, 2e-5))


@pytest.mark.parametrize("name", list(TRAINERS_OF))
def test_trajectory_matches_jax_trainer(name):
    port, ref = _trained_pair(name, _items(), EPOCHS)
    for split in ("train", "valid"):
        want, got = ref.history[split], port.history[split]
        assert len(got) == len(want) == EPOCHS
        assert [list(g) for g in got] == [list(w) for w in want] == [
            ["Loss", "L1Loss", "PSNR", "SSIM"]] * EPOCHS
        for key, rtol, atol in TRAJECTORY_TOL:
            np.testing.assert_allclose([g[key] for g in got], [w[key] for w in want],
                                       rtol=rtol, atol=atol, err_msg=f"{split} {key}")
    train_loss = [h["Loss"] for h in port.history["train"]]
    assert abs(train_loss[0] - train_loss[-1]) > 1e-4  # the trajectory moves
    # one LR frame an item: the workload-neutral frame count
    assert port.throughput["frames_per_sec"] > 0
    assert port._frame_count(next(iter(port.train_dataloader))) == BATCH


def test_srfb_loss_is_the_mean_over_steps_and_metrics_use_the_last():
    trainer = trainers.SISRSRFBTrainer(device="cpu", loss_fns=[PL.L1Loss()],
                                       metric_fns=[PM.PSNR()])
    target = torch.zeros(1, 4, 4, 1)
    outputs = [torch.full((1, 4, 4, 1), v) for v in (1.0, 3.0)]
    (loss,) = trainer._compute_losses(outputs, {"hr_img": target}, True)
    assert loss.item() == 2.0
    assert trainer._display_outputs(outputs) is outputs[-1]
    (psnr,) = trainer._compute_metrics(outputs, target)
    (last,) = trainers.SISRTrainer._compute_metrics(trainer, outputs[-1], target)
    assert psnr.item() == last.item()


# bf16 port vs bf16 JAX, relative, at ~2.5x the deviation measured on these
# inputs (one EDSR epoch: one train step and one valid batch): train Loss
# 3.7e-7, PSNR 2.0e-6, SSIM 5.6e-6; valid (after the step) Loss 6.3e-6,
# PSNR 4.5e-5, SSIM 4.9e-3 (SSIM of noise is ~0.04 and counts rounding flips
# to uint8).  The raw outputs: the port's bf16-vs-fp32 gap over JAX's is
# 0.84-0.85 on seeds 5 and 7 (RefineNet's: 0.84-0.86), held to
# ``tests/test_torch_tpu_knobs.py``'s BF16_GAP_RATIO.
BF16_RTOL = {"Loss": 2e-5, "L1Loss": 2e-5, "PSNR": 1.2e-4, "SSIM": 1.2e-2}
BF16_GAP_RATIO = (0.6, 1.5)


def test_bf16_edsr_step_matches_jax_bf16():
    port, ref = _trained_pair("EDSRNet", _items(seed=9, n=BATCH, hw=12), 1,
                              compute_dtype="bfloat16")
    for split in ("train", "valid"):
        (got,), (want,) = port.history[split], ref.history[split]
        for key, rtol in BF16_RTOL.items():
            np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=0,
                                       err_msg=f"{split} {key}")
    assert all(p.dtype == torch.float32 for p in port.net.parameters())
    assert all(v.dtype == torch.float32 for st in port.opt.state.values()
               for v in st.values() if torch.is_tensor(v) and v.dim())

    params, net = _jax_params("EDSRNet"), _port_net("EDSRNet").eval()
    jax_net = jax_models.EDSRNet(**NETS_SMALL["EDSRNet"])
    for seed in (5, 7):
        x = np.random.default_rng(seed).standard_normal((2, LR_HW, LR_HW, 1)).astype(np.float32)
        j32 = np.asarray(jax_net.apply({"params": params}, x))
        bf16_params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
        j16 = np.asarray(jax_net.apply({"params": bf16_params}, jnp.asarray(x, jnp.bfloat16)),
                         np.float32)
        with torch.inference_mode():
            p32 = net(torch.from_numpy(x)).numpy()
            p16 = forward_in(net, torch.bfloat16, torch.from_numpy(x)).numpy()
        ratio = np.sqrt(np.mean((p16 - p32) ** 2) / np.mean((j16 - j32) ** 2))
        assert BF16_GAP_RATIO[0] < ratio < BF16_GAP_RATIO[1], (seed, ratio)


def _train_cfg(tree, saved_dir, name, loaded_path=None):
    """configs/train/{edsr_net,srfb_net}/exp1_x4.yaml on the small tree, with
    its logger, on the CPU."""
    workload = "SISRSRFB" if name == "SRFBNet" else "SISR"
    return {
        "main": {"random_seed": "vsr", "saved_dir": str(saved_dir), "loaded_path": loaded_path},
        "dataset": {"name": "AcdcSISRDataset",
                    "kwargs": {"data_dir": str(tree["imgs_dir"]), "downscale_factor": SCALE,
                               "transforms": NORM, "augments": AUGMENTS}},
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"train_batch_size": 4, "valid_batch_size": 1, "shuffle": True,
                                  "num_workers": 2}},
        "net": {"name": name, "kwargs": NETS_SMALL[name]},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [{"name": "PSNR"}, {"name": "SSIM"}],
        "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-4, "weight_decay": 0}},
        "logger": {"name": f"Acdc{workload}Logger", "kwargs": {"dummy_input": [4, 1, 6, 6]}},
        "monitor": {"name": "Monitor",
                    "kwargs": {"mode": "min", "target": "Loss", "saved_freq": 1, "early_stop": 0}},
        "trainer": {"name": f"Acdc{workload}Trainer", "kwargs": {"device": "cpu", "num_epochs": 2}},
    }


@pytest.mark.parametrize("name", list(TRAINERS_OF))
def test_train_from_config_logs_checkpoints_and_the_jax_package_reads_them(tree, tmp_path, name):
    saved = tmp_path / "run"
    trainer = train_from_config(Cfg(_train_cfg(tree, saved, name)))
    assert trainer.device == torch.device("cpu") and len(trainer.history["train"]) == 2
    assert all(np.isfinite(v) for h in trainer.history["train"] + trainer.history["valid"]
               for v in h.values())
    assert any((saved / "log").iterdir())  # the tensorboardX event file of the frame logger
    best = saved / "checkpoints" / "model_best.pth"
    variables = load_net_variables(best, name)
    net = getattr(models, name)(**NETS_SMALL[name])
    net.load_state_dict(load_checkpoint(best)["net"], strict=True)
    x = np.random.default_rng(3).standard_normal((1, LR_HW, LR_HW, 1)).astype(np.float32)
    want = getattr(jax_models, name)(**NETS_SMALL[name]).apply(variables, x)
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    for g, w in zip(got if name == "SRFBNet" else [got], want if name == "SRFBNet" else [want]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5, rtol=1e-4)


# --------------------------------------------------------------------- zoo
@pytest.fixture(scope="module")
def zoo_cwd(tmp_path_factory):
    """A cwd where the zoo's relative ./data/... paths resolve to a small
    tree: HR 132 is divisible by every factor and each LR admits the train
    configs' 32×32 crop."""
    root = tmp_path_factory.mktemp("zoo_cwd")
    tree = make_acdc_tree(root / "fixture", patients_per_split=1, slices=1, frames=2,
                          hr_size=(132, 132), factors=(2, 3, 4))
    for prep, crop in (("acdc_preprocessed", "acdc_cropped"),
                       ("dsb15_preprocessed", "dsb15_cropped")):
        (root / "data" / prep).mkdir(parents=True)
        (root / "data" / prep / "imgs").symlink_to(tree["imgs_dir"])
        (root / "data" / crop).mkdir(parents=True)
        (root / "data" / crop / "coordinates.pkl").symlink_to(tree["coordinates_path"])
    return root


@functools.lru_cache(maxsize=None)
def _jax_param_count(name, kwargs_items):
    net = getattr(jax_models, name)(**dict(kwargs_items))
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), np.zeros((1, 8, 8, 1), np.float32))
    return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes.get("params", {})))


def test_the_sisr_zoo_is_complete():
    assert len(SISR_CONFIGS) == 24


@pytest.mark.parametrize("path", SISR_CONFIGS,
                         ids=[str(p.relative_to(REPO / "configs")) for p in SISR_CONFIGS])
def test_sisr_zoo_config_constructs(path, zoo_cwd, monkeypatch):
    _import_components()
    monkeypatch.chdir(zoo_cwd)
    cfg = load_config(path)
    net = NETS.build(cfg.net, generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in net.parameters())
    assert n_params == _jax_param_count(cfg.net.name, tuple(sorted(cfg.net.kwargs.items())))
    r = cfg.net.kwargs.upscale_factor
    with torch.inference_mode():
        out = net(torch.zeros(1, 8, 8, 1))
    out = out[-1] if isinstance(out, list) else out
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
        # the DSB15 test configs score with the Acdc predictors (ACDC stats)
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
    assert item["lr_img"].shape[-1] == item["hr_img"].shape[-1] == 1
    assert item["hr_img"].shape[0] == item["lr_img"].shape[0] * r
    assert type(engine).__name__ == (cfg.get("predictor") or cfg.get("trainer")).name
