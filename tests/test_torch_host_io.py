"""The port's host utilities of the serving path, on the CPU.

* ``utils/dispatch.DoubleBuffer``: one item in flight, finished in push
  order; the predictors' loop launches item k+1 before it fetches item k,
  and ``EVSR_EAGER_EVAL=1`` gives the same logs, files, telemetry and
  ``item_seconds`` for a video (RefineNet), a single-image (EDSR) and a
  multi-frame predictor with telemetry (EDVR with ``dcn_max_offset``).
* ``export_nifti``: the files of the JAX package's predictors, for the
  whole-sequence (RefineNet) and the frame-buffered (EDSR) form.
* ``utils/native_io``: the native reader equals the Python reader and the
  JAX package's ``native_io``; ``EVSR_NO_NATIVE_IO=1`` and a library that
  cannot be built fall back to the Python reader, the latter with one
  WARNING.
* ``utils/profiling``: ``EVSR_PROFILE_DIR`` gives one trace per labelled
  epoch.
"""
import copy
import json
import logging

import numpy as np
import pytest
import torch

import jax

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import models as jax_models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.config import (
    Cfg as JaxCfg,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.main import (
    test_from_config as run_jax_test,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils import (
    native_io as jax_native_io,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import Cfg
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import (
    datasets,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
    test_from_config as run_port_test,
    train_from_config,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import (
    predictors,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils import (
    dispatch,
    native_io,
    nifti,
    profiling,
)
from fixtures import make_acdc_tree

pytest.importorskip("imageio")  # the GIF/PNG export compared between the modes

FRAMES, SCALE = 6, 4
NORM = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
        {"name": "ToTensor"}]
NETS = {
    "RefineNet": {"in_channels": 1, "out_channels": 1, "num_features": [4, 4], "num_stages": 2,
                  "upscale_factor": SCALE, "update_memory": True, "num_updated_frames": 2,
                  "refine_window_size": 5, "positional_encoding": True},
    "EDSRNet": {"in_channels": 1, "out_channels": 1, "num_resblocks": 1, "num_features": 6,
                "upscale_factor": SCALE},
    # a 1-pixel window: the DCN telemetry warns
    "EDVRNet": {"in_channels": 1, "out_channels": 1, "nf": 8, "groups": 2, "front_RBs": 1,
                "back_RBs": 1, "nframes": 5, "dcn_max_offset": 1},
}
CASES = {"refine": "RefineNet", "edsr": "EDSRNet", "edvr": "EDVRNet"}


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
    return make_acdc_tree(tmp_path_factory.mktemp("host_io"), patients_per_split=1, slices=2,
                          frames=FRAMES, hr_size=(48, 48), splits=("test",))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """RefineNet and EDSR from a JAX init (a JAX pickle both packages read);
    EDVR from the port's seed, its offset convs drawn wide."""
    root = tmp_path_factory.mktemp("host_io_ckpt")
    paths = {}
    T = FRAMES + 2 * NETS["RefineNet"]["num_updated_frames"]
    params = jax_models.RefineNet(**NETS["RefineNet"]).init(
        jax.random.PRNGKey(0), np.zeros((1, T, 12, 12, 1), np.float32),
        np.zeros((1, T, 1), np.float32))["params"]
    paths["RefineNet"] = root / "refine.pth"
    jax_save_checkpoint(paths["RefineNet"], params=params)
    params = jax_models.EDSRNet(**NETS["EDSRNet"]).init(
        jax.random.PRNGKey(1), np.zeros((1, 12, 12, 1), np.float32))["params"]
    paths["EDSRNet"] = root / "edsr.pth"
    jax_save_checkpoint(paths["EDSRNet"], params=params)
    net = models.EDVRNet(**NETS["EDVRNet"], generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "conv_offset_mask" in name:
                p.normal_(0.0, 0.5, generator=gen)  # offsets beyond the 1-pixel window
    paths["EDVRNet"] = root / "edvr.pth"
    torch.save({"net": net.state_dict()}, paths["EDVRNet"])
    return paths


def _cfg(tree, checkpoints, case, saved_dir, exported=True) -> dict:
    name = CASES[case]
    coords = str(tree["coordinates_path"])
    if name == "RefineNet":
        dataset = {"name": "AcdcVSRRefineNetDataset",
                   "kwargs": {"data_dir": str(tree["videos_dir"]), "downscale_factor": SCALE,
                              "transforms": NORM, "num_frames": 5, "num_updated_frames": 2,
                              "pos_code_path": str(tree["pos_code_path"])}}
        predictor = "AcdcVSRRefineNetPredictor"
    elif name == "EDSRNet":
        dataset = {"name": "AcdcSISRDataset",
                   "kwargs": {"data_dir": str(tree["imgs_dir"]), "downscale_factor": SCALE,
                              "transforms": NORM}}
        predictor = "AcdcSISRPredictor"
    else:
        dataset = {"name": "AcdcMISRDataset",
                   "kwargs": {"data_dir": str(tree["videos_dir"]), "downscale_factor": SCALE,
                              "transforms": NORM, "num_frames": 5}}
        predictor = "AcdcMISRPredictor"
    return {
        "main": {"saved_dir": str(saved_dir), "loaded_path": str(checkpoints[name])},
        "dataset": dataset,
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"batch_size": 1, "shuffle": False, "num_workers": 2}},
        "net": {"name": name, "kwargs": NETS[name]},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [{"name": "PSNR"}, {"name": "SSIM"},
                    {"name": "CardiacPSNR", "kwargs": {"coordinates_path": coords}},
                    {"name": "CardiacSSIM", "kwargs": {"coordinates_path": coords}}],
        "predictor": {"name": predictor,
                      "kwargs": {"device": "cpu", "saved_dir": str(saved_dir),
                                 "exported": exported, "export_nifti": True}},
    }


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*")
                  if p.is_file() and p.name != "config.yaml")


@pytest.mark.parametrize("eager", [False, True], ids=["double_buffered", "eager"])
def test_double_buffer_finishes_in_push_order(eager):
    done, trace = [], []
    pipe = dispatch.DoubleBuffer(lambda item: (done.append(item), trace.append(("finish", item))),
                                 eager=eager)
    for k in range(5):
        trace.append(("push", k))
        pipe.push(k)
        assert done == list(range(k + 1 if eager else k))
    pipe.drain()
    pipe.drain()  # nothing left: a no-op
    assert done == list(range(5))
    if not eager:  # item k finishes right after item k+1 is pushed
        assert trace[:5] == [("push", 0), ("push", 1), ("finish", 0), ("push", 2), ("finish", 1)]


@pytest.mark.parametrize("case", ["refine", "edsr"])
def test_predict_launches_the_next_item_before_fetching(tree, checkpoints, case, tmp_path,
                                                        monkeypatch):
    events = []
    step, wait = predictors.BasePredictor._step, dispatch.Fetch.wait

    def logged_step(self, batch, masks):
        events.append("launch")
        return step(self, batch, masks)

    def logged_wait(self):
        events.append("fetch")
        return wait(self)

    monkeypatch.setattr(predictors.BasePredictor, "_step", logged_step)
    monkeypatch.setattr(dispatch.Fetch, "wait", logged_wait)
    for eager in (False, True):
        events.clear()
        if eager:
            monkeypatch.setenv("EVSR_EAGER_EVAL", "1")
        run_port_test(Cfg(_cfg(tree, checkpoints, case, tmp_path / str(eager), exported=False)))
        n = events.count("launch")
        assert n >= 2 and events.count("fetch") == n
        if eager:
            assert events == ["launch", "fetch"] * n
        else:
            assert events == ["launch"] + ["launch", "fetch"] * (n - 1) + ["fetch"]


@pytest.mark.parametrize("case", ["refine", "edsr", "edvr"])
def test_eager_and_double_buffered_predict_agree(tree, checkpoints, case, tmp_path, monkeypatch,
                                                 caplog):
    runs = {}
    for mode in ("eager", "double_buffered"):
        if mode == "eager":
            monkeypatch.setenv("EVSR_EAGER_EVAL", "1")
        else:
            monkeypatch.delenv("EVSR_EAGER_EVAL")
        caplog.clear()
        with caplog.at_level(logging.INFO):
            pred = run_port_test(Cfg(_cfg(tree, checkpoints, case, tmp_path / mode)))
        lines = [r.getMessage() for r in caplog.records
                 if "telemetry" in r.getMessage() or "exceedance" in r.getMessage()]
        runs[mode] = (pred, lines)
    (a, lines_a), (b, lines_b) = runs["eager"], runs["double_buffered"]
    assert a.log == b.log
    assert a.telemetry_summary == b.telemetry_summary and lines_a == lines_b
    if case == "edvr":
        assert len(a.telemetry_summary) == 4 and any("exceedance" in m for m in lines_a)
    assert len(a.item_seconds) == len(b.item_seconds) == a.throughput["frames"] // (
        FRAMES if case == "refine" else 1)
    files = _files(tmp_path / "eager")
    assert files == _files(tmp_path / "double_buffered")
    assert {f.suffix for f in files} >= {".csv", ".gif", ".png", ".gz"}
    for f in files:
        assert (tmp_path / "eager" / f).read_bytes() == \
            (tmp_path / "double_buffered" / f).read_bytes(), f


@pytest.mark.parametrize("case", ["refine", "edsr"])
def test_export_nifti_equals_jax(tree, checkpoints, case, tmp_path):
    cfg = _cfg(tree, checkpoints, case, tmp_path / "port", exported=False)
    jax_cfg = copy.deepcopy(cfg)
    jax_cfg["main"]["saved_dir"] = jax_cfg["predictor"]["kwargs"]["saved_dir"] = \
        str(tmp_path / "jax")
    run_jax_test(JaxCfg(jax_cfg))
    run_port_test(Cfg(cfg))
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.nii.gz"))
    assert len(files) == 2  # one (H, W, 1, T) volume a sequence
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.nii.gz"))
    for rel in files:
        a = nifti.load(tmp_path / "jax" / rel).data
        b = nifti.load(tmp_path / "port" / rel).data
        assert a.shape == b.shape == (48, 48, 1, FRAMES) and a.dtype == b.dtype == np.float32
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (rel, diff.max())


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8, np.float64])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_native_reader_equals_python_and_jax(tmp_path, dtype, suffix):
    assert native_io.available()
    rng = np.random.default_rng(0)
    if np.issubdtype(dtype, np.integer):
        data = rng.integers(0, 250, (17, 13, 2, 9)).astype(dtype)
    else:
        data = rng.standard_normal((17, 13, 2, 9)).astype(dtype)
    path = tmp_path / f"vol{suffix}"
    nifti.save(data, path)
    got = native_io.load_volume(path)
    assert got.dtype == np.float32 and got.shape == data.shape
    np.testing.assert_array_equal(got, np.asarray(nifti.load(path).get_data(), np.float32))
    np.testing.assert_array_equal(got, jax_native_io.load_volume(path))


def test_native_batch_decode_and_the_datasets_read(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    paths, wants = [], []
    for i in range(6):
        want = rng.uniform(0, 255, (10 + i, 8, 1, 5)).astype(np.float32)
        paths.append(tmp_path / f"v{i}.nii.gz")
        nifti.save(want, paths[-1])
        wants.append(want)
    for got, want in zip(native_io.load_volumes(paths, threads=3), wants):
        np.testing.assert_array_equal(got, want)
    # the datasets' cache misses go through the library ...
    calls = []
    load = native_io.load_volume
    monkeypatch.setattr(native_io, "load_volume", lambda p: calls.append(p) or load(p))
    np.testing.assert_array_equal(datasets._read_volume(paths[0]), wants[0])
    assert calls == [paths[0]]
    # ... unless EVSR_NO_NATIVE_IO=1
    monkeypatch.setenv("EVSR_NO_NATIVE_IO", "1")
    assert not native_io.enabled()
    np.testing.assert_array_equal(datasets._read_volume(paths[1]), wants[1])
    assert calls == [paths[0]]


def test_a_library_that_cannot_be_built_warns_once(tmp_path, monkeypatch, caplog):
    def fail():
        raise RuntimeError("g++ failed (1): zlib.h: No such file or directory")

    monkeypatch.setattr(native_io, "_build", fail)
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_tried", False)
    want = np.arange(24, dtype=np.float32).reshape(2, 3, 1, 4)
    nifti.save(want, tmp_path / "v.nii.gz")
    with caplog.at_level(logging.WARNING):
        assert not native_io.available() and not native_io.enabled()
        np.testing.assert_array_equal(native_io.load_volume(tmp_path / "v.nii.gz"), want)
        np.testing.assert_array_equal(datasets._read_volume(tmp_path / "v.nii.gz"), want)
    warnings = [r for r in caplog.records if r.levelname == "WARNING"]
    assert len(warnings) == 1 and "Python reader" in warnings[0].getMessage()


def test_the_library_is_built_into_the_package_build_dir():
    assert native_io.available()
    path = native_io.library_path()
    assert path.exists() and path.parent == native_io.BUILD_DIR
    assert path.parent.name == "build" and path.parent.parent.name.endswith("_torch")


def test_profile_dir_traces_each_epoch(tmp_path, monkeypatch):
    with profiling.trace("unset"):  # without the variable: nothing
        pass
    tree = make_acdc_tree(tmp_path / "tree", patients_per_split=1, slices=1, frames=4,
                          hr_size=(16, 16), splits=("train", "valid"))
    cfg = {
        "main": {"random_seed": "vsr", "saved_dir": str(tmp_path / "run"), "loaded_path": None},
        "dataset": {"name": "AcdcVSRRefineNetDataset",
                    "kwargs": {"data_dir": str(tree["videos_dir"]), "downscale_factor": SCALE,
                               "transforms": NORM, "num_frames": 3, "num_updated_frames": 1,
                               "pos_code_path": str(tree["pos_code_path"])}},
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"train_batch_size": 2, "valid_batch_size": 1, "shuffle": True,
                                  "num_workers": 1}},
        "net": {"name": "RefineNet", "kwargs": {**NETS["RefineNet"], "num_features": [2],
                                                "num_stages": 1, "num_updated_frames": 1}},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [{"name": "PSNR"}],
        "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-3, "weight_decay": 0}},
        "monitor": {"name": "Monitor",
                    "kwargs": {"mode": "min", "target": "Loss", "saved_freq": 1, "early_stop": 0}},
        "trainer": {"name": "AcdcVSRRefineNetTrainer",
                    "kwargs": {"device": "cpu", "num_epochs": 1}},
    }
    monkeypatch.setenv("EVSR_PROFILE_DIR", str(tmp_path / "prof"))
    train_from_config(Cfg(cfg))
    assert sorted(p.name for p in (tmp_path / "prof").iterdir()) == ["train_epoch_1",
                                                                     "valid_epoch_1"]
    for label in ("train_epoch_1", "valid_epoch_1"):
        traces = list((tmp_path / "prof" / label).glob("*.json"))
        assert len(traces) == 1
        names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
        assert any(str(n).startswith("aten::") for n in names), label


def test_throughput_counts():
    t = profiling.Throughput()
    t.update(steps=2, frames=60)
    s = t.stats()
    assert s["steps"] == 2 and s["frames"] == 60 and s["frames_per_sec"] > 0
    t.reset()
    assert t.stats()["frames"] == 0
