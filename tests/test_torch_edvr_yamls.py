"""Every edvr_net YAML of ``configs/`` through the port's ``main`` on the CPU, at shrunk size.

* The 3 test configs (``exp1_x4``, ``exp1_x4_dsb15``, ``exp1_x4_tpu``:
  bf16, ``dcn_max_offset: 2``), loaded as they ship and patched only where a
  CPU run on a small tree needs it (``device: cpu``, the net shrunk to nf 8,
  groups 2, one residual block each side, ``exported: false``, the run's
  ``saved_dir``, two loader threads; ``loaded_path`` a ``{'net':
  state_dict}`` of seeded weights with the offset convs drawn off their
  zero init, so that the DCN samples at fractional offsets): the port's
  Test log equals the JAX package's ``test_from_config`` on the same
  patched config at rtol/atol 2e-3 (the port's bf16 run with oneDNN off,
  as ``tests/test_torch_misr_runner.py`` explains), and the ``_tpu`` run
  reports the four ``dcn_offset_window`` sites.  The data paths stay
  relative: the test runs in a directory whose ``./data/...`` are one
  ``make_acdc_tree`` tree (HR 48×48, 6 frames).
* The 2 train configs: one epoch through ``train_from_config`` at batch 4
  on 8×8 LR crops, every logged value finite, the ``_tpu`` run's valid
  epoch reporting the four sites, ``model_best.pth`` written and loadable.
  (A trajectory against the JAX package's trainer is not run here: its CPU
  compile of EDVR's training step did not end within 25 minutes on an
  8-core host.  ``tests/test_torch_edvr.py`` holds one step's loss and
  every gradient to ``jax.value_and_grad`` instead.)
"""
import copy
import functools
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.config import (
    Cfg as JaxCfg,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.main import (
    test_from_config as run_jax_test,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import (
    Cfg,
    load_config,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
    test_from_config as run_port_test,
    train_from_config,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.checkpoint import (
    load_checkpoint,
)
from fixtures import make_acdc_tree
from jax_data_caches import empty_jax_data_caches  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SHRINK = {"nf": 8, "groups": 2, "front_RBs": 1, "back_RBs": 1}
TEST_YAMLS = sorted((REPO / "configs" / "test" / "edvr_net").glob("*.yaml"))
TRAIN_YAMLS = sorted((REPO / "configs" / "train" / "edvr_net").glob("*.yaml"))
DCN_SITES = [f"pcd_align/{lvl}_dcnpack/dcn_offset_window" for lvl in ("L3", "L2", "L1", "cas")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (test workers run side by
    side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_cwd(tmp_path_factory):
    root = tmp_path_factory.mktemp("edvr_yamls")
    tree = make_acdc_tree(root / "fixture", patients_per_split=1, slices=1, frames=6,
                          hr_size=(48, 48), factors=(4,))
    for prep, crop in (("acdc_preprocessed", "acdc_cropped"),
                       ("dsb15_preprocessed", "dsb15_cropped")):
        (root / "data" / prep).mkdir(parents=True)
        (root / "data" / prep / "videos").symlink_to(tree["videos_dir"])
        (root / "data" / crop).mkdir(parents=True)
        (root / "data" / crop / "coordinates.pkl").symlink_to(tree["coordinates_path"])
    return root


@functools.lru_cache(maxsize=None)
def _state_dict():
    """Seeded weights of the shrunk net, the offset convs drawn off their
    zero init (|offset| reaches a few pixels: fractional sampling)."""
    net = models.EDVRNet(in_channels=1, out_channels=1, **SHRINK,
                         generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "conv_offset_mask" in name:
                p.normal_(0.0, 0.05, generator=gen)
    return net.state_dict()


def _shrunk(path, tmp_path) -> dict:
    """The YAML as shipped, patched for a small CPU run."""
    cfg = load_config(path)
    cfg["net"]["kwargs"].update(SHRINK)
    cfg["main"]["saved_dir"] = str(tmp_path / "run")
    cfg["dataloader"]["kwargs"]["num_workers"] = 2
    if "predictor" in cfg:
        ckpt = tmp_path / "net.pth"
        tmp_path.mkdir(parents=True, exist_ok=True)
        torch.save({"net": _state_dict()}, ckpt)
        cfg["main"]["loaded_path"] = str(ckpt)
        cfg["predictor"]["kwargs"].update(device="cpu", exported=False,
                                          saved_dir=str(tmp_path / "run"))
    else:
        cfg["trainer"]["kwargs"].update(device="cpu", num_epochs=1)
        cfg["dataloader"]["kwargs"]["train_batch_size"] = 4
        for aug in cfg["dataset"]["kwargs"]["augments"]:
            if aug["name"] == "RandomCropPatch":
                aug["kwargs"]["size"] = [8, 8]
        cfg["logger"]["kwargs"]["dummy_input"] = [4, 1, 8, 8]
    return cfg


def test_the_edvr_yamls_are_all_here():
    assert len(TEST_YAMLS) == 3 and len(TRAIN_YAMLS) == 2


@pytest.mark.parametrize("path", TEST_YAMLS,
                         ids=[str(p.relative_to(REPO / "configs")) for p in TEST_YAMLS])
def test_test_yaml_log_matches_jax(path, data_cwd, tmp_path, monkeypatch):
    monkeypatch.chdir(data_cwd)
    cfg = _shrunk(path, tmp_path / "port")
    jax_cfg = JaxCfg(copy.deepcopy(dict(cfg)) | {"main": {**cfg["main"],
                                                          "saved_dir": str(tmp_path / "jax")}})
    jax_cfg["predictor"]["kwargs"]["saved_dir"] = str(tmp_path / "jax")
    jax_pred = run_jax_test(jax_cfg)
    want = jax_pred.log
    with torch.backends.mkldnn.flags(enabled=False):  # bf16 convs summed in fp32
        predictor = run_port_test(Cfg(cfg))
    assert isinstance(predictor.net, models.EDVRNet)
    assert predictor.log.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(predictor.log[key], want[key], rtol=2e-3, atol=2e-3,
                                   err_msg=key)
    assert predictor.throughput["frames"] == 6
    if cfg["net"]["kwargs"].get("dcn_max_offset"):
        assert sorted(predictor.telemetry_summary) == sorted(DCN_SITES)
        for site, s in predictor.telemetry_summary.items():
            assert s["n"] == jax_pred.telemetry_summary[site]["n"], site
    else:
        assert predictor.telemetry_summary == {}


@pytest.mark.parametrize("path", TRAIN_YAMLS,
                         ids=[str(p.relative_to(REPO / "configs")) for p in TRAIN_YAMLS])
def test_train_yaml_trains_an_epoch(path, data_cwd, tmp_path, monkeypatch):
    monkeypatch.chdir(data_cwd)
    cfg = _shrunk(path, tmp_path)
    trainer = train_from_config(Cfg(cfg))
    logs = trainer.history["train"] + trainer.history["valid"]
    assert len(trainer.history["train"]) == 1
    assert all(math.isfinite(v) for log in logs for v in log.values())
    assert list(trainer.history["train"][0]) == ["Loss", "CharbonnierLoss", "PSNR", "SSIM"]
    if cfg["net"]["kwargs"].get("dcn_max_offset"):
        assert sorted(trainer.telemetry_summary) == sorted(DCN_SITES)
    best = load_checkpoint(tmp_path / "run" / "checkpoints" / "model_best.pth")
    models.EDVRNet(**cfg["net"]["kwargs"]).load_state_dict(best["net"])
