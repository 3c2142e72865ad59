"""Every drf_net / frvsr_net YAML of ``configs/`` through the port's ``main`` on the CPU, at shrunk size.

Each YAML is loaded as it ships and patched only where a CPU run on a small
tree needs it: ``device: cpu``, the nets shrunk (DRF 8 features × 2
groups, FRVSR 1 resblock), ``exported: false``, the run's ``saved_dir``,
two loader threads; the test configs' ``loaded_path`` is a ``{'net':
state_dict}`` of the JAX init at the config's factor; the train configs
train one epoch at batch 4 on 8×8 LR crops.  The data paths stay
relative: the test runs in a directory whose ``./data/...`` are one
``make_acdc_tree`` tree (HR 48×48 at ×2/×3/×4, 10 frames, which FRVSR's
training windows need).

* The 9 test configs (DRF ×2/×3/×4, FRVSR ×4, each also on the DSB15
  dataset, and ``frvsr_net/exp1_x4_tpu.yaml``: bf16, ``max_flow: 4``):
  the port's Test log equals the JAX package's ``test_from_config`` on the
  same patched config at rtol/atol 2e-3 (the port's bf16 run with oneDNN
  off, as ``tests/test_torch_misr_runner.py`` explains), and the ``_tpu``
  run reports its two telemetry sites.
* The 4 train configs: one epoch through ``train_from_config``, every
  logged value finite, ``model_best.pth`` written and loadable.
"""
import copy
import functools
import math
from pathlib import Path

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
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)
from fixtures import make_acdc_tree
from jax_data_caches import empty_jax_data_caches  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SHRINK = {"DRFNet": {"num_features": 8, "num_groups": 2}, "FRVSRNet": {"num_resblocks": 1}}
TEST_YAMLS = sorted(p for net in ("drf_net", "frvsr_net")
                    for p in (REPO / "configs" / "test" / net).glob("*.yaml"))
TRAIN_YAMLS = sorted(p for net in ("drf_net", "frvsr_net")
                     for p in (REPO / "configs" / "train" / net).glob("*.yaml"))


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
    root = tmp_path_factory.mktemp("vsr_yamls")
    tree = make_acdc_tree(root / "fixture", patients_per_split=1, slices=1, frames=10,
                          hr_size=(48, 48), factors=(2, 3, 4))
    for prep, crop in (("acdc_preprocessed", "acdc_cropped"),
                       ("dsb15_preprocessed", "dsb15_cropped")):
        (root / "data" / prep).mkdir(parents=True)
        (root / "data" / prep / "videos").symlink_to(tree["videos_dir"])
        (root / "data" / crop).mkdir(parents=True)
        (root / "data" / crop / "coordinates.pkl").symlink_to(tree["coordinates_path"])
    return root


@functools.lru_cache(maxsize=None)
def _state_dict(name, r):
    """The port's weights from the JAX init of the shrunk net at ×r."""
    kwargs = dict(in_channels=1, out_channels=1, upscale_factor=r, **SHRINK[name])
    x = np.zeros((1, 2, 8, 8, 1), np.float32)
    variables = jax.tree.map(np.asarray, getattr(jax_models, name)(**kwargs).init(
        jax.random.PRNGKey(0), x))
    return state_dict_from_jax_params(variables, name)


def _shrunk(path, tmp_path) -> dict:
    """The YAML as shipped, patched for a small CPU run."""
    cfg = load_config(path)
    name = cfg["net"]["name"]
    cfg["net"]["kwargs"].update(SHRINK[name])
    cfg["main"]["saved_dir"] = str(tmp_path / "run")
    cfg["dataloader"]["kwargs"]["num_workers"] = 2
    if "predictor" in cfg:
        ckpt = tmp_path / "net.pth"
        tmp_path.mkdir(parents=True, exist_ok=True)
        torch.save({"net": _state_dict(name, cfg["net"]["kwargs"]["upscale_factor"])}, ckpt)
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


def test_the_vsr_yamls_are_all_here():
    assert len(TEST_YAMLS) == 9 and len(TRAIN_YAMLS) == 4


@pytest.mark.parametrize("path", TEST_YAMLS,
                         ids=[str(p.relative_to(REPO / "configs")) for p in TEST_YAMLS])
def test_test_yaml_log_matches_jax(path, data_cwd, tmp_path, monkeypatch):
    monkeypatch.chdir(data_cwd)
    cfg = _shrunk(path, tmp_path / "port")
    jax_cfg = JaxCfg(copy.deepcopy(dict(cfg)) | {"main": {**cfg["main"],
                                                          "saved_dir": str(tmp_path / "jax")}})
    jax_cfg["predictor"]["kwargs"]["saved_dir"] = str(tmp_path / "jax")
    want = run_jax_test(jax_cfg).log
    with torch.backends.mkldnn.flags(enabled=False):  # bf16 convs summed in fp32
        predictor = run_port_test(Cfg(cfg))
    assert isinstance(predictor.net, getattr(models, cfg["net"]["name"]))
    assert predictor.log.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(predictor.log[key], want[key], rtol=2e-3, atol=2e-3,
                                   err_msg=key)
    assert predictor.throughput["frames"] == 10
    if cfg["net"]["kwargs"].get("max_flow"):
        assert sorted(predictor.telemetry_summary) == ["lr_flow_window", "sr_flow_window"]


@pytest.mark.parametrize("path", TRAIN_YAMLS,
                         ids=[str(p.relative_to(REPO / "configs")) for p in TRAIN_YAMLS])
def test_train_yaml_trains_an_epoch(path, data_cwd, tmp_path, monkeypatch):
    monkeypatch.chdir(data_cwd)
    cfg = _shrunk(path, tmp_path)
    trainer = train_from_config(Cfg(cfg))
    logs = trainer.history["train"] + trainer.history["valid"]
    assert len(trainer.history["train"]) == 1
    assert all(math.isfinite(v) for log in logs for v in log.values())
    if cfg["net"]["name"] == "FRVSRNet":
        assert list(trainer.history["train"][0]) == ["Loss", "FlowLoss", "MSELoss", "PSNR", "SSIM"]
    best = load_checkpoint(tmp_path / "run" / "checkpoints" / "model_best.pth")
    getattr(models, cfg["net"]["name"])(**cfg["net"]["kwargs"]).load_state_dict(best["net"])
