"""RefineNet's ×2 and ×3 YAMLs of ``configs/`` through the port's ``main`` on the CPU, shrunk.

``configs/test/refine_net/exp1_x{2,3}.yaml`` and
``configs/train/refine_net/exp1_x{2,3}.yaml`` are loaded as they ship and
patched only where a small CPU run needs it: ``device: cpu``, the net
shrunk to features [4, 4] (its 3 stages, 6 warm-up frames and phase code
kept), ``exported: false``, the run's ``saved_dir``, two loader threads;
the test configs' ``loaded_path`` is a ``{'net': state_dict}`` of the JAX
init at the config's factor; the train configs train one epoch at batch 4
on 8×8 LR crops.  The data paths stay relative: the test runs in a
directory whose ``./data/...`` are one ``make_acdc_tree`` tree (HR 48×48
at ×2 and ×3, 12 frames: a training window of 7 with 6 warm-up frames
reaches 12 frames back into the tiled cycle).

* The test configs resolve, construct and serve through both packages'
  ``test_from_config``; the Test logs agree at rtol/atol 2e-3.
* The train configs train one epoch through the port's
  ``train_from_config``: every logged value finite, ``model_best.pth``
  written and loadable.
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
SHRINK = {"num_features": [4, 4]}
FRAMES = 12  # a training window reaches 6 + 6 frames back (the reference slices)
TEST_YAMLS = [REPO / "configs" / "test" / "refine_net" / f"exp1_x{r}.yaml" for r in (2, 3)]
TRAIN_YAMLS = [REPO / "configs" / "train" / "refine_net" / f"exp1_x{r}.yaml" for r in (2, 3)]


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
    root = tmp_path_factory.mktemp("refine_yamls")
    tree = make_acdc_tree(root / "fixture", patients_per_split=1, slices=1, frames=FRAMES,
                          hr_size=(48, 48), factors=(2, 3))
    (root / "data" / "acdc_preprocessed").mkdir(parents=True)
    (root / "data" / "acdc_preprocessed" / "videos").symlink_to(tree["videos_dir"])
    (root / "data" / "acdc_preprocessed" / "position_code.pkl").symlink_to(tree["pos_code_path"])
    (root / "data" / "acdc_cropped").mkdir(parents=True)
    (root / "data" / "acdc_cropped" / "coordinates.pkl").symlink_to(tree["coordinates_path"])
    return root


@functools.lru_cache(maxsize=None)
def _state_dict(kwargs_items):
    """The port's weights from the JAX init of the shrunk net."""
    kwargs = dict(kwargs_items)
    T = FRAMES + 2 * kwargs["num_updated_frames"]
    params = jax_models.RefineNet(**kwargs).init(
        jax.random.PRNGKey(0), np.zeros((1, T, 8, 8, 1), np.float32),
        np.zeros((1, T, 1), np.float32))["params"]
    return state_dict_from_jax_params(jax.tree.map(np.asarray, params), "RefineNet")


def _shrunk(path, tmp_path) -> dict:
    """The YAML as shipped, patched for a small CPU run."""
    cfg = load_config(path)
    cfg["net"]["kwargs"].update(SHRINK)
    cfg["main"]["saved_dir"] = str(tmp_path / "run")
    cfg["dataloader"]["kwargs"]["num_workers"] = 2
    if "predictor" in cfg:
        ckpt = tmp_path / "net.pth"
        tmp_path.mkdir(parents=True, exist_ok=True)
        kwargs = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in cfg["net"]["kwargs"].items()}
        torch.save({"net": _state_dict(tuple(sorted(kwargs.items())))}, ckpt)
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


def test_the_refine_yamls_are_all_here():
    assert all(p.exists() for p in TEST_YAMLS + TRAIN_YAMLS)


@pytest.mark.parametrize("path", TEST_YAMLS,
                         ids=[str(p.relative_to(REPO / "configs")) for p in TEST_YAMLS])
def test_test_yaml_log_matches_jax(path, data_cwd, tmp_path, monkeypatch):
    monkeypatch.chdir(data_cwd)
    cfg = _shrunk(path, tmp_path / "port")
    jax_cfg = JaxCfg(copy.deepcopy(dict(cfg)) | {"main": {**cfg["main"],
                                                          "saved_dir": str(tmp_path / "jax")}})
    jax_cfg["predictor"]["kwargs"]["saved_dir"] = str(tmp_path / "jax")
    want = run_jax_test(jax_cfg).log
    predictor = run_port_test(Cfg(cfg))
    assert isinstance(predictor.net, models.RefineNet)
    assert predictor.log.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(predictor.log[key], want[key], rtol=2e-3, atol=2e-3,
                                   err_msg=key)
    assert predictor.throughput["frames"] == FRAMES


@pytest.mark.parametrize("path", TRAIN_YAMLS,
                         ids=[str(p.relative_to(REPO / "configs")) for p in TRAIN_YAMLS])
def test_train_yaml_trains_an_epoch(path, data_cwd, tmp_path, monkeypatch):
    monkeypatch.chdir(data_cwd)
    cfg = _shrunk(path, tmp_path)
    trainer = train_from_config(Cfg(cfg))
    logs = trainer.history["train"] + trainer.history["valid"]
    assert len(trainer.history["train"]) == 1
    assert all(math.isfinite(v) for log in logs for v in log.values())
    best = load_checkpoint(tmp_path / "run" / "checkpoints" / "model_best.pth")
    models.RefineNet(**cfg["net"]["kwargs"]).load_state_dict(best["net"])
