"""RefineNet's DSB15 test YAMLs through both packages' ``main`` on the CPU.

``configs/test/refine_net/exp1_x{2,3,4}_dsb15.yaml`` are loaded as they
ship and patched only where a small CPU run needs it, as
``tests/test_torch_refine_yamls.py`` patches the ACDC ones: ``device:
cpu``, the net shrunk to features [4, 4] (its 3 stages, 6 warm-up frames
and phase code kept), the run's ``saved_dir``, two loader threads, and a
``loaded_path`` holding the JAX init at the config's factor.  Their export
stays on.  The data paths stay relative: the test runs in a directory
whose ``./data/dsb15_preprocessed`` and ``./data/dsb15_cropped`` are one
DSB15 tree written by the port's ``tools/gen_synthetic_data --layout
dsb15`` (``dsb15_preprocess``, then the port's ``cardiac_cropping`` and
``gen_positional_encoding``): one test patient, two sax series of 30
frames, HR 48×48, LR ×2, ×3, ×4.

Both packages' Test logs agree at rtol/atol 2e-3, their CSV rows too; the
exported PNGs and GIFs decode within one gray level of the JAX package's.
About 26 s in one process (pytest's count).
"""
import copy
import csv
import functools
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
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import (
    Cfg,
    load_config,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
    test_from_config as run_port_test,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import (
    gen_synthetic_data,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)
from gray_frames import gif_frames, png_frame
from jax_data_caches import empty_jax_data_caches  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FRAMES, SLICES = 30, 2
YAMLS = [REPO / "configs" / "test" / "refine_net" / f"exp1_x{r}_dsb15.yaml" for r in (2, 3, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_cwd(tmp_path_factory):
    root = tmp_path_factory.mktemp("dsb15_yamls")
    tree = gen_synthetic_data.main(root / "phantom", patients_train=0, patients_test=1, size=48,
                                   slices=SLICES, frames=FRAMES, factors=(2, 3, 4),
                                   layout="dsb15")
    pre, crop = root / "data" / "dsb15_preprocessed", root / "data" / "dsb15_cropped"
    pre.mkdir(parents=True)
    crop.mkdir(parents=True)
    (pre / "videos").symlink_to(tree["videos_dir"])
    (pre / "position_code.pkl").symlink_to(tree["pos_code_path"])
    (crop / "coordinates.pkl").symlink_to(tree["coordinates_path"])
    return root


@functools.lru_cache(maxsize=None)
def _state_dict(kwargs_items):
    kwargs = dict(kwargs_items)
    T = FRAMES + 2 * kwargs["num_updated_frames"]
    params = jax_models.RefineNet(**kwargs).init(
        jax.random.PRNGKey(0), np.zeros((1, T, 8, 8, 1), np.float32),
        np.zeros((1, T, 1), np.float32))["params"]
    return state_dict_from_jax_params(jax.tree.map(np.asarray, params), "RefineNet")


def _shrunk(path, tmp_path) -> dict:
    cfg = load_config(path)
    cfg["net"]["kwargs"].update(num_features=[4, 4])
    cfg["main"]["saved_dir"] = str(tmp_path / "run")
    cfg["dataloader"]["kwargs"]["num_workers"] = 2
    tmp_path.mkdir(parents=True, exist_ok=True)
    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["net"]["kwargs"].items()}
    torch.save({"net": _state_dict(tuple(sorted(kwargs.items())))}, tmp_path / "net.pth")
    cfg["main"]["loaded_path"] = str(tmp_path / "net.pth")
    cfg["predictor"]["kwargs"].update(device="cpu", saved_dir=str(tmp_path / "run"))
    return cfg


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_the_dsb15_yamls_are_all_here_and_export():
    for path in YAMLS:
        cfg = load_config(path)
        assert cfg["dataset"]["name"] == "Dsb15VSRRefineNetDataset"
        assert cfg["predictor"]["kwargs"]["exported"] is True


@pytest.mark.parametrize("path", YAMLS, ids=[p.name for p in YAMLS])
def test_dsb15_yaml_log_matches_jax(path, data_cwd, tmp_path, monkeypatch):
    monkeypatch.chdir(data_cwd)
    cfg = _shrunk(path, tmp_path / "port")
    jax_cfg = JaxCfg(copy.deepcopy(dict(cfg)) | {"main": {**cfg["main"],
                                                          "saved_dir": str(tmp_path / "jax")}})
    jax_cfg["predictor"]["kwargs"]["saved_dir"] = str(tmp_path / "jax")
    want = run_jax_test(jax_cfg).log
    predictor = run_port_test(Cfg(cfg))
    assert predictor.log.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(predictor.log[key], want[key], rtol=2e-3, atol=2e-3,
                                   err_msg=key)
        assert np.isfinite(predictor.log[key])
    assert predictor.throughput["frames"] == SLICES * FRAMES

    port, jax_dir = tmp_path / "port" / "run", tmp_path / "jax"
    got, want_rows = _rows(port / "results.csv"), _rows(jax_dir / "results.csv")
    assert got[0] == want_rows[0] and len(got) == 1 + SLICES * FRAMES
    assert [r[0] for r in got] == [r[0] for r in want_rows]
    np.testing.assert_allclose(np.array([[float(x) for x in r[1:]] for r in got[1:]]),
                               np.array([[float(x) for x in r[1:]] for r in want_rows[1:]]),
                               rtol=2e-3, atol=2e-3)
    gifs = sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*.gif"))
    assert [str(p) for p in gifs] == ["videos/701/sequence01.gif", "videos/701/sequence02.gif"]
    for rel in gifs:
        a, b = gif_frames(jax_dir / rel), gif_frames(port / rel)
        assert len(a) == len(b) == FRAMES
        assert all(np.abs(x.astype(np.int16) - y).max() <= 1 for x, y in zip(a, b)), rel
    pngs = sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*.png"))
    assert len(pngs) == SLICES * FRAMES
    for rel in pngs:
        a, b = png_frame(jax_dir / rel).astype(np.int16), png_frame(port / rel)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, rel
