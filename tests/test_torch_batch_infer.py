"""The port's ``tools/batch_infer.py`` against the JAX package's.

Both tools read the same ``make_acdc_tree`` test split and the same
weights (a port ``.pth``, which the JAX tool reads through its torch
import).  Tolerance: each CSV row's PSNR within 1e-4 dB and SSIM within
1e-5 of the JAX tool's (float32 forwards in two frameworks; measured
~2e-6 dB), the rows' names and order equal; the port on 2 gloo ranks
equals it on one rank to 1e-6 relative (its ranks run on one CPU thread).
"""
import csv
import json
import logging
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.tools import (
    batch_infer as jax_tool,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import (
    datasets,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import Cfg
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
    train_from_config,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
    RefineNet,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import (
    batch_infer as tool,
)

sys.path.insert(0, str(Path(__file__).parent))
from fixtures import make_acdc_tree  # noqa: E402

NET = dict(in_channels=1, out_channels=1, num_features=[4, 4], upscale_factor=4, num_stages=1,
           update_memory=True, num_updated_frames=2, refine_window_size=5,
           positional_encoding=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_a_rank():
    """One intra-op thread here and in the spawned ranks (test workers run
    side by side)."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("batch_infer")
    # two shapes of volume (16 and 24 px HR), so the grouping has two keys
    small = make_acdc_tree(root / "a", patients_per_split=2, slices=2, frames=5,
                           hr_size=(24, 24), splits=("test",))
    make_acdc_tree(root / "b", patients_per_split=1, slices=1, frames=5, hr_size=(32, 32),
                   splits=("test",))
    for src in (root / "b" / "videos").rglob("*.nii.gz"):
        dst = small["videos_dir"] / src.relative_to(root / "b" / "videos")
        dst = dst.with_name(dst.name.replace("patient001", "patient003"))
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(src.read_bytes())
    import pickle

    with open(small["pos_code_path"], "rb") as f:
        codes = pickle.load(f)
    with open(root / "b" / "position_code.pkl", "rb") as f:
        extra = pickle.load(f)
    codes.update({k.replace("patient001", "patient003"): v for k, v in extra.items()})
    with open(small["pos_code_path"], "wb") as f:
        pickle.dump(codes, f)
    net = RefineNet(**NET, generator=torch.Generator().manual_seed(3))
    torch.save({"net": net.state_dict()}, root / "model.pth")
    return small, root / "model.pth"


def _args(tree, out, *extra):
    small, ckpt = tree
    return [str(ckpt), str(small["videos_dir"]), str(small["pos_code_path"]), str(out),
            "--net-kwargs", json.dumps(NET), *extra]


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _assert_rows_close(got, want, psnr=1e-4, ssim=1e-5, rel=0.0):
    assert got[0] == want[0] == ["name", "frame", "PSNR", "SSIM"]
    assert [r[:2] for r in got] == [r[:2] for r in want]
    for g, w in zip(got[1:], want[1:]):
        assert float(g[2]) == pytest.approx(float(w[2]), abs=psnr, rel=rel), g[0]
        assert float(g[3]) == pytest.approx(float(w[3]), abs=ssim, rel=rel), g[0]


def test_csv_rows_equal_the_jax_tool(tree, tmp_path, capsys):
    want = jax_tool.main(_args(tree, tmp_path / "jax.csv"))
    got = tool.main(_args(tree, tmp_path / "port.csv", "--device", "cpu"))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    rows = _rows(tmp_path / "port.csv")
    _assert_rows_close(rows, _rows(tmp_path / "jax.csv"))
    assert len(rows) == 1 + 5 * 5  # 5 sequences of 5 frames
    assert got["sequences"] == want["sequences"] == 5 and got["frames"] == want["frames"] == 25
    assert got["devices"] == 1 and got["frames_per_sec"] > 0
    assert got["mean_psnr"] == pytest.approx(want["mean_psnr"], abs=1e-4)


def test_two_ranks_equal_one(tree, tmp_path):
    one = tool.main(_args(tree, tmp_path / "one.csv", "--device", "cpu"))
    two = tool.main(_args(tree, tmp_path / "two.csv", "--device", "cpu", "--num-devices", "2"))
    assert two["devices"] == 2 and two["frames"] == one["frames"]
    _assert_rows_close(_rows(tmp_path / "two.csv"), _rows(tmp_path / "one.csv"), psnr=0, ssim=0,
                       rel=1e-6)


def _train_cfg(root, parallel):
    tree = make_acdc_tree(root / "acdc", patients_per_split=1, slices=1, frames=5,
                          hr_size=(24, 24), splits=("train", "valid"))
    norm = {"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}}
    return Cfg({
        "main": {"random_seed": "vsr", "saved_dir": str(root / "run")},
        "dataset": {"name": "AcdcVSRRefineNetDataset", "kwargs": {
            "data_dir": str(tree["videos_dir"]), "downscale_factor": 4,
            "transforms": [norm, {"name": "ToTensor"}],
            "augments": [{"name": "RandomCropPatch", "kwargs": {"size": [4, 4], "ratio": 4}}],
            "num_frames": 3, "num_updated_frames": 2,
            "pos_code_path": str(tree["pos_code_path"])}},
        "dataloader": {"name": "Dataloader", "kwargs": {"train_batch_size": 1,
                                                         "valid_batch_size": 1,
                                                         "shuffle": True, "num_workers": 0}},
        "net": {"name": "RefineNet", "kwargs": NET},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [{"name": "PSNR"}],
        "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-3, "weight_decay": 0}},
        "monitor": {"name": "Monitor", "kwargs": {"mode": "min", "target": "Loss",
                                                  "saved_freq": 1, "early_stop": 0}},
        "trainer": {"name": "AcdcVSRRefineNetTrainer",
                    "kwargs": {"device": "cpu", "num_epochs": 1}},
        "parallel": parallel,
    })


def test_a_run_of_main_leaves_no_group_behind(tree, tmp_path):
    """``main``'s process group of one belongs to its run: after
    ``train_from_config`` returns, and after a run that raised, no group is
    left, and ``batch_infer --num-devices 2`` in the same process spawns its
    two ranks (a kept group made it run here and refuse the mesh)."""
    trainer = train_from_config(_train_cfg(tmp_path, {"num_devices": 1}))
    assert trainer.mesh.shape == {"data": 1} and np.isfinite(trainer.history["train"][0]["Loss"])
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="num_devices=8 but the process group has 1"):
        train_from_config(_train_cfg(tmp_path / "eight", {"num_devices": 8}))
    assert not torch.distributed.is_initialized()
    two = tool.main(_args(tree, tmp_path / "two.csv", "--device", "cpu", "--num-devices", "2"))
    assert two["devices"] == 2 and two["frames"] == 25
    assert not torch.distributed.is_initialized()


def test_tiled_rows_equal_the_jax_tool(tree, tmp_path):
    jax_tool.main(_args(tree, tmp_path / "jax.csv", "--tile", "4", "--tile-overlap", "1"))
    tool.main(_args(tree, tmp_path / "port.csv", "--tile", "4", "--tile-overlap", "1",
                    "--device", "cpu"))
    _assert_rows_close(_rows(tmp_path / "port.csv"), _rows(tmp_path / "jax.csv"))


def test_group_by_shape_equals_the_jax_tool(tree):
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.config import (
        DATASETS as JAX_DATASETS,
    )

    small, _ = tree
    kwargs = dict(data_dir=small["videos_dir"], type="test", downscale_factor=4,
                  transforms=[{"name": "ToTensor"}], pos_code_path=str(small["pos_code_path"]),
                  num_frames=7, num_updated_frames=2)
    got = tool.group_by_shape(datasets.VSRRefineNetDataset(**kwargs))
    want = jax_tool.group_by_shape(JAX_DATASETS.get("AcdcVSRRefineNetDataset")(**kwargs))
    assert dict(got) == dict(want) and len(got) == 2


@pytest.mark.parametrize("extra,error,match", [
    # one device cannot be 2 spatial ranks (the JAX mesh's refusal)
    (["--spatial-parallel", "2"], ValueError, "not divisible by spatial_parallel=2"),
    # the tile excludes the spatial strategies (--spatial-parallel with
    # --pad-h runs: tests/test_torch_spatial.py)
    (["--pad-h", "--tile", "8", "--tile-overlap", "2"], SystemExit, None),
    (["--tile", "8"], SystemExit, None),
    (["--tile", "8", "--tile-overlap", "4"], SystemExit, None),
])
def test_refusals(tree, tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        tool.main(_args(tree, tmp_path / "x.csv", "--device", "cpu", *extra))


def test_aot_cache_is_accepted_and_logged(tree, tmp_path, caplog):
    with caplog.at_level(logging.INFO):
        tool.main(_args(tree, tmp_path / "x.csv", "--device", "cpu", "--aot-cache",
                        str(tmp_path / "aot")))
    assert any("aot_cache" in r.message for r in caplog.records)
    assert not (tmp_path / "aot").exists()
