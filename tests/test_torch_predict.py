"""The PyTorch port's eval path end to end against the JAX package's.

One small RefineNet, initialised in JAX, is saved both ways the system
writes weights: as a reference ``{'net': state_dict}`` ``.pth``
(``utils/torch_export.save_torch_checkpoint``) and as the JAX package's
pickle checkpoint with optimizer and seed state
(``runner/checkpoint.save_checkpoint``).  The JAX predictor runs once; the
port's ``test_from_config`` runs from each file on the CPU.  The Test log
and ``results.csv`` must match at rtol/atol 2e-3 and the PNG/GIF pixels
within one gray level, as ``test_export_tree_parity.py`` holds the JAX
predictor against the reference.
"""
import csv
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import jax
import optax

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.config import (
    Cfg as JaxCfg,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.main import (
    test_from_config as run_jax_test,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.models import (
    RefineNet as JaxRefineNet,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.checkpoint import (
    save_checkpoint,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.seeding import (
    seed_everything,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.torch_export import (
    save_torch_checkpoint,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import Cfg
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
    test_from_config as run_port_test,
)
from fixtures import make_acdc_tree
from gray_frames import gif_frames, png_frame

REPO = Path(__file__).resolve().parent.parent
FRAMES, U = 6, 3
NET = {
    "name": "RefineNet",
    "kwargs": {
        "in_channels": 1, "out_channels": 1, "num_features": [8, 8], "num_stages": 2,
        "upscale_factor": 4, "update_memory": True, "num_updated_frames": U,
        "refine_window_size": 5, "positional_encoding": True,
    },
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_acdc_tree(tmp_path_factory.mktemp("acdc"), patients_per_split=1, slices=2,
                          frames=FRAMES, hr_size=(48, 48), splits=("test",))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    lr = np.zeros((1, FRAMES + 2 * U, 12, 12, 1), np.float32)
    pos = np.zeros((1, FRAMES + 2 * U, 1), np.float32)
    params = JaxRefineNet(**NET["kwargs"]).init(jax.random.PRNGKey(0), lr, pos)["params"]
    pth, pkl = root / "model.pth", root / "model_pickle.pth"
    save_torch_checkpoint(params, pth)
    save_checkpoint(pkl, params=params, opt_state=optax.adam(1e-3).init(params),
                    epoch=1, seed_state=seed_everything("vsr", 2))
    return {"pth": pth, "pickle": pkl}


def _cfg(tree, saved_dir, loaded_path):
    coords = str(tree["coordinates_path"])
    return {
        "main": {"saved_dir": str(saved_dir), "loaded_path": str(loaded_path)},
        "dataset": {
            "name": "AcdcVSRRefineNetDataset",
            "kwargs": {
                "data_dir": str(tree["videos_dir"]), "downscale_factor": 4,
                "transforms": [
                    {"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                    {"name": "ToTensor"},
                ],
                "num_frames": 5, "num_updated_frames": U,
                "pos_code_path": str(tree["pos_code_path"]),
            },
        },
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"batch_size": 1, "shuffle": False, "num_workers": 2}},
        "net": NET,
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [
            {"name": "PSNR"}, {"name": "SSIM"},
            {"name": "CardiacPSNR", "kwargs": {"coordinates_path": coords}},
            {"name": "CardiacSSIM", "kwargs": {"coordinates_path": coords}},
        ],
        "predictor": {"name": "AcdcVSRRefineNetPredictor",
                      "kwargs": {"device": "cpu", "saved_dir": str(saved_dir), "exported": True}},
    }


@pytest.fixture(scope="module")
def jax_run(tree, checkpoints, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    log = run_jax_test(JaxCfg(_cfg(tree, out, checkpoints["pickle"]))).log
    return out, log


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _files(root):
    return {str(p.relative_to(root)) for p in Path(root).rglob("*")
            if p.is_file() and p.name != "config.yaml"}


@pytest.mark.parametrize("kind", ["pth", "pickle"])
def test_predict_matches_jax(tree, checkpoints, jax_run, tmp_path, kind):
    jax_dir, jax_log = jax_run
    predictor = run_port_test(Cfg(_cfg(tree, tmp_path, checkpoints[kind])))
    assert predictor.log.keys() == jax_log.keys()
    for key in jax_log:
        np.testing.assert_allclose(predictor.log[key], jax_log[key], rtol=2e-3, atol=2e-3,
                                   err_msg=key)
    assert predictor.throughput["frames"] == 2 * FRAMES

    header_j, rows_j = _read_csv(jax_dir / "results.csv")
    header_p, rows_p = _read_csv(tmp_path / "results.csv")
    assert header_p == header_j
    assert [r[0] for r in rows_p] == [r[0] for r in rows_j]
    np.testing.assert_allclose(np.array([[float(x) for x in r[1:]] for r in rows_p]),
                               np.array([[float(x) for x in r[1:]] for r in rows_j]),
                               rtol=2e-3, atol=2e-3)

    files = _files(jax_dir)
    assert _files(tmp_path) == files
    assert sum(f.endswith(".png") for f in files) == 2 * FRAMES
    for rel in sorted(files):
        if rel.endswith(".png"):
            a = np.asarray(png_frame(jax_dir / rel), np.int16)
            b = np.asarray(png_frame(tmp_path / rel), np.int16)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, rel
        elif rel.endswith(".gif"):
            fa = [np.asarray(f, np.int16) for f in gif_frames(jax_dir / rel)]
            fb = [np.asarray(f, np.int16) for f in gif_frames(tmp_path / rel)]
            assert len(fa) == len(fb) == FRAMES, rel
            assert all(np.abs(a - b).max() <= 1 for a, b in zip(fa, fb)), rel


def test_pickle_checkpoint_loads_without_jax(checkpoints):
    """The JAX checkpoint also holds optax and JAX-package objects; reading
    its weights must import neither (a fresh interpreter checks)."""
    code = textwrap.dedent(f"""
        import sys
        from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import RefineNet
        from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.checkpoint import (
            load_net_state_dict,
        )
        sd = load_net_state_dict({str(checkpoints["pickle"])!r})
        RefineNet(**{NET["kwargs"]!r}).load_state_dict(sd, strict=True)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                     "efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu"))
        assert not bad, bad
        print("ok", len(sd))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
