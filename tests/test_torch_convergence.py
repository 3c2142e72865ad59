"""The port's ``tools/convergence.py`` on the CPU: trained from scratch, a
net beats Bicubic on the held-out split of the phantom.

The CPU twin of the card's flagship run, as ``tests/test_convergence.py``
is for the JAX package: ``configs/train/edsr_net/exp1_x4.yaml`` as shipped,
with the tool's two small-run substitutions (EDSR shrunk to 2 blocks of 16
features, learning rate 1e-3, as the JAX test trains its net) on the
tool's 144-px phantom (4 + 2 patients, 2 slices, 16 frames: the 32×32 LR
crop of the YAML needs ≥ 132 px) for 14 epochs; then the test YAMLs of
EDSR and Bicubic, export on.  Measured on this seed: +2.17 dB PSNR and
+0.037 SSIM over Bicubic's 26.1204 dB, the value the JAX tool measured
for Bicubic on the same phantom (``CONVERGENCE_r05.json``).  About 37 s in
one process at two threads.
"""
import ast
import json
from pathlib import Path

import pytest
import torch

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import (
    convergence,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils import imgio

REPO = Path(__file__).resolve().parent.parent
JAX_TOOL = (REPO / "efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu"
            / "tools" / "convergence_tpu.py")
EPOCHS = 14


def _jax_json_keys() -> list:
    """The keys of the JSON line that the JAX tool prints (its last
    ``json.dumps({...})``), read from its source: the tool itself needs a
    reference checkout to run."""
    dumps = [node for node in ast.walk(ast.parse(JAX_TOOL.read_text()))
             if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"]
    return [k.value for k in dumps[-1].args[0].keys]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # test workers run side by side
    work = tmp_path_factory.mktemp("convergence")
    try:
        out = convergence.main(["edsr_net/exp1_x4", "--epochs", str(EPOCHS), "--workdir", str(work),
                                "--device", "cpu", "--lr", "1e-3",
                                "--net-kwargs", json.dumps({"num_resblocks": 2, "num_features": 16})])
    finally:
        torch.set_num_threads(n)
    return out, work


def test_trained_edsr_beats_bicubic(run):
    out, _ = run
    trained, bicubic = out["trained"], out["bicubic"]
    # the phantom, its preprocessing and Bicubic are the JAX package's: its
    # tool measured 26.1204 dB on the same tree (CONVERGENCE_r05.json)
    assert bicubic["PSNR"] == pytest.approx(26.1204, abs=2e-4), bicubic
    assert trained["PSNR"] > bicubic["PSNR"] + 0.5, out
    assert trained["SSIM"] > bicubic["SSIM"] + 0.02, out
    assert out["delta_psnr_db"] == round(trained["PSNR"] - bicubic["PSNR"], 3)
    assert len(out["train_losses"]) == len(out["valid_losses"]) == EPOCHS
    assert out["valid_losses"][-1] < out["valid_losses"][0]


def test_json_line_has_the_jax_tools_keys(run):
    out, _ = run
    keys = _jax_json_keys()
    assert "delta_psnr_db" in keys and list(out) == keys


def test_exports_are_on_as_shipped(run):
    """The shipped test YAMLs export: CSV rows per frame, a GIF per
    sequence (one image block a frame) and a PNG per frame, for both
    evaluations, on the 2 test patients × 2 slices × 16 frames."""
    _, work = run
    for name in ("trained", "bicubic"):
        root = work / f"test_edsr_net_exp1_x4_{name}"
        rows = (root / "results.csv").read_text().strip().splitlines()
        assert len(rows) == 1 + 2 * 2 * 16
        gifs = sorted((root / "videos").rglob("*.gif"))
        assert len(gifs) == 4 and all(imgio.gif_frame_count(g) == 16 for g in gifs)
        pngs = sorted((root / "imgs").rglob("*.png"))
        assert len(pngs) == 64 and all(p.read_bytes()[:4] == b"\x89PNG" for p in pngs)


def test_phantom_is_reused(run):
    _, work = run
    tree = convergence.phantom_tree(work, 144)
    assert tree["pos_code_path"].exists() and tree["imgs_dir"] == work / "phantom" / "preprocessed" / "imgs"
