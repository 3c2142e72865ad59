"""The port's ``tools/convergence.py`` for the six other families on the CPU.

The CPU twin of ``chip_smoke.py --convergence TRAIN_YAML``: each family's
shipped train YAML (``edsr_net``, ``toflow_net``, ``rbp_net``,
``edvr_net``, ``duf_net``, ``frvsr_net``; ``--grad-accum 2`` for RBPN and
EDVR, as the JAX package's sweep trained them) through the tool for 2
epochs on one shared 144-px phantom (4 + 2 patients, 2 slices, 16
frames), with the widths shrunk by ``--net-kwargs``, or, where the kwargs
hold no width (TOFlow, DUF, FRVSR's SRNet and FNet), by the modules' width
constants; then the test YAMLs of the family and of Bicubic, export on.  Each case holds the tool's JSON line to
the JAX tool's keys, the test config it built to the JAX tool's rule (the
family's test YAML with the train YAML's net kwargs overlaid, its test-only
keys kept), Bicubic to the JAX package's reading of the phantom, and the
exports to what phase 32 checks.  Trained PSNR is not held here: two
epochs at these widths learn little; the card's 40-epoch runs are held to
the JAX package's sweep.  About 3 minutes in one process at two threads,
TOFlow, RBPN and EDVR ~40 s each: their steps' conv weight gradients at
HR 128 take 1.7-2.8 s on the CPU whatever the width.
"""
import json
import math
import sys
from pathlib import Path

import pytest
import torch

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import main as port_main
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import load_config
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
    duf_net,
    frvsr_net,
    toflow_net,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import (
    convergence,
)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke  # noqa: E402
from test_torch_convergence import _jax_json_keys  # noqa: E402

EPOCHS = 2
# train YAML -> (net kwargs overlaid, grad_accum_steps)
FAMILIES = {
    "edsr_net/exp1_x4": ({"num_resblocks": 1, "num_features": 8}, None),
    "toflow_net/exp1_x4": ({}, None),
    "rbp_net/exp1_x4": ({"base_filter": 4, "feat": 4, "num_stages": 3, "num_resblocks": 1}, 2),
    "edvr_net/exp1_x4": ({"nf": 4, "groups": 1, "front_RBs": 1, "back_RBs": 1}, 2),
    "duf_net/exp1_x4": ({"size_filter": 3}, None),
    "frvsr_net/exp1_x4": ({"num_resblocks": 1}, None),
}
# TOFlow, DUF and FRVSR's SRNet and FNet have no width among their kwargs:
# their modules' width constants are narrowed for the run
WIDTHS = {
    "toflow_net/exp1_x4": (toflow_net, {"_SPYNET_WIDTHS": (2, 2, 2, 2), "_FUSION_FEATURES": 2}),
    "duf_net/exp1_x4": (duf_net, {"_HEAD_FEATURES": 8,
                                  "_BACKBONES": {"_DenseLayer16": (4, 3, 3, 8 + 6 * 4)}}),
    "frvsr_net/exp1_x4": (frvsr_net, {"_SRNET_FEATURES": 4, "_FNET_FEATURES": 4}),
}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """One phantom for every family (the tool reuses the tree it finds)."""
    work = tmp_path_factory.mktemp("convergence_zoo")
    convergence.phantom_tree(work, 144)
    return work


@pytest.fixture(scope="module", params=list(FAMILIES))
def run(request, work):
    """The tool's run of one family: its JSON line, the test configs it
    built (trained, bicubic) and the phantom's directory."""
    train_yaml = request.param
    net_kwargs, accum = FAMILIES[train_yaml]
    argv = [train_yaml, "--epochs", str(EPOCHS), "--workdir", str(work), "--device", "cpu"]
    if net_kwargs:
        argv += ["--net-kwargs", json.dumps(net_kwargs)]
    if accum:
        argv += ["--grad-accum", str(accum)]
    built = {}
    test_from_config = port_main.test_from_config

    def recorded(cfg):
        built["bicubic" if cfg.net.name == "Bicubic" else "trained"] = cfg.copy()
        return test_from_config(cfg)

    n = torch.get_num_threads()
    torch.set_num_threads(2)  # test workers run side by side
    try:
        with pytest.MonkeyPatch.context() as m:
            m.setattr(port_main, "test_from_config", recorded)
            module, widths = WIDTHS.get(train_yaml, (None, {}))
            for name, value in widths.items():
                m.setattr(module, name, value)
            out = convergence.main(argv)
    finally:
        torch.set_num_threads(n)
    return train_yaml, out, built, work


def test_json_line_has_the_jax_tools_keys(run):
    _, out, _, _ = run
    assert list(out) == _jax_json_keys()


def test_losses_are_finite_one_an_epoch(run):
    _, out, _, _ = run
    assert len(out["train_losses"]) == len(out["valid_losses"]) == out["epochs"] == EPOCHS
    values = out["train_losses"] + out["valid_losses"] + [
        v for name in ("trained", "bicubic") for v in out[name].values()]
    assert all(math.isfinite(v) for v in values), out


def test_bicubic_reads_the_jax_packages_value(run):
    # both packages build the same phantom (CONVERGENCE_r05.json: 26.1204 dB)
    _, out, _, _ = run
    assert out["bicubic"]["PSNR"] == pytest.approx(chip_smoke.CONV_BICUBIC_PSNR,
                                                   abs=chip_smoke.CONV_BICUBIC_TOL)
    assert out["delta_psnr_db"] == round(out["trained"]["PSNR"] - out["bicubic"]["PSNR"], 3)


def test_grad_accum_steps_echoes_the_argument(run):
    train_yaml, out, _, _ = run
    assert out["grad_accum_steps"] == FAMILIES[train_yaml][1]
    assert out["grad_accum_steps"] == chip_smoke.CONV_GRAD_ACCUM.get(train_yaml)


def test_trained_net_is_the_test_yaml_with_the_train_yamls_net(run):
    """The JAX tool's rule (its ``tools/convergence_tpu.py``): the family's
    test YAML, the train YAML's net name and kwargs overlaid, the test-only
    keys kept (FRVSR's ``is_prediction``); Bicubic's test YAML as shipped."""
    train_yaml, _, built, _ = run
    configs = REPO / "configs"
    train_net = load_config(configs / "train" / f"{train_yaml}.yaml").net
    test = load_config(configs / "test" / f"{train_yaml}.yaml")
    want = {**test.net.kwargs.to_dict(), **train_net.kwargs.to_dict(), **FAMILIES[train_yaml][0]}
    got = built["trained"]
    assert got.net.name == train_net.name
    assert got.net.kwargs.to_dict() == want
    for section in ("dataset", "predictor"):
        assert got[section].name == test[section].name
    for section in ("losses", "metrics"):
        assert [c.name for c in got[section]] == [c.name for c in test[section]]
    assert got.main.loaded_path.endswith("model_best.pth")
    if train_yaml == "frvsr_net/exp1_x4":
        assert got.net.kwargs.is_prediction is True
    bicubic = load_config(configs / "test" / "bicubic" / "exp1_x4.yaml")
    assert built["bicubic"].net.to_dict() == bicubic.net.to_dict()


def test_exports_are_what_phase_32_checks(run):
    """CSV rows, a GIF a sequence of one image block a frame, a PNG a
    frame: 65 CSV lines, 4 GIFs of 16 frames and 64 PNGs on the 2 test
    patients x 2 slices x 16 frames, for both evaluations."""
    train_yaml, _, _, work = run
    family = train_yaml.replace("/", "_")
    for name in ("trained", "bicubic"):
        root = work / f"test_{family}_{name}"
        assert chip_smoke._check_exports(root, 4, 16) == {
            "rows": 64, "gifs": 4, "gif_frames": [16], "pngs": 64}
        assert len((root / "results.csv").read_text().strip().splitlines()) == 65
