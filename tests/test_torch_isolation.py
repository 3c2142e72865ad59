"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, and it runs on the card unless the config asks for the CPU."""
import ast
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch as port
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import Cfg
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
    resolve_device,
    test_from_config as run_port_test,
    train_from_config as run_port_train,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import (
    trainers,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.predictors import (
    DEFERRED_KNOBS,
    VSRRefineNetPredictor,
)

REPO = Path(__file__).resolve().parent.parent
PORT_DIR = Path(port.__file__).parent
JAX_PACKAGE = "efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", JAX_PACKAGE}


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PORT_DIR)], prefix=f"{port.__name__}.")
    )


def test_importing_every_port_module_loads_no_jax():
    modules = _port_modules()
    for name in ("runner.predictors", "runner.trainers", "runner.optim", "runner.monitor",
                 "runner.loggers", "runner.checkpoint", "tools.profile_train", "ops.tiling",
                 "utils.casting"):
        assert f"{port.__name__}.{name}" in modules
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {modules!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r})
        assert not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_of_the_port_imports_jax():
    sources = sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in sources:
        bad = set(_imported_roots(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"
        assert "import jax" not in path.read_text(), path


@pytest.mark.parametrize("device", [None, "cuda:0", "cuda"])
def test_cuda_without_a_card_raises(monkeypatch, tmp_path, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kwargs = {"saved_dir": str(tmp_path)} if device is None else {"device": device}
    cfg = Cfg({"main": {"saved_dir": str(tmp_path)},
               "predictor": {"name": "AcdcVSRRefineNetPredictor", "kwargs": kwargs}})
    with pytest.raises(RuntimeError, match="CUDA"):
        run_port_test(cfg)
    assert not (tmp_path / "config.yaml").exists()  # raised before any work


def test_resolve_device_cpu_and_unknown():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("knob,value", [("export_nifti", True), ("pad_h", True)])
def test_deferred_predictor_knobs_raise(knob, value):
    with pytest.raises(NotImplementedError, match=knob):
        VSRRefineNetPredictor(device="cpu", **{knob: value})


def test_deferred_knobs_at_their_defaults_and_telemetry_are_accepted():
    VSRRefineNetPredictor(device="cpu", telemetry=True, **DEFERRED_KNOBS)
    VSRRefineNetPredictor(device="cpu", t_bucket=None, telemetry=False)
    with pytest.raises(TypeError):
        VSRRefineNetPredictor(device="cpu", no_such_knob=1)


def test_parallel_section_raises(tmp_path):
    cfg = Cfg({"main": {"saved_dir": str(tmp_path)}, "parallel": {"num_devices": 2},
               "predictor": {"name": "AcdcVSRRefineNetPredictor", "kwargs": {"device": "cpu"}}})
    with pytest.raises(NotImplementedError, match="parallel"):
        run_port_test(cfg)


@pytest.mark.parametrize("device", [None, "cuda:0", "cuda"])
def test_training_on_cuda_without_a_card_raises(monkeypatch, tmp_path, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kwargs = {"num_epochs": 1} if device is None else {"device": device}
    cfg = Cfg({"main": {"saved_dir": str(tmp_path)}, "net": {"name": "RefineNet", "kwargs": {}},
               "trainer": {"name": "AcdcVSRRefineNetTrainer", "kwargs": kwargs}})
    with pytest.raises(RuntimeError, match="CUDA"):
        run_port_train(cfg)
    assert not (tmp_path / "config.yaml").exists()  # raised before any work


@pytest.mark.parametrize("knob,value", [("checkpoint_backend", "orbax"),
                                        ("telemetry_warn_frac", 0.1)])
def test_deferred_trainer_knobs_raise(knob, value):
    with pytest.raises(NotImplementedError, match=f"{knob}.*ROADMAP"):
        trainers.VSRRefineNetTrainer(device="cpu", **{knob: value})


def test_deferred_trainer_knobs_at_their_defaults_are_accepted():
    defaults = {k: default for k, (default, _) in trainers.DEFERRED_KNOBS.items()}
    trainers.VSRRefineNetTrainer(device="cpu", telemetry=False, **defaults)
    with pytest.raises(TypeError):
        trainers.VSRRefineNetTrainer(device="cpu", no_such_knob=1)


@pytest.mark.parametrize("section,match", [
    ({"parallel": {"num_devices": 2}}, "parallel"),
    ({"parallel": {"num_devices": 1, "spatial_parallel": 2}}, "parallel"),
])
def test_training_sections_not_ported_raise(tmp_path, section, match):
    cfg = Cfg({"main": {"saved_dir": str(tmp_path)}, "net": {"name": "RefineNet", "kwargs": {}},
               "trainer": {"name": "AcdcVSRRefineNetTrainer", "kwargs": {"device": "cpu"}},
               **section})
    with pytest.raises(NotImplementedError, match=match):
        run_port_train(cfg)


@pytest.mark.parametrize("knob,value", [("t_bucket", 8), ("compute_dtype", "bfloat16"),
                                        ("aot_cache", "cache"), ("seam_stats", False)])
def test_ported_predictor_knobs_are_accepted(knob, value):
    predictor = VSRRefineNetPredictor(device="cpu", **{knob: value})
    assert predictor.t_bucket == (8 if knob == "t_bucket" else 0)
    assert predictor.compute_dtype == (torch.bfloat16 if knob == "compute_dtype" else None)


@pytest.mark.parametrize("kwargs,match", [
    ({"tile": 16}, "tile_overlap"),
    ({"tile": 16, "tile_overlap": 8}, "exceed"),
    ({"tile": (16, 16, 16), "tile_overlap": 2}, "int or"),
    ({"tile": 16, "tile_overlap": 2, "parallel": {"num_devices": 1}}, "single-device"),
    ({"tile": 16, "tile_overlap": 2, "pad_h": True}, "replaces pad_h"),
    ({"seam_stats": "all"}, "seam_stats"),
])
def test_tile_knob_validation_errors(kwargs, match):
    """The JAX predictor's validation of ``tile`` (``runner/predictors.py:97-120``)."""
    with pytest.raises(ValueError, match=match):
        VSRRefineNetPredictor(device="cpu", **kwargs)


@pytest.mark.parametrize("knob,value", [("compute_dtype", "bfloat16"), ("grad_accum_steps", 2),
                                        ("aot_cache", "cache")])
def test_ported_trainer_knobs_are_accepted(knob, value):
    trainer = trainers.VSRRefineNetTrainer(device="cpu", **{knob: value})
    assert trainer.grad_accum_steps == (2 if knob == "grad_accum_steps" else 1)
    assert trainer.compute_dtype == (torch.bfloat16 if knob == "compute_dtype" else None)


@pytest.mark.parametrize("visible,parallel,error", [
    (1, {"num_devices": 1}, None),
    (1, {"num_devices": 8}, ValueError),
    (4, {"num_devices": 4}, NotImplementedError),
    (1, {"num_devices": 1, "model_parallel": 2}, NotImplementedError),
])
def test_parallel_section_on_cuda(monkeypatch, parallel, visible, error):
    """On the card: one device runs, more than are visible raise the JAX
    package's ``ValueError``, a mesh of several raises ``NotImplementedError``."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
        _check_parallel,
    )

    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    cfg = Cfg({"parallel": parallel})
    if error is None:
        assert _check_parallel(cfg, torch.device("cuda:0")) == parallel
    else:
        with pytest.raises(error, match="num_devices"):
            _check_parallel(cfg, torch.device("cuda:0"))
