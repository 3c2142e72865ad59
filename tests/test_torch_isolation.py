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
                 "runner.loggers", "runner.checkpoint", "tools.profile_train"):
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


@pytest.mark.parametrize("knob,value", [("t_bucket", 8), ("tile", 16), ("compute_dtype", "bfloat16"),
                                        ("export_nifti", True), ("pad_h", True)])
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


@pytest.mark.parametrize("knob,value", [("compute_dtype", "bfloat16"), ("grad_accum_steps", 2),
                                        ("aot_cache", "cache"), ("int_feed", True),
                                        ("checkpoint_backend", "orbax"),
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
    ({"net": {"name": "RefineNet", "kwargs": {"remat": True}}}, "remat"),
])
def test_training_sections_not_ported_raise(tmp_path, section, match):
    cfg = Cfg({"main": {"saved_dir": str(tmp_path)}, "net": {"name": "RefineNet", "kwargs": {}},
               "trainer": {"name": "AcdcVSRRefineNetTrainer", "kwargs": {"device": "cpu"}},
               **section})
    with pytest.raises(NotImplementedError, match=match):
        run_port_train(cfg)
