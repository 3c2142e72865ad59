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
    VSRRefineNetPredictor,
)

REPO = Path(__file__).resolve().parent.parent
PORT_DIR = Path(port.__file__).parent
JAX_PACKAGE = "efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu"
# the tests' DCN oracle too: the port keeps its own plain versions
# cv2, imageio: the card's machine has neither; the port's phase-code tools
# are numpy, its GIF and PNG exports ``utils/imgio.py``
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", JAX_PACKAGE, "dcn_oracle", "cv2", "imageio"}


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PORT_DIR)], prefix=f"{port.__name__}.")
    )


def test_importing_every_port_module_loads_no_jax():
    modules = _port_modules()
    for name in ("runner.predictors", "runner.trainers", "runner.optim", "runner.monitor",
                 "runner.loggers", "runner.checkpoint", "tools.profile_train", "ops.tiling",
                 "utils.casting", "parallel.mesh", "parallel.distributed", "tools.batch_infer",
                 "utils.imgio", "ops.kspace", "tools.acdc_preprocess", "tools.dsb15_preprocess",
                 "tools.dsb15_dicom2nifty", "tools.gen_synthetic_data", "tools.convergence"):
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
def test_deferred_predictor_knobs_raise(knob, value, tmp_path):
    """No predictor knob is deferred any more: ``export_nifti`` and
    ``pad_h`` (item 10b) are accepted and set."""
    kwargs = {knob: value, "saved_dir": str(tmp_path)}
    assert getattr(VSRRefineNetPredictor(device="cpu", **kwargs), knob) is True


def test_deferred_knobs_at_their_defaults_and_telemetry_are_accepted():
    assert VSRRefineNetPredictor(device="cpu", telemetry=True, pad_h=False).pad_h is False
    VSRRefineNetPredictor(device="cpu", t_bucket=None, telemetry=False)
    with pytest.raises(TypeError):
        VSRRefineNetPredictor(device="cpu", no_such_knob=1)


def test_parallel_section_raises(tmp_path):
    """A mesh of several devices runs (``tests/test_torch_parallel*.py``),
    the spatial axis for every net of the zoo too, the warping and
    deformable nets among them (``tests/test_torch_spatial*.py``); the
    spatial axis with the model axis raises the JAX package's
    ``ValueError`` before any work."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
        _check_parallel,
    )

    section = {"num_devices": 4, "spatial_parallel": 2, "model_parallel": 2}
    cfg = Cfg({"main": {"saved_dir": str(tmp_path)}, "parallel": section,
               "net": {"name": "TOFlowNet", "kwargs": {}},
               "predictor": {"name": "AcdcMISRPredictor", "kwargs": {"device": "cpu"}}})
    with pytest.raises(ValueError, match="cannot be combined"):
        run_port_test(cfg)
    assert not (tmp_path / "config.yaml").exists()  # raised before any work
    section = {"num_devices": 2, "spatial_parallel": 2}
    cfg["parallel"] = section
    assert _check_parallel(cfg, torch.device("cpu")) == section
    cfg["net"] = {"name": "EDSRNet", "kwargs": {}}
    assert _check_parallel(cfg, torch.device("cpu")) == section


@pytest.mark.parametrize("device", [None, "cuda:0", "cuda"])
def test_training_on_cuda_without_a_card_raises(monkeypatch, tmp_path, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kwargs = {"num_epochs": 1} if device is None else {"device": device}
    cfg = Cfg({"main": {"saved_dir": str(tmp_path)}, "net": {"name": "RefineNet", "kwargs": {}},
               "trainer": {"name": "AcdcVSRRefineNetTrainer", "kwargs": kwargs}})
    with pytest.raises(RuntimeError, match="CUDA"):
        run_port_train(cfg)
    assert not (tmp_path / "config.yaml").exists()  # raised before any work


@pytest.mark.parametrize("knob,value", [("checkpoint_backend", "orbax")])
def test_deferred_trainer_knobs_raise(knob, value):
    """The trainer's last deferred knob is ported: ``orbax`` is accepted
    (``tests/test_torch_parallel.py`` round-trips it); an unknown value
    raises."""
    assert getattr(trainers.VSRRefineNetTrainer(device="cpu", **{knob: value}), knob) == value
    with pytest.raises(ValueError, match=knob):
        trainers.VSRRefineNetTrainer(device="cpu", **{knob: "zarr"})


@pytest.mark.parametrize("engine", [trainers.VSRRefineNetTrainer, VSRRefineNetPredictor])
def test_telemetry_warn_frac_is_ported(engine):
    """The knob sets the threshold above which an out-of-window fraction
    warns (tests/test_torch_telemetry.py drives it through both engines)."""
    assert engine(device="cpu", telemetry_warn_frac=0.1).telemetry_warn_frac == 0.1
    assert engine(device="cpu").telemetry_warn_frac == 0.0


def test_deferred_trainer_knobs_at_their_defaults_are_accepted():
    trainers.VSRRefineNetTrainer(device="cpu", telemetry=False, checkpoint_backend="pickle",
                                 mesh=None)
    with pytest.raises(TypeError):
        trainers.VSRRefineNetTrainer(device="cpu", no_such_knob=1)


@pytest.mark.parametrize("section,match", [
    # accepted: the trainer has no pad_h (the JAX package's neither)
    ({"parallel": {"num_devices": 2, "pad_h": True}}, None),
    # one device cannot be 2 spatial ranks (the JAX mesh's refusal)
    ({"parallel": {"num_devices": 1, "spatial_parallel": 2}},
     "not divisible by spatial_parallel=2"),
])
def test_training_sections_not_ported_raise(tmp_path, section, match):
    """Both sections are ported (item 10b); what one process cannot be
    still raises before any work."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
        _check_parallel,
    )

    cfg = Cfg({"main": {"saved_dir": str(tmp_path)}, "net": {"name": "RefineNet", "kwargs": {}},
               "trainer": {"name": "AcdcVSRRefineNetTrainer", "kwargs": {"device": "cpu"}},
               **section})
    if match is None:
        assert _check_parallel(cfg, torch.device("cpu")) == section["parallel"]
    else:
        with pytest.raises(ValueError, match=match):
            run_port_train(cfg)
        assert not (tmp_path / "config.yaml").exists()


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
    (4, {"num_devices": 4}, None),
    (4, {"num_devices": 4, "spatial_parallel": 2}, NotImplementedError),
])
def test_parallel_section_on_cuda(monkeypatch, parallel, visible, error):
    """On the card: as many devices as are visible run (``main.run`` spawns
    a rank each), more raise the JAX package's ``ValueError``.  The case
    marked ``NotImplementedError`` is the spatial axis of EDVRNet, refused
    until the warping and deformable nets' axis was ported: it now runs, as
    RefineNet's and DUFNet's do, and what stays refused is the spatial axis
    with the model axis (``ValueError``)."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
        _check_parallel,
    )

    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    cfg = Cfg({"parallel": parallel, "net": {"name": "EDVRNet"}})
    if error is ValueError:
        with pytest.raises(error, match="num_devices"):
            _check_parallel(cfg, torch.device("cuda:0"))
    else:
        assert _check_parallel(cfg, torch.device("cuda:0")) == parallel
    if error is NotImplementedError:
        for net in ("RefineNet", "DUFNet", "TOFlowNet", "FRVSRNet"):
            cfg = Cfg({"parallel": parallel, "net": {"name": net}})
            assert _check_parallel(cfg, torch.device("cuda:0")) == parallel
        cfg = Cfg({"parallel": {**parallel, "model_parallel": 2}, "net": {"name": "EDVRNet"}})
        with pytest.raises(ValueError, match="cannot be combined"):
            _check_parallel(cfg, torch.device("cuda:0"))
