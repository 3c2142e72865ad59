"""The port's serving daemon (``tools/serve.py``) against the JAX package's.

The same raw LR NIfTI trees and the same checkpoints go through both
packages' ``tools/serve.main`` on the CPU (``--device cpu``); the SR NIfTIs
must agree within 1 gray level with at least 99.9% of voxels equal, the
generated phase codes exactly.  The cases of ``tests/test_serve.py``:

* the workloads: a tiny RefineNet (sequence, phase codes generated), EDSR
  (frame), DUF (window, BatchNorm statistics) and EDVR (window, DCN).  The
  first three are JAX inits saved as JAX package pickles, carried into the
  port by ``utils/jax_weights``; EDVR is the port's seeded ``.pth``, which
  the JAX package reads as a reference checkpoint (its init is slow here);
* the knobs: ``--pos-code``, ``--t-bucket`` with ``--tile``,
  ``--out-dtype uint8``, a clip shorter than its margins;
* the daemon: the second run serves nothing and rewrites nothing, a bad
  volume is logged and skipped, the card is the default device.

Each tree is served by JAX once per module (module-scoped fixtures).
"""
import pickle
import shutil

import numpy as np
import pytest
import torch
import yaml

import jax

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import models as jax_models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner import (
    checkpoint as jax_ckpt,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.tools import (
    gen_synthetic_data,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.tools import (
    serve as jax_serve,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils import nifti
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import (
    serve as port_serve,
)

pytest.importorskip("cv2")  # the JAX package's phase-code tools

NETS = {
    "RefineNet": dict(in_channels=1, out_channels=1, num_features=[6, 6], upscale_factor=2,
                      num_stages=2, update_memory=True, num_updated_frames=2,
                      refine_window_size=5, positional_encoding=True),
    "EDSRNet": dict(in_channels=1, out_channels=1, num_resblocks=2, num_features=6,
                    upscale_factor=2),
    "DUFNet": dict(in_channels=1, out_channels=1, num_frames=7, size_filter=5, upscale_factor=2,
                   backbone="_DenseLayer16"),
    "EDVRNet": dict(in_channels=1, out_channels=1, nf=8, groups=2, front_RBs=1, back_RBs=1,
                    nframes=5),
}
# EDVR serves one volume: JAX compiles each input shape, ~20 s each here
GLOBS = {"EDVRNet": "patient001*.nii.gz"}
TOL_GRAY, MIN_EQUAL = 1, 0.999


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (test workers run side by
    side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_checkpoint(name, kw, path):
    if name == "RefineNet":
        variables = jax_models.RefineNet(**kw).init(
            jax.random.PRNGKey(0), np.zeros((1, 12, 12, 12, 1), np.float32),
            np.zeros((1, 12, 1), np.float32))
    elif name == "EDSRNet":
        variables = jax_models.EDSRNet(**kw).init(jax.random.PRNGKey(1),
                                                  np.zeros((1, 12, 12, 1), np.float32))
    else:
        variables = jax_models.DUFNet(**kw).init(
            jax.random.PRNGKey(2), np.zeros((1, 7, 12, 12, 1), np.float32), train=False)
    state = {"batch_stats": variables["batch_stats"]} if "batch_stats" in variables else None
    jax_ckpt.save_checkpoint(path, params=variables["params"], model_state=state)


def _edvr_pth(kw, path):
    net = models.EDVRNet(**kw, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for pname, p in net.named_parameters():
            if "conv_offset_mask" in pname:  # fractional offsets
                p.normal_(0.0, 0.05, generator=gen)
    torch.save({"net": net.state_dict()}, path)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Raw LR volumes as ``tests/test_serve.py`` writes them, plus one slice
    of the JAX package's phantom (a heart that moves: the phase-code
    generator finds a real bbox and end-systole on it), and a config with
    a checkpoint per net."""
    root = tmp_path_factory.mktemp("serve_port")
    rng = np.random.default_rng(0)
    vols = {
        "patient001_2d+1d_sequence.nii.gz": rng.uniform(0, 255, (12, 12, 1, 8)),
        "deep/patient002_2d+1d_sequence.nii.gz": rng.uniform(0, 255, (16, 16, 2, 6)),
        "patient003_2d+1d_sequence.nii.gz": gen_synthetic_data.phantom_volume(
            np.random.default_rng(5), size=48, slices=1, frames=10)[::2, ::2] / 4.0,
    }
    vols = {rel: np.asarray(v, np.float32) for rel, v in vols.items()}
    for rel, vol in vols.items():
        nifti.save(vol, root / "lr" / rel)
    cfgs = {}
    for name, kw in NETS.items():
        ckpt = root / f"{name}.pth"
        if name == "EDVRNet":
            _edvr_pth(kw, ckpt)
        else:
            _jax_checkpoint(name, kw, ckpt)
        cfgs[name] = root / f"{name}.yaml"
        cfgs[name].write_text(yaml.safe_dump({"net": {"name": name, "kwargs": kw},
                                              "main": {"loaded_path": str(ckpt)}}))
    return {"root": root, "in": root / "lr", "vols": vols, "cfgs": cfgs, "runs": {}}


def _serve_both(tree, name, extra=(), key=None, in_dir=None):
    """Both daemons once per (net, knobs) → (JAX count, port count, JAX out,
    port out)."""
    key = key or name
    if key not in tree["runs"]:
        in_dir = in_dir or tree["in"]
        extra = list(extra) + (["--glob", GLOBS[name]] if name in GLOBS else [])
        outs = tree["root"] / f"jax_{key}", tree["root"] / f"port_{key}"
        counts = [pkg.main([str(tree["cfgs"][name]), "--in", str(in_dir), "--out", str(out),
                            "--device", "cpu", *extra])
                  for pkg, out in zip((jax_serve, port_serve), outs)]
        tree["runs"][key] = (*counts, *outs)
    return tree["runs"][key]


def _assert_close(jax_out, port_out, want_dtype=np.float32):
    files = sorted(p.relative_to(jax_out) for p in jax_out.rglob("*.nii*"))
    assert files and files == sorted(p.relative_to(port_out) for p in port_out.rglob("*.nii*"))
    for rel in files:
        a, b = nifti.load(jax_out / rel).data, nifti.load(port_out / rel).data
        assert a.shape == b.shape and b.dtype == a.dtype == want_dtype, rel
        diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
        assert diff.max() <= TOL_GRAY, (rel, diff.max())
        assert (diff == 0).mean() >= MIN_EQUAL, (rel, (diff == 0).mean())
    return files


@pytest.mark.parametrize("name", list(NETS))
def test_port_serves_as_jax(tree, name):
    n_jax, n_port, jax_out, port_out = _serve_both(tree, name)
    want = 1 if name in GLOBS else len(tree["vols"])
    assert n_port == n_jax == want
    r = NETS[name].get("upscale_factor", 4)  # EDVR is x4 by construction
    for rel in _assert_close(jax_out, port_out):
        H, W, S, T = tree["vols"][str(rel)].shape
        assert nifti.load(port_out / rel).data.shape == (r * H, r * W, S, T)


def test_generated_phase_codes_equal_jax(tree):
    for rel, vol in tree["vols"].items():
        for s in range(vol.shape[2]):
            raw = vol[:, :, s:s + 1, :]
            got, want = port_serve.generate_phase_code(raw), jax_serve.generate_phase_code(raw)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=rel)
    # the phantom's heart moves: its code has an end-systole anchor, not the
    # neutral fallback
    phantom = tree["vols"]["patient003_2d+1d_sequence.nii.gz"]
    code = port_serve.generate_phase_code(phantom)
    assert not np.array_equal(code, port_serve.neutral_phase_code(phantom.shape[-1]))


@pytest.mark.parametrize("knob", ["pos_code", "t_bucket_tile", "out_dtype_uint8", "short_clip"])
def test_knobs_serve_as_jax(tree, knob, tmp_path_factory):
    in_dir, extra, dtype = None, [], np.float32
    if knob == "pos_code":
        code = port_serve.generate_phase_code(
            tree["vols"]["patient001_2d+1d_sequence.nii.gz"])
        pkl = tree["root"] / "position_code.pkl"
        with open(pkl, "wb") as f:  # patient003 is not in it: generated
            pickle.dump({"patient001": np.roll(code, 3), "patient002": code[:6]}, f)
        extra = ["--pos-code", str(pkl)]
    elif knob == "t_bucket_tile":
        extra = ["--t-bucket", "4", "--tile", "8", "--tile-overlap", "2"]
    elif knob == "out_dtype_uint8":
        extra, dtype = ["--out-dtype", "uint8"], np.uint8
    else:
        in_dir = tmp_path_factory.mktemp("short_lr")
        vol = np.random.default_rng(3).uniform(0, 255, (12, 12, 1, 5)).astype(np.float32)
        nifti.save(vol, in_dir / "patient009_2d+1d_sequence.nii.gz")  # U=2 < T=5
        nifti.save(vol[..., :1], in_dir / "patient010_2d+1d_sequence.nii.gz")  # U > T=1
    n_jax, n_port, jax_out, port_out = _serve_both(tree, "RefineNet", extra, key=knob,
                                                   in_dir=in_dir)
    assert n_port == n_jax
    files = _assert_close(jax_out, port_out, dtype)
    if knob == "short_clip":
        shapes = [nifti.load(port_out / rel).data.shape for rel in files]
        assert shapes == [(24, 24, 1, 5), (24, 24, 1, 1)]
    if knob == "pos_code":  # the pickle changed the phase-aware output
        base = _serve_both(tree, "RefineNet")[3]
        rel = "patient001_2d+1d_sequence.nii.gz"
        assert not np.array_equal(nifti.load(base / rel).data, nifti.load(port_out / rel).data)
    if knob == "out_dtype_uint8":
        base = _serve_both(tree, "RefineNet")[3]
        for rel in files:
            np.testing.assert_array_equal(nifti.load(base / rel).data,
                                          nifti.load(port_out / rel).data.astype(np.float32))


def test_second_run_serves_nothing(tree):
    out = _serve_both(tree, "RefineNet")[3]
    before = sorted(p for p in out.rglob("*") if p.is_file())
    mtimes = [p.stat().st_mtime_ns for p in before]
    argv = [str(tree["cfgs"]["RefineNet"]), "--in", str(tree["in"]), "--out", str(out),
            "--device", "cpu"]
    assert port_serve.main(argv) == 0
    after = sorted(p for p in out.rglob("*") if p.is_file())
    assert after == before and [p.stat().st_mtime_ns for p in after] == mtimes


def test_bad_volume_is_logged_and_skipped(tree, tmp_path, caplog):
    in_dir, out_dir = tmp_path / "lr", tmp_path / "sr"
    in_dir.mkdir()
    (in_dir / "broken.nii.gz").write_bytes(b"not a nifti")
    shutil.copy(tree["in"] / "patient001_2d+1d_sequence.nii.gz", in_dir)
    argv = [str(tree["cfgs"]["EDSRNet"]), "--in", str(in_dir), "--out", str(out_dir),
            "--device", "cpu"]
    assert port_serve.main(argv) == 1
    assert (out_dir / "patient001_2d+1d_sequence.nii.gz").exists()
    assert not (out_dir / "broken.nii.gz").exists()
    assert any("broken.nii.gz" in r.getMessage() and r.levelname == "ERROR"
               for r in caplog.records)


def test_the_card_is_the_default_device(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(tree["cfgs"]["EDSRNet"]), "--in", str(tree["in"]), "--out", str(tmp_path)]
    assert port_serve._parse_args(argv).device == "cuda:0"
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.main(argv)
    assert not any(tmp_path.iterdir())
