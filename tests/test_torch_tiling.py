"""The port's tiled serving against the JAX package's, on the CPU.

``ops/tiling.py`` is the port's copy of the JAX package's window plan and
stitch: the plan must be the same list of windows, the probes must visit the
same windows in the same order, and a tiled RefineNet must give the JAX
package's tiled output and seam statistics on the same weights.  Tolerances:
plans and probe windows exactly equal; the tiled forward at
``test_torch_refine_net.py``'s atol 5e-5 / rtol 1e-4; the seam statistics,
differences of two such forwards, at atol 1e-4; the tiled predictor's Test
log at ``test_torch_predict.py``'s rtol/atol 2e-3 and its run-maximum seam in
gray levels at atol 5e-3.
"""
import logging

import numpy as np
import pytest
import torch
from torch.nn import functional as F

import jax
import jax.numpy as jnp

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.config import (
    Cfg as JaxCfg,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.main import (
    test_from_config as run_jax_test,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.models import (
    RefineNet as JaxRefineNet,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.ops import (
    tiling as jax_tiling,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.torch_export import (
    save_torch_checkpoint,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import Cfg
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
    test_from_config as run_port_test,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
    RefineNet,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
    lstm_gates,
    tiling,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)
from fixtures import make_acdc_tree

FRAMES, U, SCALE = 4, 2, 4
NET = dict(in_channels=1, out_channels=1, num_features=[4, 4], num_stages=2,
           refine_window_size=5, upscale_factor=SCALE, update_memory=True,
           num_updated_frames=U, positional_encoding=True)
SIZES = (8, 9, 12, 16, 17, 23, 24, 31, 40, 64, 80, 96, 97, 130, 257)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: test workers that run
    side by side then do not stall on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("tile,overlap", [(8, 0), (8, 2), (8, 3), (16, 4), (24, 11), (64, 12)])
def test_plan_1d_equals_jax(tile, overlap):
    for size in SIZES:
        if size < tile:
            with pytest.raises(ValueError, match="smaller than tile"):
                tiling.plan_1d(size, tile, overlap)
            with pytest.raises(ValueError, match="smaller than tile"):
                jax_tiling.plan_1d(size, tile, overlap)
            continue
        got = tiling.plan_1d(size, tile, overlap)
        assert got == jax_tiling.plan_1d(size, tile, overlap), size
        assert got[0][1] == 0 and got[-1][2] == size  # the spans partition [0, size)


@pytest.mark.parametrize("tile,overlap", [(8, 4), (8, 5), (8, -1)])
def test_plan_1d_rejects_what_jax_rejects(tile, overlap):
    with pytest.raises(ValueError):
        jax_tiling.plan_1d(20, tile, overlap)
    with pytest.raises(ValueError):
        tiling.plan_1d(20, tile, overlap)


def _position_inputs(h, w):
    """(1, 2, h, w, 1) frames whose value encodes the pixel position, and a
    pass-through (1, 2, 1) code."""
    pos = (np.arange(h)[:, None] * 1000 + np.arange(w)[None, :]).astype(np.float32)
    x = np.broadcast_to(pos[None, None, :, :, None], (1, 2, h, w, 1)).copy()
    return x, np.ones((1, 2, 1), np.float32)


@pytest.mark.parametrize("hw,tile,overlap", [((20, 14), (8, 8), 2), ((33, 17), (12, 8), 3),
                                             ((6, 10), (8, 8), 2), ((96, 80), (64, 64), 12)])
def test_windows_and_seam_probes_equal_jax(hw, tile, overlap):
    """Both run the same windows, main plan then probes, in the same order,
    and stitch a nearest-neighbour ×2 upscale of the frame back exactly."""
    x, code = _position_inputs(*hw)
    calls = {"port": [], "jax": []}

    def upscale(record):
        def fn(frames, c):
            assert c.shape == (1, 2, 1)  # rank-3 inputs pass through whole
            a = np.asarray(frames)
            record.append((a.shape, float(a[0, 0, 0, 0, 0])))
            return np.repeat(np.repeat(a, 2, axis=2), 2, axis=3)
        return fn

    want, want_seam = jax_tiling.tiled_apply(upscale(calls["jax"]), (x, code), tile, overlap,
                                             seam_stats=True)
    port_fn = upscale(calls["port"])
    got, seam = tiling.tiled_apply(lambda f, c: torch.from_numpy(port_fn(f.numpy(), c.numpy())),
                                   (torch.from_numpy(x), torch.from_numpy(code)), tile, overlap,
                                   seam_stats=True)
    assert calls["port"] == calls["jax"]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.repeat(np.repeat(x, 2, axis=2), 2, axis=3))
    assert seam == want_seam  # the identity has no seams: zeros, or None for one window


def test_tiled_apply_exact_when_the_overlap_covers_the_receptive_field():
    """Two 3×3 convs and a ×2 pixel shuffle: radius 2, so overlap 2 gives
    the untiled output (a frame smaller than the tile is edge-padded, which
    only approximates its border)."""
    gen = torch.Generator().manual_seed(0)
    w1, w2 = torch.randn(4, 1, 3, 3, generator=gen), torch.randn(4, 4, 3, 3, generator=gen)

    def net(x):  # (B, H, W, 1) → (B, 2H, 2W, 1)
        y = F.conv2d(torch.relu(F.conv2d(x.permute(0, 3, 1, 2), w1, padding=1)), w2, padding=1)
        return F.pixel_shuffle(y, 2).permute(0, 2, 3, 1)

    for h, w in ((21, 13), (9, 16), (8, 30)):
        x = torch.randn(2, h, w, 1, generator=gen)
        got, seam = tiling.tiled_apply(net, (x,), (8, 8), 2, seam_stats=True)
        torch.testing.assert_close(got, net(x), atol=1e-5, rtol=1e-5)
        if seam is not None:
            assert seam["max_abs"] < 1e-5


def test_tiled_apply_rejects_mismatched_frames():
    with pytest.raises(ValueError, match="share one"):
        tiling.tiled_apply(lambda a, b: a, (torch.zeros(1, 8, 8, 1), torch.zeros(1, 9, 8, 1)),
                           (8, 8), 2)
    with pytest.raises(ValueError, match="no image-like"):
        tiling.tiled_apply(lambda a: a, (torch.zeros(1, 8, 1),), (8, 8), 2)


@pytest.fixture(scope="module")
def jax_params():
    lr = np.zeros((1, FRAMES + 2 * U, 8, 8, 1), np.float32)
    pos = np.zeros((1, FRAMES + 2 * U, 1), np.float32)
    params = JaxRefineNet(**NET).init(jax.random.PRNGKey(3), lr, pos)["params"]
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("hw", [(20, 14), (6, 11)], ids=["windows", "padded"])
def test_tiled_refine_net_matches_jax(jax_params, hw):
    rng = np.random.default_rng(5)
    lr = rng.standard_normal((1, FRAMES + 2 * U, *hw, 1)).astype(np.float32)
    pos = rng.uniform(-1, 1, (1, FRAMES + 2 * U, 1)).astype(np.float32)
    jax_net = JaxRefineNet(**NET)
    params = jax.tree.map(jnp.asarray, jax_params)
    jax_fwd = jax.jit(lambda a, b: jax_net.apply({"params": params}, a, b)[-1])
    want, want_seam = jax_tiling.tiled_apply(jax_fwd, (lr, pos), (8, 8), 2, seam_stats=True)

    net = RefineNet(**NET).eval()
    net.load_state_dict(state_dict_from_jax_params(jax_params), strict=True)
    launches = lstm_gates.LAUNCHES
    with torch.inference_mode():
        got, seam = tiling.tiled_apply(lambda a, b: net(a, b)[-1],
                                       (torch.from_numpy(lr), torch.from_numpy(pos)), (8, 8), 2,
                                       seam_stats=True)
    assert lstm_gates.LAUNCHES == launches  # the CPU runs the plain version
    assert got.shape == want.shape == (1, FRAMES, hw[0] * SCALE, hw[1] * SCALE, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)
    assert seam["n_probes"] == want_seam["n_probes"] > 0
    assert seam["rms"] > 0  # RefineNet's receptive field outgrows overlap 2
    for key in ("rms", "max_abs"):
        assert seam[key] == pytest.approx(want_seam[key], abs=1e-4), key


def _tile_cfg(tree, saved_dir, ckpt, **pred_kwargs):
    return {
        "main": {"saved_dir": str(saved_dir), "loaded_path": str(ckpt)},
        "dataset": {"name": "Dsb15VSRRefineNetDataset", "kwargs": {
            "data_dir": str(tree["videos_dir"]), "downscale_factor": SCALE,
            "transforms": [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                           {"name": "ToTensor"}],
            "num_frames": 3, "num_updated_frames": U, "pos_code_path": str(tree["pos_code_path"])}},
        "dataloader": {"name": "Dataloader", "kwargs": {"batch_size": 1, "shuffle": False}},
        "net": {"name": "RefineNet", "kwargs": NET},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [{"name": "PSNR"}, {"name": "SSIM"}],
        "predictor": {"name": "AcdcVSRRefineNetPredictor", "kwargs": {
            "device": "cpu", "saved_dir": str(saved_dir), "exported": True, **pred_kwargs}},
    }


def test_tiled_predictor_matches_jax(jax_params, tmp_path, caplog):
    """``tile`` / ``tile_overlap`` with the default ``seam_stats: first``
    through both packages' ``test_from_config``: LR 16×12 frames in 8×8
    windows (3 × 2 a clip, and 3 seam probes for the first clip)."""
    tree = make_acdc_tree(tmp_path / "acdc", patients_per_split=1, slices=2, frames=FRAMES,
                          hr_size=(64, 48), splits=("test",))
    ckpt = tmp_path / "model.pth"
    save_torch_checkpoint(jax_params, ckpt)
    kwargs = {"tile": 8, "tile_overlap": 2}
    with caplog.at_level(logging.INFO):
        port = run_port_test(Cfg(_tile_cfg(tree, tmp_path / "port", ckpt, **kwargs)))
    seam_lines = [r.message for r in caplog.records if r.message.startswith("tile seam")]
    jax_pred = run_jax_test(JaxCfg(_tile_cfg(tree, tmp_path / "jax", ckpt, **kwargs)))
    for key in jax_pred.log:
        np.testing.assert_allclose(port.log[key], jax_pred.log[key], rtol=2e-3, atol=2e-3,
                                   err_msg=key)
    assert len(seam_lines) == 1 and "3 boundary probes" in seam_lines[0]  # first clip only
    assert port.seam_summary["items"] == jax_pred.seam_summary["items"] == 1
    for key in ("max_rms", "max_abs"):
        assert port.seam_summary[key] == pytest.approx(jax_pred.seam_summary[key], abs=5e-3)
    rows = [len((tmp_path / d / "results.csv").read_text().splitlines()) for d in ("port", "jax")]
    assert rows[0] == rows[1] == 1 + 2 * FRAMES
    untiled = run_port_test(Cfg(_tile_cfg(tree, tmp_path / "untiled", ckpt)))
    assert port.log != untiled.log  # the knob is live; at overlap 2 the seams show
