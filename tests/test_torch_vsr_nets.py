"""The PyTorch port's plain video nets (DRF, FRVSR) and their ops against the JAX package's.

* ``space_to_depth``: channel-last, equal to JAX's bit for bit, channels
  grouped (c, i, j) (FRVSR's packed layout), the inverse of
  ``pixel_shuffle`` and ``F.pixel_unshuffle`` permuted.
* ``stn_warp`` (non-square 9×11 frames in [-1, 1]), exact and windowed:
  values and the image's gradient at atol 1e-6 (measured 8.1e-7 at most
  over 4 seeds: ``F.grid_sample`` and the JAX gather round the corner
  products in another order), the flow's gradients within 1e-6 of their
  largest element (measured 3.2e-7); the windowed path equals the exact one
  within 1e-6 (measured 8.8e-7) while the pixel flow stays within
  ``max_flow`` and departs from it beyond, where ``exceedance_triple``
  counts exactly the samples outside.
* Nets: ``DRFNet`` (8 features, 2 groups, T=3, 6×7 LR frames) at ×2, ×3,
  ×4 and ``FRVSRNet`` (2 resblocks, T=3, 10×13 LR frames: FNet pads both
  axes to /8) from the JAX init: every output (both FRVSR heads), the
  input's gradient and every parameter's gradient of an L1 loss on the SR
  frames (plus an MSE of the warped LR frames for FRVSR) at atol 5e-5 /
  rtol 1e-4, with ``remat`` off and on, on both sides.  FRVSR at ×2 raises
  the JAX package's ``ValueError``.  bf16 FRVSR with ``max_flow: 4`` by
  the ratio rule of ``tests/test_torch_tpu_knobs.py``: the port's
  bf16-vs-fp32 gap is 0.6-1.5× JAX's (measured 0.97-0.98 on the two heads;
  0.98-0.99 without ``max_flow``).
* Keys: the port's ``state_dict`` through the JAX package's
  ``variables_from_torch_state_dict`` has the JAX init's structure and
  shapes, and comes back through ``state_dict_from_jax_params``
  bit-exact.
* ``FRVSRStream``: each push equals the clip forward's frame bit for bit
  (fp32, and bf16 against the bf16 clip forward), ``reset`` restarts the
  sequence, ``run`` yields every frame in order, and the JAX stream's
  ``TypeError`` / ``ValueError`` are raised.
"""
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import models as jax_models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.ops.pixel_shuffle import (
    space_to_depth as jax_space_to_depth,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.ops import warp as jax_warp
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.casting import (
    cast_floating as jax_cast_floating,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.torch_import import (
    variables_from_torch_state_dict,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
    telemetry,
    warp,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops.pixel_shuffle import (
    pixel_shuffle,
    space_to_depth,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.streaming import (
    FRVSRStream,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.casting import (
    forward_in,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)

B = 2
#: name → (kwargs without upscale_factor, T, LR (h, w))
NETS = {
    "DRFNet": (dict(in_channels=1, out_channels=1, num_features=8, num_groups=2), 3, (6, 7)),
    "FRVSRNet": (dict(in_channels=1, out_channels=1, num_resblocks=2), 3, (10, 13)),
}
TOL = dict(atol=5e-5, rtol=1e-4)
BF16_GAP_RATIO = (0.6, 1.5)  # tests/test_torch_tpu_knobs.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (test workers run side by
    side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


# --------------------------------------------------------------------- ops
@pytest.mark.parametrize("r", [2, 4])
def test_space_to_depth_matches_jax(r):
    x = np.random.default_rng(0).standard_normal((B, 3, 4 * r, 3 * r, 2)).astype(np.float32)
    got = space_to_depth(torch.from_numpy(x), r)
    want = np.asarray(jax_space_to_depth(x, r))
    assert tuple(got.shape) == want.shape == (B, 3, 4, 3, 2 * r * r)
    np.testing.assert_array_equal(got.numpy(), want)
    # channel c*r² + i*r + j holds channel c at subpixel (i, j)
    np.testing.assert_array_equal(got[..., 1 * r * r + (r - 1) * r + 1].numpy(),
                                  x[:, :, r - 1::r, 1::r, 1])
    np.testing.assert_array_equal(pixel_shuffle(got, r).numpy(), x)
    frames = torch.from_numpy(x[:, 0])
    np.testing.assert_array_equal(
        F.pixel_unshuffle(frames.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1).numpy(),
        want[:, 0])
    with pytest.raises(ValueError, match="divisible"):
        space_to_depth(torch.zeros(1, 5, 4, 1), 2)


def _stn_inputs(pixel_bound, h=9, w=11, seed=0):
    """An image in [-1, 1] and a normalised (u, v) flow whose pixel flow
    (u·w/2, v·h/2) is uniform in ±``pixel_bound``."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (B, h, w, 2)).astype(np.float32)
    u = (rng.uniform(-pixel_bound, pixel_bound, (B, h, w)) * 2.0 / w).astype(np.float32)
    v = (rng.uniform(-pixel_bound, pixel_bound, (B, h, w)) * 2.0 / h).astype(np.float32)
    return x, u, v


@pytest.mark.parametrize("max_flow,bound", [(None, 4.0), (2, 2.0), (2, 4.5)],
                         ids=["exact", "windowed-in-window", "windowed-beyond-window"])
def test_stn_warp_matches_jax(max_flow, bound):
    x, u, v = _stn_inputs(bound)
    wts = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    xt = _nchw(x).requires_grad_(True)
    ut, vt = (torch.from_numpy(a).requires_grad_(True) for a in (u, v))
    out = warp.stn_warp(xt, ut, vt, "border", max_flow=max_flow)
    (out * _nchw(wts)).sum().backward()

    def fn(a, uu, vv):
        return jax_warp.stn_warp(a, uu, vv, "border", max_flow=max_flow)

    want = np.asarray(fn(x, u, v))
    dx, du, dv = jax.grad(lambda a, uu, vv: jnp.sum(fn(a, uu, vv) * wts), argnums=(0, 1, 2))(
        x, u, v)
    np.testing.assert_allclose(_nhwc(out), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx), atol=1e-6, rtol=0)
    for got, want_d in ((ut.grad, du), (vt.grad, dv)):  # relative to the largest (~20-30)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_d), rtol=0,
                                   atol=1e-6 * np.abs(np.asarray(want_d)).max())
    if max_flow is None:
        return
    with torch.no_grad():
        exact = _nhwc(warp.stn_warp(_nchw(x), torch.from_numpy(u), torch.from_numpy(v)))
    pixel = np.maximum(np.abs(u) * x.shape[2] / 2.0, np.abs(v) * x.shape[1] / 2.0)
    n_out, n, mx = telemetry.exceedance_triple(
        max_flow, torch.from_numpy(np.abs(u) * x.shape[2] / 2.0),
        torch.from_numpy(np.abs(v) * x.shape[1] / 2.0)).tolist()
    assert n == pixel.size and mx == pytest.approx(float(pixel.max()), rel=1e-6)
    assert n_out == int(np.sum(pixel > max_flow))
    gap = np.abs(_nhwc(out) - exact).max()
    if bound <= max_flow:  # the window covers every tap: the exact path's value
        assert n_out == 0 and gap <= 1e-6, gap
    else:  # beyond the window the displacement is clamped to it
        assert n_out > 0.3 * n and gap > 1e-2, gap


# -------------------------------------------------------------------- nets
def _input(name, seed=7):
    _, T, (h, w) = NETS[name]
    return np.random.default_rng(seed).standard_normal((B, T, h, w, 1)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_variables(name, r, max_flow=None):
    kwargs = NETS[name][0] | ({"max_flow": max_flow} if max_flow else {})
    net = getattr(jax_models, name)(upscale_factor=r, **kwargs)
    return jax.tree.map(np.asarray, net.init(jax.random.PRNGKey(0), _input(name)))


def _port_net(name, r, **overrides):
    net = getattr(models, name)(upscale_factor=r, **NETS[name][0], **overrides)
    net.load_state_dict(state_dict_from_jax_params(_jax_variables(name, r), name), strict=True)
    return net


CASES = [("DRFNet", 2, False), ("DRFNet", 3, False), ("DRFNet", 4, False), ("DRFNet", 4, True),
         ("FRVSRNet", 4, False), ("FRVSRNet", 4, True)]


@pytest.mark.parametrize("name,r,remat", CASES,
                         ids=[f"{n}-x{r}{'-remat' if m else ''}" for n, r, m in CASES])
def test_outputs_and_gradients_match_jax(name, r, remat):
    x = _input(name)
    _, T, (h, w) = NETS[name]
    target = np.random.default_rng(8).standard_normal((B, T, h * r, w * r, 1)).astype(np.float32)
    jax_net = getattr(jax_models, name)(upscale_factor=r, remat=remat, **NETS[name][0])

    def loss_fn(params, x):
        out = jax_net.apply({"params": params}, x)
        sr, warped = out if isinstance(out, tuple) else (out, None)
        loss = jnp.mean(jnp.abs(sr - target))
        if warped is not None:
            loss = loss + jnp.mean((warped - x) ** 2)
        return loss, out

    (want_loss, want), (jax_grads, jax_dx) = jax.jit(
        jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
        _jax_variables(name, r)["params"], x)
    net = _port_net(name, r, remat=remat)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = net(xt)
    sr, warped = out if isinstance(out, tuple) else (out, None)
    loss = torch.mean(torch.abs(sr - torch.from_numpy(target)))
    if warped is not None:
        loss = loss + torch.mean((warped - xt) ** 2)
    loss.backward()

    want = want if isinstance(want, tuple) else (want,)
    got = out if isinstance(out, tuple) else (out,)
    assert len(got) == len(want) == (2 if name == "FRVSRNet" else 1)
    assert tuple(got[0].shape) == (B, T, h * r, w * r, 1)
    for g, wnt in zip(got, want):
        assert tuple(g.shape) == wnt.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(wnt), **TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jax_dx), **TOL)
    want_grads = state_dict_from_jax_params(jax.tree.map(np.asarray, jax_grads), name)
    grads = {n: p.grad for n, p in net.named_parameters()}
    assert grads.keys() == want_grads.keys()
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[n].numpy(), **TOL, err_msg=n)


def test_frvsr_is_x4_only():
    for r in (2, 3):
        with pytest.raises(ValueError, match="upscale_factor=4 only"):
            models.FRVSRNet(1, 1, r)
        with pytest.raises(ValueError, match="upscale_factor=4 only"):
            jax_models.FRVSRNet(1, 1, r)


def test_bf16_frvsr_tracks_jax(max_flow=4):
    """configs/test/frvsr_net/exp1_x4_tpu.yaml's knobs (bf16, ``max_flow: 4``)
    against fp32, port and JAX, with oneDNN off (its bf16 conv on the CPU
    does not keep an fp32 sum; ``tests/test_torch_misr_runner.py``).  Under
    JAX bf16 FNet's decoder promotes to fp32 at its first resize product and
    the flows are fp32, the warps and SRNet bf16; the port's convs promote
    likewise."""
    variables = _jax_variables("FRVSRNet", 4, max_flow)
    jax_net = jax_models.FRVSRNet(upscale_factor=4, max_flow=max_flow, **NETS["FRVSRNet"][0])
    x = _input("FRVSRNet", seed=1)
    apply = jax.jit(jax_net.apply)
    j32 = [np.asarray(a) for a in apply(variables, x)]
    j16 = [np.asarray(a, np.float32) for a in apply(
        jax_cast_floating(jax.tree.map(jnp.asarray, variables), jnp.bfloat16),
        jnp.asarray(x, jnp.bfloat16))]
    net = _port_net("FRVSRNet", 4, max_flow=max_flow)
    with torch.inference_mode(), torch.backends.mkldnn.flags(enabled=False):
        p32 = [a.numpy() for a in net(torch.from_numpy(x))]
        p16 = [a.numpy() for a in forward_in(net, torch.bfloat16, torch.from_numpy(x))]
    for a, b, c, d in zip(p32, j32, p16, j16):
        np.testing.assert_allclose(a, b, **TOL)
        ratio = np.sqrt(np.mean((c - a) ** 2) / np.mean((d - b) ** 2))
        assert BF16_GAP_RATIO[0] <= ratio <= BF16_GAP_RATIO[1], ratio


@pytest.mark.parametrize("name", list(NETS))
def test_state_dict_round_trip_through_the_jax_key_map(name):
    net = getattr(models, name)(upscale_factor=4, **NETS[name][0],
                                generator=torch.Generator().manual_seed(5))
    sd = net.state_dict()
    variables = variables_from_torch_state_dict(name, sd)
    jax_params = _jax_variables(name, 4)["params"]
    assert jax.tree.map(np.shape, variables["params"]) == jax.tree.map(np.shape, jax_params)
    back = state_dict_from_jax_params(variables, name)
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert back[key].dtype == value.dtype and torch.equal(back[key], value), key


def test_frvsr_init_is_xavier_uniform():
    net = models.FRVSRNet(1, 1, 4, num_resblocks=1)
    for name, p in net.named_parameters():
        if name.endswith("weight"):
            fan_sum = (p.shape[0] + p.shape[1]) * p.shape[2] * p.shape[3]
            bound = float(np.sqrt(6.0 / fan_sum))
            assert p.abs().max().item() <= bound and p.abs().max().item() > 0.8 * bound, name


# ------------------------------------------------------------------ stream
def _stream_net():
    net = _port_net("FRVSRNet", 4).eval()
    return net, _input("FRVSRNet", seed=3)


def test_stream_pushes_equal_the_clip_forward_bit_for_bit():
    net, clip = _stream_net()
    with torch.inference_mode():
        sr_clip, _ = net(torch.from_numpy(clip))
        sr16 = forward_in(net, torch.bfloat16, torch.from_numpy(clip))[0]
    stream, stream16 = FRVSRStream(net), FRVSRStream(net, compute_dtype="bfloat16")
    for t in range(clip.shape[1]):
        assert torch.equal(stream.push(clip[:, t]), sr_clip[:, t]), t
        got16 = stream16.push(torch.from_numpy(clip[:, t]))
        assert got16.dtype == torch.float32 and torch.equal(got16, sr16[:, t]), t
    assert next(net.parameters()).dtype == torch.float32  # the bf16 stream copied the net


def test_stream_reset_and_run():
    net, clip = _stream_net()
    stream = FRVSRStream(net)
    first = stream.push(clip[:, 0])
    stream.push(clip[:, 1])
    stream.reset()
    assert torch.equal(stream.push(clip[:, 0]), first)
    stream.reset()
    with torch.inference_mode():
        sr_clip = net(torch.from_numpy(clip))[0].numpy()
    frames = list(stream.run(clip, lookahead=2))
    assert len(frames) == clip.shape[1]
    for t, f in enumerate(frames):
        np.testing.assert_array_equal(f, sr_clip[:, t])


def test_stream_rejects_wrong_rank_and_wrong_net():
    net, clip = _stream_net()
    with pytest.raises(ValueError, match="one \\(B, h, w, C\\) frame"):
        FRVSRStream(net).push(clip)
    with pytest.raises(TypeError, match="FRVSRNet"):
        FRVSRStream(_port_net("DRFNet", 4))
