"""The PyTorch port's multi-frame nets and warps against the JAX package's.

* Warps (``ops/warp.py``; images NCHW in the port, NHWC in JAX):
  ``grid_sample`` with zeros and border padding at both ``align_corners``
  at atol 1e-6 / rtol 2e-6 (the corner weights' products round in another
  order: 9.6e-7 relative measured); ``flow_warp`` exact and windowed (``max_flow``) and
  ``windowed_sample`` in border mode at atol 1e-5, values and gradients
  (the chain divides by size−1, where XLA:CPU rounds a quotient 1 ulp off
  IEEE, ROADMAP queue 3); the windowed path equals the port's own gather
  for |flow| <= R, and for |flow| > R, where an out-of-window tap
  contributes exactly zero, port and JAX still agree.
* Nets: ``DUFNet`` (``_DenseLayer16``, size_filter 5, T=7, 8×8 LR frames),
  ``RBPNet`` (base_filter 16, feat 8, 3 stages, 2 resblocks, T=5, 8×8) and
  ``TOFlowNet`` (T=3, 6×6 LR frames: the upscaled 12/18/24 are no multiple
  of 16, so the min-value pad and the crop run) at ×2, ×3 and ×4, in eval
  and in train mode.  The JAX net is initialised from ``PRNGKey(0)``, its
  BatchNorm statistics moved off their init values, and both carried into
  the port by ``state_dict_from_jax_params(variables)`` with
  ``strict=True``.  Every output, the input's gradient and every
  parameter's gradient of an L1 loss at atol 5e-5 / rtol 1e-4 (the
  tolerance of ``tests/test_torch_sisr_nets.py``); the running statistics
  after one train-mode forward against JAX's mutated ``batch_stats`` at
  rtol 1e-5 / atol 1e-6.
* Keys: the port's ``state_dict`` through the JAX package's
  ``variables_from_torch_state_dict`` and back through
  ``state_dict_from_jax_params`` is bit-exact, running statistics
  included, and the flax variables have the JAX init's structure and
  shapes; ``_DenseLayer28`` and ``_DenseLayer52`` construct with JAX's
  parameter counts.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import models as jax_models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.ops import warp as jax_warp
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.torch_import import (
    variables_from_torch_state_dict,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models.common import (
    pad_to_multiple,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import warp
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)

B = 2
#: name → (kwargs without upscale_factor, T, LR side)
NETS = {
    "DUFNet": (dict(in_channels=1, out_channels=1, num_frames=7, size_filter=5,
                    backbone="_DenseLayer16"), 7, 8),
    "RBPNet": (dict(in_channels=1, out_channels=1, base_filter=16, feat=8, num_stages=3,
                    num_resblocks=2, num_frames=5), 5, 8),
    "TOFlowNet": (dict(in_channels=1, out_channels=1, num_frames=3), 3, 6),
}
TOL = dict(atol=5e-5, rtol=1e-4)


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


# ------------------------------------------------------------------- warps
def _image(seed, h=9, w=11, c=2):
    return np.random.default_rng(seed).standard_normal((B, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_matches_jax(padding_mode, align_corners):
    x = _image(0)
    grid = np.random.default_rng(1).uniform(-1.3, 1.3, (B, 7, 5, 2)).astype(np.float32)
    want = jax_warp.grid_sample(x, grid, padding_mode, align_corners)
    got = warp.grid_sample(_nchw(x), torch.from_numpy(grid), padding_mode, align_corners)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-6, rtol=2e-6)
    # bf16 images: coordinates and blend in fp32, the result in bf16
    got16 = warp.grid_sample(_nchw(x).to(torch.bfloat16), torch.from_numpy(grid), padding_mode,
                             align_corners)
    want16 = jax_warp.grid_sample(jnp.asarray(x, jnp.bfloat16), grid, padding_mode, align_corners)
    assert got16.dtype == torch.bfloat16 and want16.dtype == jnp.bfloat16
    np.testing.assert_allclose(_nhwc(got16.float()), np.asarray(want16, np.float32), atol=1e-2)


def _flow(seed, bound, h=9, w=11):
    return np.random.default_rng(seed).uniform(-bound, bound, (B, h, w, 2)).astype(np.float32)


def _warp_and_grads(fn_port, fn_jax, x, flow):
    """Values and the gradients of sum(out · weights) with respect to x and
    the flow, from the port and from JAX."""
    wts = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    xt, ft = _nchw(x).requires_grad_(True), torch.from_numpy(flow).requires_grad_(True)
    out = fn_port(xt, ft)
    (out * _nchw(wts)).sum().backward()
    want, (dx, dflow) = jax.value_and_grad(
        lambda a, f: jnp.sum(fn_jax(a, f) * wts), argnums=(0, 1))(x, flow)
    return (_nhwc(out), np.asarray(fn_jax(x, flow)), _nhwc(xt.grad), np.asarray(dx),
            ft.grad.numpy(), np.asarray(dflow))


@pytest.mark.parametrize("max_flow,bound", [(None, 4.0), (2, 2.0), (2, 4.5)],
                         ids=["exact", "windowed-in-window", "windowed-beyond-window"])
def test_flow_warp_matches_jax(max_flow, bound):
    x, flow = _image(2), _flow(3, bound)
    got, want, dx, dx_j, df, df_j = _warp_and_grads(
        lambda a, f: warp.flow_warp(a, f, max_flow=max_flow),
        lambda a, f: jax_warp.flow_warp(a, f, max_flow=max_flow), x, flow)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dx, dx_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(df, df_j, atol=1e-5, rtol=0)
    if max_flow is not None:
        with torch.no_grad():
            gather = _nhwc(warp.flow_warp(_nchw(x), torch.from_numpy(flow)))
        gap = np.abs(got - gather).max()
        if bound <= max_flow:  # the window covers every tap: the gather's value
            assert gap <= 1e-5, gap
        else:  # taps beyond the window contribute zero, unlike the gather
            assert gap > 1e-2, gap


def test_windowed_sample_border_matches_jax():
    x = _image(4)
    off = np.random.default_rng(5).uniform(-3.5, 3.5, (2, B, 9, 11)).astype(np.float32)
    got = warp.windowed_sample(_nchw(x), torch.from_numpy(off[0]), torch.from_numpy(off[1]), 2,
                               padding_mode="border")
    want = jax_warp.windowed_sample(x, off[0], off[1], 2, padding_mode="border")
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-6, rtol=0)


def test_pad_to_multiple_takes_the_whole_tensors_minimum():
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.models.common import (
        pad_to_multiple as jax_pad,
    )

    x = np.random.default_rng(6).standard_normal((B, 3, 10, 21, 1)).astype(np.float32)
    x[1, 2, 0, 0, 0] = -9.0  # the minimum lies in another item and frame
    got, crops = pad_to_multiple(torch.from_numpy(x), 16, dims=(-3, -2))
    want, want_crops = jax_pad(x, 16, axes=(-3, -2))
    assert crops == want_crops and got.shape == want.shape == (B, 3, 16, 32, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0, 0, 0, 0].item() == -9.0
    np.testing.assert_array_equal(got[crops].numpy(), x)
    assert pad_to_multiple(torch.zeros(1, 16, 32, 1), 16)[1] is None


# -------------------------------------------------------------------- nets
#: input seeds.  TOFlow's ReLUs see ~3e5 pre-activations a forward, and
#: where one lies within the backends' rounding of zero (~1e-7 here: the
#: two sum a conv in different orders) the ReLU's subgradient is decided by
#: rounding: on seed 7 an ``out_block.0`` pre-activation of 3.7e-8 (×2,
#: eval) takes the other side in JAX than in the port in fp32 (the port in
#: fp64 takes JAX's), which moves block 0's flow-bias gradient by 1.1%.  Its
#: inputs therefore come from a seed whose pre-activations all keep 1.5e-7
#: from zero, a precondition the test checks.
SEEDS = {"DUFNet": 7, "RBPNet": 7, "TOFlowNet": 14}
RELU_MARGIN = 1.5e-7


def _input(name, seed=None):
    _, T, hw = NETS[name]
    seed = SEEDS[name] if seed is None else seed
    return np.random.default_rng(seed).standard_normal((B, T, hw, hw, 1)).astype(np.float32)


def _relu_margin(net, x) -> float:
    """The smallest |pre-activation| of the net's ``nn.ReLU`` modules on x."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(a[0].abs().min().item()))
             for m in net.modules() if isinstance(m, torch.nn.ReLU)]
    with torch.no_grad():
        net(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    return min(seen, default=float("inf"))


@functools.lru_cache(maxsize=None)
def _jax_pair(name, r):
    """The JAX net and its variables from ``PRNGKey(0)``, the BatchNorm
    statistics moved off their init values (so eval reads them)."""
    kwargs = NETS[name][0]
    jax_net = getattr(jax_models, name)(upscale_factor=r, **kwargs)
    variables = jax.tree.map(np.asarray, jax_net.init(jax.random.PRNGKey(0), _input(name)))
    if "batch_stats" in variables:
        rng = np.random.default_rng(11)
        variables["batch_stats"] = jax.tree.map(
            lambda a: (a + rng.uniform(0.05, 0.3, a.shape)).astype(np.float32),
            variables["batch_stats"])
    return jax_net, variables


def _port_net(name, r):
    _, variables = _jax_pair(name, r)
    net = getattr(models, name)(upscale_factor=r, **NETS[name][0])
    net.load_state_dict(state_dict_from_jax_params(variables, name), strict=True)
    return net


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("name", list(NETS))
def test_outputs_and_gradients_match_jax(name, r, train):
    jax_net, variables = _jax_pair(name, r)
    x = _input(name)
    assert _relu_margin(_port_net(name, r).train(train), x) > RELU_MARGIN
    net = _port_net(name, r).train(train)
    hw = NETS[name][2] * r
    target = np.random.default_rng(8).standard_normal((B, hw, hw, 1)).astype(np.float32)
    has_bn = "batch_stats" in variables
    stats = variables.get("batch_stats", {})

    def loss_fn(params, x):
        v = {"params": params, **({"batch_stats": stats} if has_bn else {})}
        if train and has_bn:
            out, new = jax_net.apply(v, x, train=True, mutable=["batch_stats"])
        else:
            out, new = jax_net.apply(v, x, **({"train": train} if has_bn else {})), {}
        return jnp.mean(jnp.abs(out - target)), (out, new)

    (want_loss, (want, new_vars)), (jax_grads, jax_dx) = jax.jit(
        jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(variables["params"], x)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = net(xt)
    loss = torch.mean(torch.abs(out - torch.from_numpy(target)))
    loss.backward()

    assert tuple(out.shape) == want.shape == (B, hw, hw, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jax_dx), **TOL)
    want_grads = state_dict_from_jax_params(jax.tree.map(np.asarray, jax_grads), name)
    grads = {n: p.grad for n, p in net.named_parameters()}
    assert grads.keys() == want_grads.keys()
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[n].numpy(), **TOL, err_msg=n)
    if train and has_bn:  # one train-mode forward moved the running statistics alike
        moved = state_dict_from_jax_params(
            {"params": variables["params"], **jax.tree.map(np.asarray, new_vars)}, name)
        sd = net.state_dict()
        running = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        assert running and all(not torch.equal(sd[k], _port_net(name, r).state_dict()[k])
                               for k in running)
        for k in running:
            np.testing.assert_allclose(sd[k].numpy(), moved[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("name", list(NETS))
def test_state_dict_round_trip_through_the_jax_key_map(name):
    """port keys → the JAX package's torch key map → the port's inverse,
    bit-exact, running statistics included; the flax variables have the JAX
    init's structure and shapes (×3: RBPN's 7×7 projections)."""
    net = getattr(models, name)(upscale_factor=3, **NETS[name][0],
                                generator=torch.Generator().manual_seed(5))
    with torch.no_grad():  # statistics off their init values
        for key, buf in net.named_buffers():
            if key.endswith("running_mean"):
                buf.uniform_(-1, 1, generator=torch.Generator().manual_seed(6))
    sd = net.state_dict()
    variables = variables_from_torch_state_dict(name, sd)
    _, jax_variables = _jax_pair(name, 3)
    assert set(variables) == set(jax_variables)
    assert jax.tree.map(np.shape, variables) == jax.tree.map(np.shape, jax_variables)
    back = state_dict_from_jax_params(variables, name)
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert back[key].dtype == value.dtype and back[key].shape == value.shape, key
        assert torch.equal(back[key], value) or key.endswith("num_batches_tracked"), key
    # without batch_stats a BatchNorm net does not load: no silent init statistics
    if "batch_stats" in variables:
        with pytest.raises(RuntimeError, match="running_mean"):
            net.load_state_dict(state_dict_from_jax_params(variables["params"], name))


@pytest.mark.parametrize("backbone", ["_DenseLayer28", "_DenseLayer52"])
def test_duf_backbones_have_jax_parameter_counts(backbone):
    kwargs = dict(in_channels=1, out_channels=1, num_frames=7, size_filter=5, upscale_factor=4,
                  backbone=backbone)
    net = models.DUFNet(**kwargs)
    shapes = jax.eval_shape(jax_models.DUFNet(**kwargs).init, jax.random.PRNGKey(0),
                            np.zeros((1, 7, 8, 8, 1), np.float32))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in net.parameters()) == want
    scales = [path for path, _ in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
              if path[-1].key == "scale"]
    assert sum(isinstance(m, torch.nn.BatchNorm3d) for m in net.modules()) == len(scales)
    with pytest.raises(ValueError, match="backbone"):
        models.DUFNet(**{**kwargs, "backbone": "_DenseLayer7"})
