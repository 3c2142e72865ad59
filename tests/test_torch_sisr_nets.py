"""The PyTorch port's single-image nets, resize and losses against the JAX package's.

* Resize: ``resize_matrix`` and the four resize functions at (in, out)
  pairs of ×2, ×3, ×4 and a non-multiple, both coordinate mappings and both
  kernels, at atol 1e-6.
* Nets: ``Bicubic``, ``EDSRNet`` (2 blocks × 16 features), ``SRFBNet`` and
  ``DRFSISRNet`` (8 features, 2 groups, 2 steps) at ×2, ×3 and ×4 on
  16×16 LR frames from a numpy seed.  The JAX net is initialised from
  ``PRNGKey(0)`` and its weights carried into the port by
  ``state_dict_from_jax_params`` (``strict=True``).  Every output, and every
  parameter's gradient of an L1 loss (the mean over the steps for the
  feedback nets, as ``SISRSRFBTrainer`` takes it), at atol 5e-5 / rtol 1e-4,
  the tolerance of ``tests/test_torch_refine_net.py``.
* Keys: the port's ``state_dict`` through the JAX package's
  ``variables_from_torch_state_dict`` and back through
  ``state_dict_from_jax_params`` is bit-exact, and the flax tree it makes
  has the JAX init's structure and shapes.
* Losses: every loss of ``losses.py`` on random pairs, at rtol 1e-5.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import losses as JL
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import models as jax_models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.ops import (
    resize as jax_resize,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.torch_import import (
    variables_from_torch_state_dict,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import losses as PL
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import LOSSES
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models.common import (
    PROJ_PARAMS,
    conv2d,
    conv_format,
    conv_transpose2d,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import resize
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)

B, HW = 2, 16
NET_KWARGS = {
    "Bicubic": {},
    "EDSRNet": dict(in_channels=1, out_channels=1, num_resblocks=2, num_features=16),
    "SRFBNet": dict(in_channels=1, out_channels=1, num_steps=2, num_features=8, num_groups=2),
    "DRFSISRNet": dict(in_channels=1, out_channels=1, num_steps=2, num_features=8, num_groups=2),
}
STEPPED = {"SRFBNet", "DRFSISRNet"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (test workers run side by
    side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ resize
PAIRS = [(16, 32), (16, 48), (16, 64), (10, 23), (23, 10), (1, 4), (5, 5)]


@pytest.mark.parametrize("kind", ["cubic", "linear"])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("pair", PAIRS, ids=[f"{a}to{b}" for a, b in PAIRS])
def test_resize_matrix_matches_jax(pair, align_corners, kind):
    got = resize.resize_matrix(*pair, align_corners, kind)
    want = jax_resize.resize_matrix(*pair, align_corners, kind)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == pair[::-1]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_resize_functions_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 10, 16, 1)).astype(np.float32)
    xt = torch.from_numpy(x)
    cases = []
    for ac in (True, False):
        cases += [(resize.resize_bicubic(xt, (23, 37), ac), jax_resize.resize_bicubic(x, (23, 37), ac)),
                  (resize.resize_bilinear(xt, (23, 37), ac), jax_resize.resize_bilinear(x, (23, 37), ac))]
        for r in (2, 3, 4):
            cases += [(resize.upsample_bicubic(xt, r, ac), jax_resize.upsample_bicubic(x, r, ac)),
                      (resize.upsample_bilinear(xt, r, ac), jax_resize.upsample_bilinear(x, r, ac))]
    for got, want in cases:
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# -------------------------------------------------------------------- nets
def _input(seed=7):
    return np.random.default_rng(seed).standard_normal((B, HW, HW, 1)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_pair(name, r):
    jax_net = getattr(jax_models, name)(upscale_factor=r, **NET_KWARGS[name])
    params = jax_net.init(jax.random.PRNGKey(0), _input())
    return jax_net, jax.tree.map(np.asarray, params.get("params", {}))


def _port_net(name, r):
    _, params = _jax_pair(name, r)
    net = getattr(models, name)(upscale_factor=r, **NET_KWARGS[name])
    net.load_state_dict(state_dict_from_jax_params(params, name) if params else {}, strict=True)
    return net


def _as_list(outputs):
    return list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]


@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("name", list(NET_KWARGS))
def test_outputs_and_gradients_match_jax(name, r):
    jax_net, params = _jax_pair(name, r)
    net = _port_net(name, r)
    x = _input()
    target = np.random.default_rng(8).standard_normal((B, HW * r, HW * r, 1)).astype(np.float32)

    def loss_fn(p, x):
        # L1 of each output, averaged over the steps (``SISRSRFBTrainer``)
        outputs = jax_net.apply({"params": p}, x)
        l1 = [jnp.mean(jnp.abs(o - target)) for o in _as_list(outputs)]
        return jnp.mean(jnp.stack(l1)), outputs

    (want_loss, want), (jax_grads, jax_dx) = jax.jit(
        jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(params, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    outputs = net(xt)
    loss = torch.mean(torch.stack([torch.mean(torch.abs(o - torch.from_numpy(target)))
                                   for o in _as_list(outputs)]))
    loss.backward()

    got, want = _as_list(outputs), _as_list(want)
    assert len(got) == len(want) == (NET_KWARGS[name]["num_steps"] if name in STEPPED else 1)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape == (B, HW * r, HW * r, 1)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=5e-5, rtol=1e-4,
                                   err_msg=f"output {i}")
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jax_dx), atol=5e-5, rtol=1e-4)
    want_grads = (state_dict_from_jax_params(jax.tree.map(np.asarray, jax_grads), name)
                  if params else {})
    grads = {n: p.grad for n, p in net.named_parameters()}
    assert grads.keys() == want_grads.keys()
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[n].numpy(), atol=5e-5, rtol=1e-4,
                                   err_msg=n)


@pytest.mark.parametrize("name", ["EDSRNet", "SRFBNet", "DRFSISRNet"])
def test_state_dict_round_trip_through_the_jax_key_map(name):
    """port keys → the JAX package's torch key map → the port's inverse,
    bit-exact; the flax tree has the JAX init's structure and shapes (×3:
    the 7×7 projection kernels)."""
    net = getattr(models, name)(upscale_factor=3, **NET_KWARGS[name],
                                generator=torch.Generator().manual_seed(5))
    sd = net.state_dict()
    variables = variables_from_torch_state_dict(name, sd)
    assert set(variables) == {"params"}
    _, jax_params = _jax_pair(name, 3)
    want_shapes = jax.tree.map(np.shape, jax_params)
    assert jax.tree.map(np.shape, variables["params"]) == want_shapes
    back = state_dict_from_jax_params(variables["params"], name)
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert back[key].shape == value.shape and torch.equal(back[key], value), key


def test_conv_transpose_and_strided_projection_sizes():
    """``PROJ_PARAMS`` (k, s, p) give exactly r× up and 1/r× down."""
    g = torch.Generator().manual_seed(0)
    for r, (k, s, p) in PROJ_PARAMS.items():
        x = torch.zeros(1, 2, 5, 7)
        up = conv_transpose2d(2, 2, k, s, p, g)(x)
        assert up.shape == (1, 2, 5 * r, 7 * r)
        assert conv2d(2, 2, k, g, stride=s, padding=p)(up).shape == (1, 2, 5, 7)


def test_unknown_net_in_the_weight_map_raises():
    with pytest.raises(KeyError, match="NoSuchNet"):
        state_dict_from_jax_params({}, "NoSuchNet")


# ------------------------------------------------------------------ losses
def _loss_inputs(name, rng):
    shape = (2, 3, 6, 5)
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    if name == "BCELoss":
        return rng.uniform(0.01, 0.99, shape).astype(np.float32), rng.uniform(0, 1, shape).astype(np.float32)
    if name == "KLDivLoss":
        logp = np.log(rng.dirichlet(np.ones(3), size=(2, 6, 5))).astype(np.float32).transpose(0, 3, 1, 2)
        q = rng.dirichlet(np.ones(3), size=(2, 6, 5)).astype(np.float32).transpose(0, 3, 1, 2)
        q[0, :, 0, 0] = [0.0, 0.5, 0.5]  # 0·log 0 := 0
        return np.ascontiguousarray(logp), np.ascontiguousarray(q)
    if name in ("NLLLoss", "CrossEntropyLoss"):
        return a, rng.integers(0, 3, size=(2, 6, 5))
    if name == "PoissonNLLLoss":
        return a, rng.poisson(2.0, shape).astype(np.float32)
    if name in ("SoftMarginLoss", "HingeEmbeddingLoss"):
        return a, rng.choice([-1.0, 1.0], size=shape).astype(np.float32)
    return a, b


LOSS_KWARGS = {"HuberLoss": {"delta": 0.5}, "CharbonnierLoss": {"epsilon": 1e-3}}
LOSS_NAMES = sorted(LOSSES.names())


def test_every_jax_loss_is_ported():
    jax_names = {n for n, v in vars(JL).items()
                 if isinstance(v, type) and issubclass(v, JL.Loss) and n.endswith("Loss")
                 and not n.startswith("_") and n != "Loss"}
    assert jax_names == set(LOSS_NAMES)


# every loss at its default reduction; the torch builtins also summed
LOSS_CASES = [(n, "mean") for n in LOSS_NAMES] + [
    (n, "sum") for n in LOSS_NAMES if issubclass(getattr(PL, n), PL._TorchLoss)]


@pytest.mark.parametrize("name,reduction", LOSS_CASES, ids=[f"{n}-{r}" for n, r in LOSS_CASES])
def test_loss_matches_jax(name, reduction):
    cls = getattr(PL, name)
    kwargs = dict(LOSS_KWARGS.get(name, {}))
    if reduction == "sum":
        kwargs["reduction"] = "sum"
    rng = np.random.default_rng(sorted(LOSS_NAMES).index(name))
    out, tgt = _loss_inputs(name, rng)
    got = cls(**kwargs)(torch.from_numpy(out), torch.from_numpy(tgt))
    want = getattr(JL, name)(**kwargs)(jnp.asarray(out), jnp.asarray(tgt))
    assert cls(**kwargs).name == name
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-7)
    if name not in ("NLLLoss", "CrossEntropyLoss"):  # elementwise: per-sample values
        per = cls(**kwargs)(torch.from_numpy(out), torch.from_numpy(tgt), dim=(1, 2, 3))
        for i in range(out.shape[0]):
            want_i = getattr(JL, name)(**kwargs)(jnp.asarray(out[i]), jnp.asarray(tgt[i]))
            np.testing.assert_allclose(per[i].item(), float(want_i), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["EDSRNet", "SRFBNet", "DRFSISRNet"])
def test_conv_layout_follows_the_dtype(name):
    """The nets run their convs in ``conv_format(dtype)``: NCHW in fp32,
    channels-last in bf16; the one-channel input's permuted view, which is
    both, does not decide it."""
    net = getattr(models, name)(upscale_factor=2, **NET_KWARGS[name])
    first = next(m for m in net.modules() if isinstance(m, torch.nn.Conv2d))
    seen = []
    first.register_forward_hook(lambda m, a, out: seen.append(
        (out.dtype, out.is_contiguous(), out.is_contiguous(memory_format=torch.channels_last))))
    with torch.inference_mode():
        net(torch.from_numpy(_input()))
        net.to(torch.bfloat16)(torch.from_numpy(_input()).to(torch.bfloat16))
    assert conv_format(torch.float32) == torch.contiguous_format
    assert seen == [(torch.float32, True, False), (torch.bfloat16, False, True)]
