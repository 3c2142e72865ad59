"""The PyTorch port's ConvLSTM gate tail against the JAX package's.

On CPU tensors the port's wrapper runs its plain version; both are held
against the JAX oracle and the Pallas kernel in interpret mode, forward and
backward, at fp32 atol 1e-6 (the shapes of ``test_pallas_kernels.py``).  The
plain version of the backward kernel, ``lstm_gates_backward_reference``, is
held against ``torch.autograd`` of the plain forward (atol 1e-6) and
against ``jax.vjp(lstm_gates_reference)`` (atol 2e-6: torch's autograd
itself differs from JAX by up to 1.1e-6 on these inputs, see the test) at
the same shapes, in the channels-last and the NCHW layout.  The CUDA kernels themselves are checked
on the card by ``chip_smoke.py`` and by ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.ops.pallas import (
    fused_lstm_gates as jax_fused,
    lstm_gates_reference as jax_reference,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
    lstm_gates,
)

SHAPES = [(s, F) for s in [(2, 8, 8), (1, 16, 16), (3, 7, 5)] for F in (64, 128)]
SHAPES.append(((3, 11, 7), 64))  # rows not a multiple of the Pallas 256-row tile


def _inputs(shape, F, seed=0):
    rng = np.random.default_rng(seed)
    gates = rng.standard_normal((*shape, 4 * F)).astype(np.float32) * 2
    c = rng.standard_normal((*shape, F)).astype(np.float32)
    return gates, c


def _float64_gates(gates, c):
    """The gate tail in float64 (numpy): the truth each side is measured
    from when they disagree."""
    g, c = gates.astype(np.float64), c.astype(np.float64)
    i, f, o, gg = np.split(g, 4, axis=-1)
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))  # noqa: E731
    c_next = sig(f) * c + sig(i) * np.tanh(gg)
    return sig(o) * np.tanh(c_next), c_next


@pytest.mark.parametrize("shape,F", SHAPES)
def test_gates_match_jax(shape, F):
    """A miss reports each side's distance from float64, which names the
    side that moved.  Each side computes on its own copy of the inputs and
    each JAX result is complete before the next computation starts: this
    is hygiene, not a repair (no side writes its inputs, so the memory that
    ``jnp.asarray`` and ``torch.from_numpy`` share with a numpy array
    cannot move a result)."""
    gates, c = _inputs(shape, F)
    before = lstm_gates.LAUNCHES
    got = {fn.__name__: fn(torch.from_numpy(gates.copy()), torch.from_numpy(c.copy()))
           for fn in (lstm_gates.lstm_gates_reference, lstm_gates.fused_lstm_gates)}
    want = {"xla": jax.block_until_ready(jax_reference(jnp.array(gates), jnp.array(c)))}
    want["pallas"] = jax.block_until_ready(
        jax_fused(jnp.array(gates), jnp.array(c), interpret=True))
    truth = _float64_gates(gates, c)
    for name, (h_got, c_got) in got.items():
        for oracle, (h_want, c_want) in want.items():
            for which, a, b, t in (("h", h_got, h_want, truth[0]), ("c", c_got, c_want, truth[1])):
                a, b = a.numpy(), np.asarray(b)
                far = {name: np.abs(a - t).max(), oracle: np.abs(b - t).max()}
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=0,
                                           err_msg=f"{which}: {name} against {oracle}; the "
                                                   f"largest distance from float64 {far}")
    assert lstm_gates.LAUNCHES == before  # CPU tensors never reach the kernel


@pytest.mark.parametrize("shape,F", [((2, 8, 8), 64), ((3, 11, 7), 64)])
def test_gates_gradient_matches_jax_vjp(shape, F):
    gates, c = _inputs(shape, F, seed=1)
    rng = np.random.default_rng(2)
    dh = rng.standard_normal(c.shape).astype(np.float32)
    dc = rng.standard_normal(c.shape).astype(np.float32)
    _, vjp = jax.vjp(jax_reference, jnp.asarray(gates), jnp.asarray(c))
    dg_want, dc_want = vjp((jnp.asarray(dh), jnp.asarray(dc)))

    g_t = torch.from_numpy(gates).requires_grad_()
    c_t = torch.from_numpy(c).requires_grad_()
    h_next, c_next = lstm_gates.fused_lstm_gates(g_t, c_t)
    torch.autograd.backward((h_next, c_next), (torch.from_numpy(dh), torch.from_numpy(dc)))
    np.testing.assert_allclose(g_t.grad.numpy(), np.asarray(dg_want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(c_t.grad.numpy(), np.asarray(dc_want), atol=1e-6, rtol=0)


def test_channel_axis_nchw_matches_channels_last():
    """dim=1 on NCHW is the same tail as dim=-1 on the channels-last view."""
    gates, c = _inputs((2, 5, 6), 16, seed=3)
    h_cl, c_cl = lstm_gates.fused_lstm_gates(torch.from_numpy(gates), torch.from_numpy(c))
    g_nchw = torch.from_numpy(gates).permute(0, 3, 1, 2).contiguous()
    c_nchw = torch.from_numpy(c).permute(0, 3, 1, 2).contiguous()
    h_n, c_n = lstm_gates.fused_lstm_gates(g_nchw, c_nchw, dim=1)
    torch.testing.assert_close(h_n.permute(0, 2, 3, 1), h_cl, atol=1e-6, rtol=0)
    torch.testing.assert_close(c_n.permute(0, 2, 3, 1), c_cl, atol=1e-6, rtol=0)


def test_gates_wrapper_rejects_what_the_kernel_does_not_take():
    g = torch.zeros(4, 4 * 8)
    c = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        lstm_gates._layout(g.double(), c.double(), -1)
    with pytest.raises(ValueError):
        lstm_gates._layout(torch.zeros(4, 3 * 8), c, -1)
    with pytest.raises(ValueError):
        lstm_gates._layout(torch.zeros(4 * 8, 4).t(), c, -1)
    assert lstm_gates._layout(torch.zeros(2, 4 * 8, 3, 5), torch.zeros(2, 8, 3, 5), 1) == (2, 8, 15)



@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("shape,F", SHAPES)
def test_backward_plain_version_matches_autograd_and_jax_vjp(shape, F, layout):
    gates, c = _inputs(shape, F, seed=4)
    rng = np.random.default_rng(5)
    dh = rng.standard_normal(c.shape).astype(np.float32)
    dc = rng.standard_normal(c.shape).astype(np.float32)
    _, vjp = jax.vjp(jax_reference, jnp.asarray(gates), jnp.asarray(c))
    dg_jax, dc_jax = (np.asarray(x) for x in vjp((jnp.asarray(dh), jnp.asarray(dc))))

    def to_layout(x):  # channels-last (..., C) → the port's NCHW (N, C, ...)
        t = torch.from_numpy(x)
        return t if layout == "channels_last" else t.movedim(-1, 1).contiguous()

    def from_layout(t):
        return (t if layout == "channels_last" else t.movedim(1, -1)).numpy()

    dim = -1 if layout == "channels_last" else 1
    g_t, c_t, dh_t, dc_t = (to_layout(x) for x in (gates, c, dh, dc))
    dg_got, dc_got = lstm_gates.lstm_gates_backward_reference(g_t, c_t, dh_t, dc_t, dim=dim)

    g_req, c_req = g_t.clone().requires_grad_(), c_t.clone().requires_grad_()
    torch.autograd.backward(lstm_gates.lstm_gates_reference(g_req, c_req, dim), (dh_t, dc_t))
    torch.testing.assert_close(dg_got, g_req.grad, atol=1e-6, rtol=0)
    torch.testing.assert_close(dc_got, c_req.grad, atol=1e-6, rtol=0)
    # XLA's and ATen's sigmoid/tanh round differently by an ulp, and the
    # backward amplifies it: 1 - tanh(g)^2 cancels as |tanh(g)| nears 1 (an
    # ulp of tanh is ~1.2e-7 of it) and is then scaled by |dct*i| up to ~5,
    # and |dgates| reaches ~4 (ulp 4.8e-7).  torch's own autograd differs
    # from jax.vjp by up to 1.1e-6 on these inputs, so against JAX: 2e-6.
    np.testing.assert_allclose(from_layout(dg_got), dg_jax, atol=2e-6, rtol=0)
    np.testing.assert_allclose(from_layout(dc_got), dc_jax, atol=2e-6, rtol=0)


def test_gradient_through_the_function_takes_strided_and_missing_grads():
    """On CPU tensors that need a gradient the wrapper runs the same
    ``autograd.Function`` as on the card, with the plain backward: grads of
    h' that arrive as strided views (the backward of ``stack``) and a c'
    that feeds nothing give autograd's gradients of the plain forward."""
    gates, c = _inputs((2, 5, 7), 8, seed=6)
    g_nchw = torch.from_numpy(gates).movedim(-1, 1).contiguous()
    c_nchw = torch.from_numpy(c).movedim(-1, 1).contiguous()
    weights = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 3, 8, 5, 7)).astype(np.float32))
    grads = []
    for fn in (lstm_gates.fused_lstm_gates, lstm_gates.lstm_gates_reference):
        g, cc = g_nchw.clone().requires_grad_(), c_nchw.clone().requires_grad_()
        h, _ = fn(g, cc, dim=1)
        assert (h.grad_fn is not None and "FusedGates" in type(h.grad_fn).__name__) == (
            fn is lstm_gates.fused_lstm_gates)
        (torch.stack([h, 2 * h, h * h], dim=1) * weights).sum().backward()
        grads.append((g.grad, cc.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------- the bias
def _bias(F, seed):
    return np.random.default_rng(seed).standard_normal(4 * F).astype(np.float32)


def _jax_biased(gates, c, bias):
    """The JAX tail on gates that carry the bias, as the JAX gate conv's are."""
    return jax_reference(gates + bias, c)


LAYOUTS = ["rows", "nchw", "channels_last"]


def _to_layout(x, layout):
    """A channels-last (N, H, W, C) array → the port's operand and its channel dim."""
    t = torch.from_numpy(x)
    if layout == "rows":
        return t.reshape(-1, t.shape[-1]), -1
    nchw = t.permute(0, 3, 1, 2)
    if layout == "nchw":
        return nchw.contiguous(), 1
    return nchw.contiguous(memory_format=torch.channels_last), 1


def _from_layout(t, layout, shape):
    return (t.reshape(shape) if layout == "rows" else t.permute(0, 2, 3, 1)).numpy()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape,F", [((2, 8, 8), 64), ((3, 11, 7), 64), ((1, 5, 6), 12)])
def test_gates_with_bias_match_jax_on_biased_gates(shape, F, layout):
    gates, c = _inputs(shape, F, seed=8)
    bias = _bias(F, seed=9)
    h_want, c_want = _jax_biased(jnp.asarray(gates), jnp.asarray(c), jnp.asarray(bias))
    g_t, dim = _to_layout(gates, layout)
    c_t, _ = _to_layout(c, layout)
    if layout == "channels_last":
        assert lstm_gates._layout(g_t, c_t, dim, torch.from_numpy(bias)) == (
            shape[0] * shape[1] * shape[2], F, 1)
    before = lstm_gates.LAUNCHES
    for fn in (lstm_gates.lstm_gates_reference, lstm_gates.fused_lstm_gates):
        h_got, c_got = fn(g_t, c_t, dim=dim, bias=torch.from_numpy(bias))
        assert h_got.shape == c_t.shape
        for got, want in ((h_got, h_want), (c_got, c_want)):
            np.testing.assert_allclose(_from_layout(got, layout, c.shape), np.asarray(want),
                                       atol=1e-6, rtol=0)
    assert lstm_gates.LAUNCHES == before


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gradient_with_bias_matches_jax_vjp(layout):
    """(d_gates, d_c, d_bias) through the wrapper's ``autograd.Function``
    against ``jax.vjp`` of the JAX tail on ``gates + bias``; 2e-6 as for the
    bias-free backward (1 - g² cancels where |tanh(g)| nears 1), and d_bias
    sums 3·11·7 of those elements."""
    shape, F = (3, 11, 7), 16
    gates, c = _inputs(shape, F, seed=10)
    bias = _bias(F, seed=11)
    rng = np.random.default_rng(12)
    dh = rng.standard_normal(c.shape).astype(np.float32)
    dc = rng.standard_normal(c.shape).astype(np.float32)
    _, vjp = jax.vjp(_jax_biased, jnp.asarray(gates), jnp.asarray(c), jnp.asarray(bias))
    dg_want, dc_want, db_want = (np.asarray(x) for x in vjp((jnp.asarray(dh), jnp.asarray(dc))))

    g_t, dim = _to_layout(gates, layout)
    c_t, _ = _to_layout(c, layout)
    g_t, c_t = g_t.clone().requires_grad_(), c_t.clone().requires_grad_()
    b_t = torch.from_numpy(bias).requires_grad_()
    h_next, c_next = lstm_gates.fused_lstm_gates(g_t, c_t, dim=dim, bias=b_t)
    assert "FusedGates" in type(h_next.grad_fn).__name__
    torch.autograd.backward((h_next, c_next), (_to_layout(dh, layout)[0],
                                               _to_layout(dc, layout)[0]))
    np.testing.assert_allclose(_from_layout(g_t.grad, layout, gates.shape), dg_want,
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(_from_layout(c_t.grad, layout, c.shape), dc_want, atol=2e-6, rtol=0)
    np.testing.assert_allclose(b_t.grad.numpy(), db_want, atol=2e-5, rtol=0)


def test_bias_gradient_flows_when_only_the_bias_needs_it():
    gates, c = _inputs((2, 3, 4), 8, seed=13)
    b = torch.from_numpy(_bias(8, seed=14)).requires_grad_()
    h, c_next = lstm_gates.fused_lstm_gates(torch.from_numpy(gates), torch.from_numpy(c), bias=b)
    (h.sum() + c_next.sum()).backward()
    b_ref = b.detach().clone().requires_grad_()
    h, c_next = lstm_gates.lstm_gates_reference(torch.from_numpy(gates), torch.from_numpy(c),
                                                bias=b_ref)
    (h.sum() + c_next.sum()).backward()
    torch.testing.assert_close(b.grad, b_ref.grad, atol=1e-5, rtol=0)


def test_layout_takes_channels_last_and_refuses_other_strides():
    g = torch.zeros(2, 32, 3, 5).contiguous(memory_format=torch.channels_last)
    c = torch.zeros(2, 8, 3, 5).contiguous(memory_format=torch.channels_last)
    assert lstm_gates._layout(g, c, 1) == (30, 8, 1)
    assert lstm_gates._layout(g, c, -3) == (30, 8, 1)
    with pytest.raises(ValueError):  # channels-last gates beside an NCHW c
        lstm_gates._layout(g, c.contiguous(), 1)
    with pytest.raises(ValueError):  # the channel axis is not dim 1
        lstm_gates._layout(torch.zeros(2, 8, 3, 20).contiguous(memory_format=torch.channels_last),
                           torch.zeros(2, 8, 3, 5).contiguous(memory_format=torch.channels_last), 3)
    with pytest.raises(ValueError):  # a strided slice
        lstm_gates._layout(torch.zeros(2, 64, 3, 5)[:, ::2], c.contiguous(), 1)
    with pytest.raises(ValueError):  # a bias of the wrong length
        lstm_gates._layout(g, c, 1, torch.zeros(31))
    with pytest.raises(ValueError):  # a bias of another dtype
        lstm_gates._layout(g, c, 1, torch.zeros(32, dtype=torch.bfloat16))
    assert lstm_gates._layout(g, c, 1, torch.zeros(32)) == (30, 8, 1)
