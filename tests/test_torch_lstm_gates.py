"""The PyTorch port's ConvLSTM gate tail against the JAX package's.

On CPU tensors the port's wrapper runs its plain version; both are held
against the JAX oracle and the Pallas kernel in interpret mode, forward and
backward, at fp32 atol 1e-6 (the shapes of ``test_pallas_kernels.py``).  The
CUDA kernel itself is checked on the card by ``chip_smoke.py`` and by
``test_torch_cuda.py``.
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


@pytest.mark.parametrize("shape,F", SHAPES)
def test_gates_match_jax(shape, F):
    gates, c = _inputs(shape, F)
    h_want, c_want = jax_reference(jnp.asarray(gates), jnp.asarray(c))
    h_pallas, c_pallas = jax_fused(jnp.asarray(gates), jnp.asarray(c), interpret=True)
    before = lstm_gates.LAUNCHES
    for fn in (lstm_gates.lstm_gates_reference, lstm_gates.fused_lstm_gates):
        h_got, c_got = fn(torch.from_numpy(gates), torch.from_numpy(c))
        for got, want in ((h_got, h_want), (c_got, c_want), (h_got, h_pallas), (c_got, c_pallas)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
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

