"""The PyTorch port's RefineNet against the JAX package's, on the CPU.

The JAX net is initialised from ``PRNGKey(0)``; its weights are carried into
the port by ``utils/jax_weights.state_dict_from_jax_params`` (loaded with
``strict=True``).  Every one of the 3·num_stages outputs must match at the
tolerance of ``test_refine_net_parity.py`` (atol 5e-5, rtol 1e-4), for
U ∈ {0, 1, 3} (below, at and above window//2 = 2, so the edge-replicated
fused maps are covered), with the phase code and ``memory`` each on and off.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.models import (
    RefineNet as JaxRefineNet,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
    RefineNet,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)

B, TC, H, W = 2, 5, 8, 8


def _cfg(U, pe, memory):
    return dict(
        in_channels=1, out_channels=1, num_features=[8, 8], num_stages=2,
        refine_window_size=5, upscale_factor=4, update_memory=U > 0,
        num_updated_frames=U, memory=memory, positional_encoding=pe,
    )


def _inputs(U, seed=7):
    rng = np.random.default_rng(seed)
    T = TC + 2 * U
    lr = rng.standard_normal((B, T, H, W, 1)).astype(np.float32)
    pos = rng.uniform(-1, 1, (B, T, 1)).astype(np.float32)
    return lr, pos


@functools.lru_cache(maxsize=None)
def _jax_params(pe, memory):
    """The weights do not depend on U: one init per (phase code, memory)."""
    lr, pos = _inputs(0)
    params = JaxRefineNet(**_cfg(0, pe, memory)).init(jax.random.PRNGKey(0), lr, pos)
    return jax.tree.map(np.asarray, params)


def _pair(U, pe, memory):
    jax_net = JaxRefineNet(**_cfg(U, pe, memory))
    params = _jax_params(pe, memory)
    net = RefineNet(**_cfg(U, pe, memory))
    net.load_state_dict(state_dict_from_jax_params(params["params"]), strict=True)
    return jax_net, params, net


@pytest.mark.parametrize("memory", [True, False], ids=["memory", "no_memory"])
@pytest.mark.parametrize("pe", [True, False], ids=["pe", "no_pe"])
@pytest.mark.parametrize("U", [0, 1, 3])
def test_all_branches_match_jax(U, pe, memory):
    jax_net, params, net = _pair(U, pe, memory)
    lr, pos = _inputs(U)
    want = jax.jit(jax_net.apply)(params, lr, pos)
    with torch.inference_mode():
        got = net(torch.from_numpy(lr), torch.from_numpy(pos))
    assert len(got) == len(want) == 3 * 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape == (B, TC, 4 * H, 4 * W, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5, rtol=1e-4,
                                   err_msg=f"branch {i}")


def test_input_gradient_of_fused_output_matches_jax():
    """d(sum of the final fused output)/d(lr): the warm-up frames' gradient
    cuts (``.detach()`` where JAX has ``stop_gradient``) must agree."""
    U = 3
    jax_net, params, net = _pair(U, True, True)
    lr, pos = _inputs(U, seed=11)

    def fused_sum(x):
        return jnp.sum(jax_net.apply(params, x, pos)[-1])

    want = np.asarray(jax.grad(fused_sum)(jnp.asarray(lr)))
    x = torch.from_numpy(lr).requires_grad_()
    net(x, torch.from_numpy(pos))[-1].sum().backward()
    got = x.grad.numpy()
    # warm-up frames carry no gradient in either framework
    assert np.all(want[:, :U] == 0) and np.all(want[:, -U:] == 0)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


def test_state_dict_keys_are_the_reference_keys():
    net = RefineNet(**_cfg(3, True, True))
    keys = set(net.state_dict())
    assert "refine_block.prelu.weight" in keys  # dead parameter (quirk 3)
    assert "forward_lstm_block.cell_list.1.conv.weight" in keys
    assert {"refine_block.body.conv1.weight", "refine_block.body.conv2.weight"} <= keys
    assert {f"out_block.conv{i}.bias" for i in (1, 2, 3)} <= keys
    # window conv keeps the reference's 2D layout (out, window·C, ks, ks)
    assert tuple(net.refine_block.body["conv1"].weight.shape) == (17, 5 * 17, 3, 3)


def test_init_is_drawn_from_the_generator_only():
    torch.manual_seed(123)
    a = RefineNet(**_cfg(0, True, True), generator=torch.Generator().manual_seed(5))
    torch.manual_seed(456)
    b = RefineNet(**_cfg(0, True, True), generator=torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, atol=0, rtol=0, msg=k)
