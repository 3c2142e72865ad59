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


def test_gate_conv_runs_without_its_bias_and_the_tail_adds_it(monkeypatch):
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
        refine_net,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
        lstm_gates,
    )

    _, _, net = _pair(1, True, True)
    gate_weights = {id(cell.conv.weight) for cell in net.modules()
                    if isinstance(cell, refine_net.ConvLSTMCell)}
    biases = {id(cell.conv.bias) for cell in net.modules()
              if isinstance(cell, refine_net.ConvLSTMCell)}
    conv_biases, tail_biases = [], []
    conv2d = torch.nn.functional.conv2d

    def spy_conv(x, weight, bias=None, *args, **kwargs):
        if weight.shape[0] == 4 * 8 and weight.shape[1] == 2 * 8:  # a gate conv
            conv_biases.append(bias)
        return conv2d(x, weight, bias, *args, **kwargs)

    def spy_tail(gates, c, dim=-1, bias=None):
        tail_biases.append(id(bias))
        return lstm_gates.lstm_gates_reference(gates, c, dim, bias)

    monkeypatch.setattr(refine_net.F, "conv2d", spy_conv)
    refine_net.set_gate_tail(net, spy_tail)
    lr, pos = _inputs(1)
    with torch.inference_mode():
        net(torch.from_numpy(lr), torch.from_numpy(pos))
    assert len(gate_weights) == len(biases) == 4  # 2 layers × 2 directions
    layer_steps = 2 * 2 * 2 * (TC + 2)  # layers × directions × stages × frames
    assert conv_biases == [None] * layer_steps
    assert len(tail_biases) == layer_steps and set(tail_biases) == biases


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_recurrence_runs_in_the_chosen_layout(dtype):
    """Every gate tail sees gates, c and its bias in the layout
    ``recurrence_format`` names for the compute dtype (channels-last for
    bf16, NCHW for fp32), and the ConvLSTM still hands back contiguous
    (B, T, F, H, W) states."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
        refine_net,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
        lstm_gates,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.casting import (
        forward_in,
    )

    _, _, net = _pair(1, True, True)
    fmt = refine_net.recurrence_format(dtype)
    seen = []

    def spy_tail(gates, c, dim=-1, bias=None):
        seen.append((gates.dtype, gates.is_contiguous(memory_format=fmt),
                     c.is_contiguous(memory_format=fmt), bias.dtype))
        return lstm_gates.lstm_gates_reference(gates, c, dim, bias)

    refine_net.set_gate_tail(net, spy_tail)
    states = []
    net.forward_lstm_block.register_forward_hook(lambda m, a, out: states.append(out))
    lr, pos = _inputs(1)
    with torch.inference_mode():
        forward_in(net, None if dtype == torch.float32 else dtype, torch.from_numpy(lr),
                   torch.from_numpy(pos))
    assert seen and set(seen) == {(dtype, True, True, dtype)}
    # bf16 in cuDNN's tensor-core layout; fp32 in NCHW, where cuDNN's fp32
    # convs need no transposes (PERF.md: tools/profile_layout.py on the card)
    assert fmt == (torch.contiguous_format if dtype == torch.float32 else torch.channels_last)
    assert [tuple(s.shape) for s in states] == [(B, TC + 2, 8, H, W)] * 2
    assert all(s.is_contiguous() for s in states)
