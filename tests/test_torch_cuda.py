"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip where there is no card.  This file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch (the repo-root ``conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models.refine_net import (
    RefineNet,
    set_gate_tail,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
    lstm_gates,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,dim", [((1, 256, 64, 64), 1), ((3 * 11 * 7, 256), -1)])
def test_gate_kernel_matches_plain_version(cuda, dtype, tol, shape, dim):
    # bf16: the kernel computes in fp32 and rounds once, so it is held
    # against the fp32 plain version on the same (upcast) inputs; with
    # |c'| < 4 half a bf16 ulp is below 1e-2
    gen = torch.Generator(device=cuda).manual_seed(0)
    c_shape = list(shape)
    c_shape[dim] //= 4
    g = (torch.randn(shape, device=cuda, generator=gen) * 2).to(dtype)
    c = (torch.randn(c_shape, device=cuda, generator=gen) * 0.5).to(dtype)
    before = lstm_gates.LAUNCHES
    h_got, c_got = lstm_gates.fused_lstm_gates(g, c, dim=dim)
    torch.cuda.synchronize()
    assert lstm_gates.LAUNCHES == before + 1
    assert h_got.dtype == dtype and h_got.shape == c.shape
    h_want, c_want = lstm_gates.lstm_gates_reference(g.float(), c.float(), dim=dim)
    assert (h_got.float() - h_want).abs().max().item() <= tol
    assert (c_got.float() - c_want).abs().max().item() <= tol


def test_gate_kernel_raises_on_what_it_does_not_take(cuda):
    g = torch.zeros(4, 32, device=cuda)
    with pytest.raises(TypeError):
        lstm_gates.fused_lstm_gates(g.half(), torch.zeros(4, 8, device=cuda).half())
    with pytest.raises(ValueError):
        lstm_gates.fused_lstm_gates(g, torch.zeros(4, 8))  # c on the CPU
    with pytest.raises(ValueError):
        lstm_gates.fused_lstm_gates(torch.zeros(32, 4, device=cuda).t(), torch.zeros(4, 8, device=cuda))


def test_small_net_on_the_card_matches_the_cpu(cuda):
    kwargs = dict(in_channels=1, out_channels=1, num_features=[8, 8], num_stages=2,
                  refine_window_size=5, upscale_factor=4, update_memory=True,
                  num_updated_frames=3, positional_encoding=True)
    net = RefineNet(**kwargs).eval()
    gen = torch.Generator().manual_seed(1)
    lr = torch.randn(2, 11, 8, 8, 1, generator=gen)
    pos = torch.rand(2, 11, 1, generator=gen) * 2 - 1
    with torch.inference_mode():
        want = net(lr, pos)
        net.to(cuda)
        before = lstm_gates.LAUNCHES
        got = net(lr.to(cuda), pos.to(cuda))
        launches = lstm_gates.LAUNCHES - before
        set_gate_tail(net, lstm_gates.lstm_gates_reference)
        plain = net(lr.to(cuda), pos.to(cuda))
    assert launches == 2 * 2 * 11 * 2  # layers × directions × frames × stages
    for g, p, w in zip(got, plain, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(g, p, atol=1e-5, rtol=1e-4)
