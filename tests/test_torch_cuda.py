"""The port's CUDA kernels on the card, against their plain versions: the
gate tail forward and backward, with and without the gate conv's bias, on
each of their paths (16-byte vectors over rows, channels-last or NCHW
planes; one element a vector for other widths and unaligned pointers), a
small net's forward, and one training step through the kernels against one
through the plain gate tail.

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
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.losses import (
    L1Loss,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
    lstm_gates,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.trainers import (
    VSRRefineNetTrainer,
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


@pytest.mark.parametrize("shape,dim", [((16, 256, 32, 32), 1), ((3 * 11 * 7, 256), -1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_backward_kernel_matches_plain_version(cuda, dtype, shape, dim):
    # fp32: an ulp or two of values up to ~5; bf16: the kernel rounds its
    # fp32 result once, held against the fp32 plain version on the same
    # (upcast) inputs, relative to max(1, |value|)
    gen = torch.Generator(device=cuda).manual_seed(1)
    c_shape = list(shape)
    c_shape[dim] //= 4
    g = (torch.randn(shape, device=cuda, generator=gen) * 2).to(dtype)
    c, dh, dc = ((torch.randn(c_shape, device=cuda, generator=gen) * s).to(dtype)
                 for s in (0.5, 1.0, 1.0))
    before = lstm_gates.BWD_LAUNCHES
    dg_got, dc_got = lstm_gates._launch_bwd(g, c, dh, dc, dim)
    torch.cuda.synchronize()
    assert lstm_gates.BWD_LAUNCHES == before + 1
    assert dg_got.dtype == dtype and dg_got.shape == g.shape and dc_got.shape == c.shape
    dg_want, dc_want = lstm_gates.lstm_gates_backward_reference(
        g.float(), c.float(), dh.float(), dc.float(), dim=dim)
    for got, want in ((dg_got, dg_want), (dc_got, dc_want)):
        err = (got.float() - want).abs()
        if dtype == torch.float32:
            assert err.max().item() <= 2e-6
        else:
            assert (err / want.abs().clamp_min(1)).max().item() <= 1e-2


def test_gate_backward_takes_strided_and_missing_gradients(cuda):
    """The grads of h' arrive as strided views (the backward of stack) and
    the grad of c' is materialised as zeros when c' feeds nothing."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    g = torch.randn(2, 32, 5, 7, device=cuda, generator=gen).requires_grad_()
    c = torch.randn(2, 8, 5, 7, device=cuda, generator=gen).requires_grad_()
    weights = torch.randn(2, 3, 8, 5, 7, device=cuda, generator=gen)
    grads = []
    for fn in (lstm_gates.fused_lstm_gates, lstm_gates.lstm_gates_reference):
        h, _ = fn(g, c, dim=1)
        (torch.stack([h, 2 * h, h * h], dim=1) * weights).sum().backward()
        grads.append((g.grad.clone(), c.grad.clone()))
        g.grad = c.grad = None
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


def test_training_step_through_the_kernels_matches_the_plain_tail(cuda):
    kwargs = dict(in_channels=1, out_channels=1, num_features=[8, 8], num_stages=2,
                  refine_window_size=5, upscale_factor=4, update_memory=True,
                  num_updated_frames=3, positional_encoding=True)
    net = RefineNet(**kwargs)
    trainer = VSRRefineNetTrainer(device=cuda, net=net, loss_fns=[L1Loss()], num_epochs=1)
    gen = torch.Generator().manual_seed(3)
    batch = {"lr_imgs": torch.randn(2, 11, 8, 8, 1, generator=gen).numpy(),
             "hr_imgs": torch.randn(2, 5, 32, 32, 1, generator=gen).numpy(),
             "pos_code": (torch.rand(2, 11, 1, generator=gen) * 2 - 1).numpy()}
    results = []
    for tail in (lstm_gates.fused_lstm_gates, lstm_gates.lstm_gates_reference):
        set_gate_tail(net, tail)
        net.zero_grad(set_to_none=True)
        fwd, bwd = lstm_gates.LAUNCHES, lstm_gates.BWD_LAUNCHES
        total, *_ = trainer._forward(batch, True)
        total.backward()
        results.append((total.item(), {n: p.grad.clone() for n, p in net.named_parameters()
                                       if p.grad is not None},
                        lstm_gates.LAUNCHES - fwd, lstm_gates.BWD_LAUNCHES - bwd))
    (loss_k, grads_k, fwd_k, bwd_k), (loss_p, grads_p, fwd_p, bwd_p) = results
    assert (fwd_k, bwd_k, fwd_p, bwd_p) == (2 * 2 * 11 * 2, 2 * 2 * 5 * 2, 0, 0)
    assert grads_k.keys() == grads_p.keys()
    assert abs(loss_k - loss_p) <= 1e-6 * abs(loss_p)
    for name, g in grads_p.items():
        assert (grads_k[name] - g).abs().max().item() <= 1e-4 * g.abs().max().item(), name


def test_bf16_remat_training_step_through_the_kernels(cuda):
    """``compute_dtype: bfloat16`` with ``remat``: the bf16 gate kernels run
    forward and backward, the core steps rerun in the backward (the saved
    (gates, c) pass through checkpoint's saved-tensor hooks), and the fp32
    masters get fp32 gradients.  Held against the same step without remat
    (1e-3 of each gradient's maximum: the same values, summed in another
    order by cuDNN's wgrad) and through the plain gate tail (ATen rounds to
    bf16 after every op, the kernel once: 1e-2 on the loss, 5e-2 of each
    gradient's maximum)."""
    kwargs = dict(in_channels=1, out_channels=1, num_features=[8, 8], num_stages=2,
                  refine_window_size=5, upscale_factor=4, update_memory=True,
                  num_updated_frames=3, positional_encoding=True)
    gen = torch.Generator().manual_seed(4)
    batch = {"lr_imgs": torch.randn(2, 11, 8, 8, 1, generator=gen).numpy(),
             "hr_imgs": torch.randn(2, 5, 32, 32, 1, generator=gen).numpy(),
             "pos_code": (torch.rand(2, 11, 1, generator=gen) * 2 - 1).numpy()}
    results = []
    for remat, tail in ((True, lstm_gates.fused_lstm_gates), (False, lstm_gates.fused_lstm_gates),
                        (True, lstm_gates.lstm_gates_reference)):
        net = RefineNet(**kwargs, remat=remat)  # the same seeded weights each time
        set_gate_tail(net, tail)
        trainer = VSRRefineNetTrainer(device=cuda, net=net, loss_fns=[L1Loss()], num_epochs=1,
                                      compute_dtype="bfloat16")
        before = (lstm_gates.LAUNCHES, lstm_gates.BWD_LAUNCHES, lstm_gates.BF16_LAUNCHES,
                  lstm_gates.BF16_BWD_LAUNCHES)
        total, *_ = trainer._forward(batch, True)
        total.backward()
        after = (lstm_gates.LAUNCHES, lstm_gates.BWD_LAUNCHES, lstm_gates.BF16_LAUNCHES,
                 lstm_gates.BF16_BWD_LAUNCHES)
        grads = {n: p.grad for n, p in net.named_parameters() if p.grad is not None}
        assert all(p.dtype == torch.float32 for p in net.parameters())
        assert all(g.dtype == torch.float32 for g in grads.values())
        results.append((total.item(), grads, tuple(a - b for a, b in zip(after, before))))
    (loss_r, grads_r, n_r), (loss_n, grads_n, n_n), (loss_p, grads_p, n_p) = results
    layer_steps = 2 * 2 * 2  # layers × directions × stages
    fwd, bwd = layer_steps * (11 + 5), layer_steps * 5  # the 5 core frames rerun
    assert n_r == (fwd, bwd, fwd, bwd)
    assert n_n == (layer_steps * 11, bwd, layer_steps * 11, bwd)
    assert n_p == (0, 0, 0, 0)
    assert grads_r.keys() == grads_n.keys() == grads_p.keys()
    assert loss_r == loss_n
    assert abs(loss_r - loss_p) <= 1e-2 * abs(loss_p)
    for name, g in grads_r.items():
        scale = g.abs().max().item()
        assert (grads_n[name] - g).abs().max().item() <= 1e-3 * scale, name
        assert (grads_p[name] - g).abs().max().item() <= 5e-2 * scale, name


# The kernels' paths: (c's shape, layout, path).  "vector" moves 16 bytes a
# load along the contiguous axis (F in rows and channels-last, H*W in NCHW);
# "scalar" one element, for widths that are not a multiple of the vector
# (8 bf16, 4 fp32) and for base pointers that are not 16-byte aligned.
PATH_CASES = {
    "rows_eval": ((4096, 64), "rows", "vector"),
    "rows_3x11x7": ((3 * 11 * 7, 64), "rows", "vector"),
    "rows_F10": ((3 * 11 * 7, 10), "rows", "scalar"),
    "nchw_eval": ((1, 64, 64, 64), "nchw", "vector"),
    "nchw_train": ((16, 64, 32, 32), "nchw", "vector"),
    "nchw_11x7": ((2, 64, 11, 7), "nchw", "scalar"),
    "channels_last_eval": ((1, 64, 64, 64), "channels_last", "vector"),
    "channels_last_train": ((16, 64, 32, 32), "channels_last", "vector"),
    "channels_last_F10": ((3, 10, 11, 7), "channels_last", "scalar"),
    "offset_by_one": ((3 * 11 * 7, 64), "offset", "scalar"),
}


def _operand(shape, layout, dev, gen, scale, dtype):
    """A random tensor of ``shape`` (channel axis 1, or last for rows) in ``layout``."""
    if layout == "offset":  # one element past an aligned allocation
        n = 1
        for s in shape:
            n *= s
        buf = torch.randn(n + 1, device=dev, generator=gen) * scale
        return buf.to(dtype)[1:].view(shape)
    t = (torch.randn(shape, device=dev, generator=gen) * scale).to(dtype)
    return t.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else t


def _path_operands(case, dtype, dev, with_bias, seed):
    shape, layout, path = PATH_CASES[case]
    dim = -1 if layout in ("rows", "offset") else 1
    g_shape = list(shape)
    g_shape[dim] *= 4
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = _operand(g_shape, layout, dev, gen, 2.0, dtype)
    c, dh, dc = (_operand(shape, layout, dev, gen, s, dtype) for s in (0.5, 1.0, 1.0))
    bias = (torch.randn(g_shape[dim], device=dev, generator=gen) * 0.5).to(dtype) if with_bias else None
    width = 16 // g.element_size() if path == "vector" else 1
    assert lstm_gates.vector_width(g, c, dh, dc, dim=dim) == width
    return g, c, dh, dc, bias, dim


def _upcast(*ts):
    return [None if t is None else t.float() for t in ts]


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(PATH_CASES))
def test_gate_kernels_on_every_path_match_plain_versions(cuda, case, dtype, with_bias):
    """Forward and backward kernel on the path the case names, against the
    fp32 plain versions on the same (upcast) inputs: fp32 2e-6 absolute;
    bf16 1e-2 absolute forward (|c'| < 4: half a bf16 ulp is below it) and
    1e-2 of max(1, |value|) backward."""
    g, c, dh, dc, bias, dim = _path_operands(case, dtype, cuda, with_bias, seed=5)
    fwd, bwd = lstm_gates.LAUNCHES, lstm_gates.BWD_LAUNCHES
    h_got, c_got = lstm_gates.fused_lstm_gates(g, c, dim=dim, bias=bias)
    dg_got, dc_got = lstm_gates._launch_bwd(g, c, dh, dc, dim, bias)
    torch.cuda.synchronize()
    assert (lstm_gates.LAUNCHES - fwd, lstm_gates.BWD_LAUNCHES - bwd) == (1, 1)
    assert h_got.stride() == c.stride() and dg_got.stride() == g.stride()
    gf, cf, dhf, dcf, bf = _upcast(g, c, dh, dc, bias)
    h_want, c_want = lstm_gates.lstm_gates_reference(gf, cf, dim, bf)
    dg_want, dc_want = lstm_gates.lstm_gates_backward_reference(gf, cf, dhf, dcf, dim, bf)
    tol = 2e-6 if dtype == torch.float32 else 1e-2
    for got, want in ((h_got, h_want), (c_got, c_want)):
        assert (got.float() - want).abs().max().item() <= tol
    for got, want in ((dg_got, dg_want), (dc_got, dc_want)):
        err = (got.float() - want).abs()
        if dtype == torch.bfloat16:
            err = err / want.abs().clamp_min(1)
        assert err.max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_function_with_bias_matches_plain_autograd(cuda, dtype):
    """Through the ``autograd.Function`` in the recurrence's channels-last
    layout: d_gates, d_c and d_bias (the kernel's d_gates summed over N, H,
    W) against autograd of the plain version, from strided grads of h'."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    g = (torch.randn(2, 256, 12, 9, device=cuda, generator=gen) * 2).to(dtype)
    g = g.contiguous(memory_format=torch.channels_last)
    c = torch.randn(2, 64, 12, 9, device=cuda, generator=gen).to(dtype)
    c = c.contiguous(memory_format=torch.channels_last)
    b = (torch.randn(256, device=cuda, generator=gen) * 0.5).to(dtype)
    weights = torch.randn(2, 3, 64, 12, 9, device=cuda, generator=gen)
    grads = []
    for fn, cast in ((lstm_gates.fused_lstm_gates, dtype), (lstm_gates.lstm_gates_reference,
                                                            torch.float32)):
        leaves = [t.to(cast).detach().requires_grad_() for t in (g, c, b)]
        h, _ = fn(leaves[0], leaves[1], dim=1, bias=leaves[2])
        (torch.stack([h, 2 * h, h * h], dim=1).float() * weights).sum().backward()
        grads.append([t.grad.float() for t in leaves])
    for got, want in zip(*grads):
        scale = 1.0 if dtype == torch.float32 else want.abs().max().item()
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        assert (got - want).abs().max().item() <= tol * scale


def test_gate_kernel_raises_on_layouts_it_does_not_take(cuda):
    g = torch.zeros(2, 32, 3, 5, device=cuda).contiguous(memory_format=torch.channels_last)
    c = torch.zeros(2, 8, 3, 5, device=cuda)
    with pytest.raises(ValueError):  # channels-last gates beside an NCHW c
        lstm_gates.fused_lstm_gates(g, c, dim=1)
    with pytest.raises(ValueError):  # a bias of another dtype
        lstm_gates.fused_lstm_gates(g, c.contiguous(memory_format=torch.channels_last), dim=1,
                                    bias=torch.zeros(32, device=cuda, dtype=torch.bfloat16))
