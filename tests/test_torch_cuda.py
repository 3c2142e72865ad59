"""The port's CUDA kernels on the card, against their plain versions: the
gate tail forward and backward, with and without the gate conv's bias, on
each of their paths (16-byte vectors over rows, channels-last or NCHW
planes; one element a vector for other widths and unaligned pointers), a
small net's forward, one training step through the kernels against one
through the plain gate tail, and the single-image, multi-frame and plain
video nets (no hand-written kernel) on the card against the CPU; the
deformable conv's three kernels (im2col, col2im, col2im_coord) against
their plain versions, fp32 and bf16, at zero, fractional and out-of-window
offsets, col2im_coord's bits repeated across calls, what they refuse, and a
small EDVR on the card against the CPU.

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


@pytest.mark.parametrize("name,kwargs", [
    ("EDSRNet", dict(in_channels=1, out_channels=1, num_resblocks=2, num_features=16)),
    ("SRFBNet", dict(in_channels=1, out_channels=1, num_steps=2, num_features=8, num_groups=2)),
    ("DRFSISRNet", dict(in_channels=1, out_channels=1, num_steps=2, num_features=8,
                        num_groups=2)),
    ("Bicubic", {}),
])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_single_image_nets_on_the_card_match_the_cpu(cuda, name, kwargs, r):
    """The single-image nets run no hand-written kernel: cuDNN's convs and
    transposed convs, and the dense resize products, in fp32 without TF32,
    against the CPU within 1e-4 of the largest value; no gate launch."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models

    net = getattr(models, name)(upscale_factor=r, **kwargs,
                                generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 16, 1, generator=torch.Generator().manual_seed(1))
    before = lstm_gates.LAUNCHES
    with torch.inference_mode():
        want = net(x)
        got = net.to(cuda)(x.to(cuda))
    torch.cuda.synchronize()
    assert lstm_gates.LAUNCHES == before
    for g, w in zip(got if isinstance(got, list) else [got], want if isinstance(want, list) else [want]):
        assert g.shape == w.shape == (2, 16 * r, 16 * r, 1)
        assert ((g.cpu() - w).abs().max() / w.abs().max()).item() <= 1e-4


@pytest.mark.parametrize("name,kwargs,T", [
    ("DUFNet", dict(in_channels=1, out_channels=1, num_frames=7, size_filter=5,
                    backbone="_DenseLayer16"), 7),
    ("RBPNet", dict(in_channels=1, out_channels=1, base_filter=16, feat=8, num_stages=3,
                    num_resblocks=2, num_frames=5), 5),
    ("TOFlowNet", dict(in_channels=1, out_channels=1, num_frames=3), 3),
    ("TOFlowNet", dict(in_channels=1, out_channels=1, num_frames=3, max_flow=4), 3),
])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_misr_nets_on_the_card_match_the_cpu(cuda, name, kwargs, T, train):
    """The multi-frame nets run no hand-written kernel: cuDNN's 2D and 3D
    convs, transposed convs, ``grid_sample`` or the windowed warp, and the
    resize products, in fp32 without TF32, one window on the card against
    the CPU within 1e-4 of the largest value, the running statistics of a
    training-mode forward too; no gate launch."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models

    net = getattr(models, name)(upscale_factor=4, **kwargs,
                                generator=torch.Generator().manual_seed(0)).train(train)
    card = getattr(models, name)(upscale_factor=4, **kwargs).train(train)
    card.load_state_dict(net.state_dict())
    x = torch.randn(2, T, 12, 12, 1, generator=torch.Generator().manual_seed(1))
    before = lstm_gates.LAUNCHES
    with torch.no_grad():
        want = net(x)
        got = card.to(cuda)(x.to(cuda))
    torch.cuda.synchronize()
    assert lstm_gates.LAUNCHES == before
    assert got.shape == want.shape == (2, 48, 48, 1)
    assert ((got.cpu() - want).abs().max() / want.abs().max()).item() <= 1e-4
    if train:  # the running statistics moved alike (eval leaves them at their init)
        for key, value in net.state_dict().items():
            if "running" in key:
                on_card = card.state_dict()[key].cpu()
                assert ((on_card - value).abs().max() / value.abs().max()).item() <= 1e-4, key


@pytest.mark.parametrize("name,kwargs", [
    ("DRFNet", dict(in_channels=1, out_channels=1, num_features=8, num_groups=2)),
    ("FRVSRNet", dict(in_channels=1, out_channels=1, num_resblocks=2)),
    ("FRVSRNet", dict(in_channels=1, out_channels=1, num_resblocks=2, max_flow=4)),
], ids=["DRFNet", "FRVSRNet", "FRVSRNet-max_flow4"])
def test_vsr_nets_on_the_card_match_the_cpu(cuda, name, kwargs):
    """The plain video nets run no hand-written kernel: cuDNN's convs and
    transposed convs, the resize products and the STN warp (``grid_sample``
    or the windowed sum), in fp32 without TF32, a 4-frame clip of 10×12
    frames (FNet pads to /8) on the card against the CPU within 1e-4 of the
    largest value, both FRVSR heads; no gate launch."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models

    net = getattr(models, name)(upscale_factor=4, **kwargs,
                                generator=torch.Generator().manual_seed(0))
    card = getattr(models, name)(upscale_factor=4, **kwargs)
    card.load_state_dict(net.state_dict())
    x = torch.randn(2, 4, 10, 12, 1, generator=torch.Generator().manual_seed(1))
    before = lstm_gates.LAUNCHES
    with torch.inference_mode():
        want = net(x)
        got = card.to(cuda)(x.to(cuda))
    torch.cuda.synchronize()
    assert lstm_gates.LAUNCHES == before
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert got[0].shape == want[0].shape == (2, 4, 40, 48, 1)
    for g, w in zip(got, want):
        assert ((g.cpu() - w).abs().max() / w.abs().max()).item() <= 1e-4


# ------------------------------------------------------- deformable conv
def _dcn_operands(dev, dtype, offsets, B=2, C=16, H=13, W=11, dg=4, seed=0):
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
        deform_conv as dcn,
    )

    gen = torch.Generator().manual_seed(seed)
    g = dcn.geometry((B, C, H, W), 3, 3, 1, 1, 1, dg, 2 if offsets == "beyond" else None)
    shape = (B, dg * 18, g.Ho, g.Wo)
    if offsets == "zero":
        off = torch.zeros(shape)
    elif offsets == "fractional":  # reaches outside the image from the border taps
        off = (torch.rand(shape, generator=gen) * 2 - 1) * 3.5
    elif offsets == "wide":  # corners far from their output position
        off = (torch.rand(shape, generator=gen) * 2 - 1) * 12
    else:  # |o| in (R, R + 2]: corners dropped, many samples wholly out of the window
        off = (2 + 2 * torch.rand(shape, generator=gen)) * torch.sign(torch.randn(shape, generator=gen))
    x = torch.randn(B, C, H, W, generator=gen)
    mask = torch.rand(B, dg * 9, g.Ho, g.Wo, generator=gen)
    w = torch.randn(8, C, 3, 3, generator=gen) * 0.2
    b = torch.randn(8, generator=gen)
    cot = torch.randn(B, 8, g.Ho, g.Wo, generator=gen)
    cast = lambda t: t.to(dev, dtype)  # noqa: E731
    return dcn, g, [cast(x), off.to(dev), cast(mask), cast(w), cast(b)], cot.to(dev)


@pytest.mark.parametrize("channels,dg", [(16, 4), (32, 2), (64, 2), (12, 2)],
                         ids=["4_a_group", "16_a_group", "32_a_group", "6_a_group"])
@pytest.mark.parametrize("offsets", ["zero", "fractional", "wide", "beyond"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_dcn_kernels_match_plain_versions(cuda, dtype, tol, offsets, channels, dg):
    """The three kernels (im2col, col2im, col2im_coord) through the autograd
    function against the plain version under autograd on the same inputs
    upcast to fp32: the output and the gradients in x, offset, mask, weight
    and bias, each relative to its largest element (bf16: the kernels round
    col and the operands once; the plain version runs in fp32).  Groups of
    4, 16, 32 and 6 channels take the kernels' 16-byte and scalar paths;
    at 32, col2im_coord's block walks two chunks of 16 channels."""
    dcn, g, ops, cot = _dcn_operands(cuda, dtype, offsets, C=channels, dg=dg)
    R = None if g.R < 0 else g.R
    kwargs = dict(padding=1, deformable_groups=g.dg, max_offset=R)
    leaves = [t.clone().requires_grad_() for t in ops]
    before = dict(dcn.LAUNCHES)
    out = dcn.deform_conv2d(leaves[0], leaves[1], leaves[3], leaves[2], leaves[4], **kwargs)
    (out.float() * cot).sum().backward()
    torch.cuda.synchronize()
    assert {k: dcn.LAUNCHES[k] - before[k] for k in before} == dict.fromkeys(before, 1)
    ref = [t.detach().float().clone().requires_grad_() for t in ops]
    want = dcn.deform_conv2d_reference(ref[0], ref[1], ref[3], ref[2], ref[4], **kwargs)
    (want * cot).sum().backward()
    pairs = [("out", out, want)] + [(n, a.grad, b.grad) for n, a, b in
                                    zip(("x", "offset", "mask", "weight", "bias"), leaves, ref)]
    for name, a, b in pairs:
        rel = ((a.float() - b.float()).abs().max() / b.abs().max().clamp_min(1e-12)).item()
        assert rel <= tol, (name, rel)
    if offsets == "beyond":  # what lies beyond the window adds exactly nothing
        far = ops[1].clone()
        far[:] = 3.5 * torch.sign(far)
        with torch.no_grad():
            zero = dcn.deform_conv2d(ops[0], far, ops[3], ops[2], ops[4], **kwargs)
        assert torch.equal(zero, ops[4].view(1, -1, 1, 1).expand_as(zero).to(zero.dtype))


@pytest.mark.parametrize("origin", ["band", "frame"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_dcn_kernels_at_a_row_origin_match_plain_versions(cuda, dtype, tol, origin):
    """The three kernels at a negative row origin, as the spatial axis runs
    them (``ops/deform_conv.spatial_operand``) for rows [8, 12) of a frame
    of 16 held in 4 bands: ``band`` takes the window's R + 2 = 4 rows above
    and below (R = 2, x rows [4, 16), pad_h = 1 − 4), ``frame`` the whole
    frame read from the band's first row (exact, pad_h = 1 − 8).  Through
    the autograd function against the plain version under autograd, as
    ``test_dcn_kernels_match_plain_versions``, and the output against the
    whole frame's plain conv cut to the band's rows."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
        deform_conv as dcn,
    )

    B, C, H, W, dg, rows, r0 = 2, 16, 16, 11, 4, 4, 8
    R = 2 if origin == "band" else None
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(B, C, H, W, generator=gen)
    off = (torch.rand(B, dg * 18, H, W, generator=gen) * 2 - 1) * 3.5
    mask = torch.rand(B, dg * 9, H, W, generator=gen)
    w = torch.randn(8, C, 3, 3, generator=gen) * 0.2
    b = torch.randn(8, generator=gen)
    cot = torch.randn(B, 8, rows, W, generator=gen)
    band = slice(r0, r0 + rows)
    xb, pad_h = (x[:, :, r0 - 4:r0 + rows + 4], 1 - 4) if R else (x, 1 - r0)
    cast = lambda t: t.contiguous().to(cuda, dtype)  # noqa: E731
    ops = [cast(xb), off[:, :, band].contiguous().to(cuda), cast(mask[:, :, band]), cast(w),
           cast(b)]
    kwargs = dict(padding=1, deformable_groups=dg, max_offset=R, pad_h=pad_h, out_h=rows)
    leaves = [t.clone().requires_grad_() for t in ops]
    before = dict(dcn.LAUNCHES)
    out = dcn.deform_conv2d(leaves[0], leaves[1], leaves[3], leaves[2], leaves[4], **kwargs)
    (out.float() * cot.to(cuda)).sum().backward()
    torch.cuda.synchronize()
    assert {k: dcn.LAUNCHES[k] - before[k] for k in before} == dict.fromkeys(before, 1)
    ref = [t.detach().float().clone().requires_grad_() for t in ops]
    want = dcn.deform_conv2d_reference(ref[0], ref[1], ref[3], ref[2], ref[4], **kwargs)
    (want * cot.to(cuda)).sum().backward()
    whole = dcn.deform_conv2d_reference(x, off, w, mask, b, padding=1, deformable_groups=dg,
                                        max_offset=R)[:, :, band]
    pairs = [("out", out, want), ("out against the frame", out, whole.to(cuda))] + [
        (n, a.grad, r.grad) for n, a, r in
        zip(("x", "offset", "mask", "weight", "bias"), leaves, ref)]
    for name, a, r in pairs:
        err = ((a.float() - r.float()).abs().max() / r.float().abs().max()).item()
        assert err <= tol, (name, err)


@pytest.mark.parametrize("channels,dg", [(32, 2), (64, 2), (12, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dcn_col2im_coord_repeats_its_bits(cuda, dtype, channels, dg):
    """col2im_coord sums a group's channels inside one block, without
    atomics: two calls on the same inputs give the same d_offset and d_mask,
    bit for bit."""
    dcn, g, ops, _ = _dcn_operands(cuda, dtype, "fractional", C=channels, dg=dg)
    x, off, mask = ops[:3]
    gen = torch.Generator().manual_seed(1)
    grad_col = torch.randn(g.B, g.C * g.K, g.Ho * g.Wo, generator=gen).to(cuda, dtype)
    first = dcn.deform_col2im_coord(grad_col, x, off, mask, g)
    second = dcn.deform_col2im_coord(grad_col, x, off, mask, g)
    torch.cuda.synchronize()
    assert first[0].abs().max() > 0
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_dcn_kernels_refuse_what_they_do_not_take(cuda):
    dcn, g, ops, _ = _dcn_operands(cuda, torch.float32, "fractional")
    x, off, mask, w, b = ops
    with pytest.raises(TypeError):
        dcn.deform_im2col(x.half(), off, None, g)
    with pytest.raises(ValueError):
        dcn.deform_im2col(x, off, mask.cpu(), g)
    with pytest.raises(ValueError):
        dcn.deform_im2col(x, off[:, :-1], mask, g)
    with pytest.raises(ValueError):
        dcn.deform_conv2d(x, off, w, mask, b, padding=1, deformable_groups=3)


@pytest.mark.parametrize("R", [None, 2], ids=["exact", "windowed"])
def test_small_edvr_on_the_card_matches_the_cpu(cuda, R):
    """A small EDVR (nf 16, 2 groups, 5 frames, LR 10×11: the pad path),
    offsets drawn off zero: the output and every gradient on the card
    (the DCN kernels: 20 im2col launches a forward, 20 of each backward
    kernel a backward) against the CPU's plain versions."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
        deform_conv as dcn,
    )

    kwargs = dict(in_channels=1, out_channels=1, nf=16, nframes=5, groups=2, front_RBs=1,
                  back_RBs=1, dcn_max_offset=R)
    net = models.EDVRNet(**kwargs, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "conv_offset_mask" in name:
                p.normal_(0.0, 0.05, generator=gen)
    card = models.EDVRNet(**kwargs)
    card.load_state_dict(net.state_dict())
    card.to(cuda)
    x = torch.randn(2, 5, 10, 11, 1, generator=gen)
    want = net(x)
    (want ** 2).mean().backward()
    before = dict(dcn.LAUNCHES)
    got = card(x.to(cuda))
    (got ** 2).mean().backward()
    torch.cuda.synchronize()
    assert {k: dcn.LAUNCHES[k] - before[k] for k in before} == dict.fromkeys(before, 20)
    assert ((got.detach().cpu() - want.detach()).abs().max() / want.abs().max()).item() <= 1e-4
    on_card = dict(card.named_parameters())
    for name, p in net.named_parameters():
        rel = ((on_card[name].grad.cpu() - p.grad).abs().max() / p.grad.abs().max()).item()
        assert rel <= 1e-3, (name, rel)


def test_skip_nonfinite_leaves_params_and_adam_state_bit_equal(cuda):
    """``skip_nonfinite`` on the card (fused Adam with ``found_inf``): a
    step with a NaN gradient leaves the parameters, both moments and the
    step count bit for bit; the counters stay on the device."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.optim import (
        Optimizer,
    )

    gen = torch.Generator(device=cuda).manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(64, 32, 3, 3, device=cuda, generator=gen)),
              torch.nn.Parameter(torch.randn(64, device=cuda, generator=gen))]
    opt = Optimizer("Adam", lr=1e-3, grad_clip_norm=1.0, skip_nonfinite=3)
    state = opt.init(params)
    assert state.nonfinite.device.type == "cuda"
    for p in params:
        p.grad = torch.randn(p.shape, device=cuda, generator=gen)
    opt.step(state)
    before = [(p.detach().clone(), {k: v.clone() for k, v in state.state[p].items()})
              for p in params]
    for p in params:
        p.grad = torch.randn(p.shape, device=cuda, generator=gen)
    params[1].grad[5] = float("nan")
    opt.step(state)
    for p, (value, moments) in zip(params, before):
        assert torch.equal(p.detach(), value)
        for key, v in moments.items():
            assert torch.equal(state.state[p][key], v), key
    assert state.nonfinite.tolist() == [1, 1] and opt.check_nonfinite(state) == 1


def test_world_one_ddp_step_equals_the_unwrapped_step(cuda):
    """A mesh of one (NCCL, the net under DDP) trains as the net alone:
    the same losses and weights (1e-6 relative) and the same gate launches
    a step."""
    import numpy as np
    import torch.distributed as dist

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import (
        Dataloader,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import (
        make_mesh,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel.distributed import (
        free_port,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.optim import (
        Optimizer,
    )

    rng = np.random.default_rng(0)
    items = [{"lr_imgs": rng.standard_normal((7, 8, 8, 1)).astype(np.float32),
              "hr_imgs": rng.standard_normal((3, 32, 32, 1)).astype(np.float32),
              "pos_code": rng.uniform(-1, 1, (7, 1)).astype(np.float32)} for _ in range(4)]
    kwargs = dict(in_channels=1, out_channels=1, num_features=[8, 8], upscale_factor=4,
                  num_stages=1, update_memory=True, num_updated_frames=2, refine_window_size=5,
                  positional_encoding=True)
    runs = []
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    try:
        for mesh in (None, make_mesh(1, device=cuda)):
            loader = Dataloader(items, batch_size=2)
            trainer = VSRRefineNetTrainer(
                device=cuda, train_dataloader=loader, valid_dataloader=loader,
                net=RefineNet(**kwargs), loss_fns=[L1Loss()], loss_weights=[1.0],
                optimizer=Optimizer("Adam", lr=1e-3), num_epochs=1, mesh=mesh, telemetry=False)
            before = (lstm_gates.LAUNCHES, lstm_gates.BWD_LAUNCHES)
            log, _, _ = trainer._run_epoch("training")
            launches = (lstm_gates.LAUNCHES - before[0], lstm_gates.BWD_LAUNCHES - before[1])
            runs.append((log, trainer.net.state_dict(), launches, type(trainer.model).__name__))
    finally:
        if made:
            dist.destroy_process_group()
    (log0, sd0, n0, kind0), (log1, sd1, n1, kind1) = runs
    assert kind0 == "RefineNet" and kind1 == "DistributedDataParallel"
    assert n0 == n1 and n0[0] > 0 and n0[1] > 0
    assert log1["Loss"] == pytest.approx(log0["Loss"], rel=1e-6)
    for key in sd0:
        torch.testing.assert_close(sd1[key], sd0[key], rtol=1e-6, atol=1e-7, msg=key)
