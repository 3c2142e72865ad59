"""Fused ConvLSTM gate tail: the CUDA kernel's wrapper and its plain version.

The elementwise tail of every ConvLSTM step: split the gate conv's output
into (i, f, o, g) along the channel axis, then

    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')

Counterpart of the JAX package's ``ops/pallas/lstm_gates.py``.  On a CUDA
tensor :func:`fused_lstm_gates` launches the hand-written kernel of
``csrc/lstm_gates.cu`` (one pass: reads gates and c once, writes h' and c'
once) or raises; on a CPU tensor it runs :func:`lstm_gates_reference`.  The
gradient is recomputed from the saved (gates, c), as the JAX package's
``_fused_bwd`` does: on the card by the hand-written backward kernel of the
same source (one pass: reads gates, c, dh, dc' once, writes dgates and dc
once), on the CPU by its plain version :func:`lstm_gates_backward_reference`.

``LAUNCHES`` and ``BWD_LAUNCHES`` count the forward and backward kernel
launches, so a run can show that it went through the kernels;
``BF16_LAUNCHES`` and ``BF16_BWD_LAUNCHES`` count those of them on bfloat16
operands.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: number of times the forward CUDA kernel was launched in this process
LAUNCHES = 0
#: number of times the backward CUDA kernel was launched in this process
BWD_LAUNCHES = 0
#: of those launches, the ones on bfloat16 operands
BF16_LAUNCHES = 0
BF16_BWD_LAUNCHES = 0

_DTYPES = {torch.float32: "lstm_gates_f32", torch.bfloat16: "lstm_gates_bf16"}
_BWD_DTYPES = {torch.float32: "lstm_gates_bwd_f32", torch.bfloat16: "lstm_gates_bwd_bf16"}


def lstm_gates_reference(gates: torch.Tensor, c: torch.Tensor, dim: int = -1):
    """Plain PyTorch gate tail: gates (..., 4F, ...) and c (..., F, ...) with
    the channel axis at ``dim`` → (h', c')."""
    cc_i, cc_f, cc_o, cc_g = torch.chunk(gates, 4, dim=dim)
    c_next = torch.sigmoid(cc_f) * c + torch.sigmoid(cc_i) * torch.tanh(cc_g)
    h_next = torch.sigmoid(cc_o) * torch.tanh(c_next)
    return h_next, c_next


def lstm_gates_backward_reference(gates: torch.Tensor, c: torch.Tensor, dh: torch.Tensor,
                                  dc_next: torch.Tensor, dim: int = -1):
    """Plain PyTorch VJP of :func:`lstm_gates_reference`: (dh', dc') →
    (dgates, dc), recomputing the activations from (gates, c)."""
    cc_i, cc_f, cc_o, cc_g = torch.chunk(gates, 4, dim=dim)
    i, f, o = torch.sigmoid(cc_i), torch.sigmoid(cc_f), torch.sigmoid(cc_o)
    g = torch.tanh(cc_g)
    tc = torch.tanh(f * c + i * g)
    # products in the order of autograd's sigmoid and tanh backward rules,
    # grad * (1 - y) * y and grad * (1 - y²)
    dct = dc_next + dh * o * (1 - tc * tc)
    d_gates = torch.cat([dct * g * (1 - i) * i, dct * c * (1 - f) * f,
                         dh * tc * (1 - o) * o, dct * i * (1 - g * g)], dim=dim)
    return d_gates, dct * f


@functools.lru_cache(maxsize=None)
def build() -> _build.Built:
    """Compile (first call only) and load the kernel library."""
    built = _build.build("lstm_gates.cu")
    for names, n_ptr in ((_DTYPES, 4), (_BWD_DTYPES, 6)):
        for fn in names.values():
            f = getattr(built.lib, fn)
            f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
            f.restype = ctypes.c_int
    return built


def _layout(gates: torch.Tensor, c: torch.Tensor, dim: int) -> tuple[int, int, int]:
    """Check the operands and return the (outer, F, inner) view of c."""
    if gates.device != c.device:
        raise ValueError(f"gates on {gates.device} but c on {c.device}")
    if gates.dtype != c.dtype or gates.dtype not in _DTYPES:
        raise TypeError(
            f"fused_lstm_gates takes float32 or bfloat16 operands of one dtype; "
            f"got gates {gates.dtype}, c {c.dtype}"
        )
    dim = dim % c.dim()
    expect = list(c.shape)
    expect[dim] *= 4
    if list(gates.shape) != expect:
        raise ValueError(f"gates {tuple(gates.shape)} do not match c {tuple(c.shape)} at dim {dim}")
    if not (gates.is_contiguous() and c.is_contiguous()):
        raise ValueError("fused_lstm_gates takes contiguous gates and c")
    outer = 1
    for s in c.shape[:dim]:
        outer *= s
    inner = 1
    for s in c.shape[dim + 1 :]:
        inner *= s
    return outer, c.shape[dim], inner


def _launch(gates: torch.Tensor, c: torch.Tensor, dim: int):
    global LAUNCHES, BF16_LAUNCHES
    outer, F, inner = _layout(gates, c, dim)
    h_out = torch.empty_like(c)
    c_out = torch.empty_like(c)
    fn = getattr(build().lib, _DTYPES[c.dtype])
    stream = torch.cuda.current_stream(c.device).cuda_stream
    with torch.cuda.device(c.device):
        err = fn(gates.data_ptr(), c.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
                 outer, F, inner, stream)
    if err != 0:
        raise RuntimeError(f"lstm_gates kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    BF16_LAUNCHES += c.dtype == torch.bfloat16
    return h_out, c_out


def _launch_bwd(gates: torch.Tensor, c: torch.Tensor, dh: torch.Tensor, dc_next: torch.Tensor,
                dim: int):
    global BWD_LAUNCHES, BF16_BWD_LAUNCHES
    outer, F, inner = _layout(gates, c, dim)
    for name, grad in (("dh", dh), ("dc'", dc_next)):
        if grad.shape != c.shape or grad.dtype != c.dtype or grad.device != c.device:
            raise ValueError(f"{name} {tuple(grad.shape)} {grad.dtype} on {grad.device} does not "
                             f"match c {tuple(c.shape)} {c.dtype} on {c.device}")
        if not grad.is_contiguous():
            raise ValueError(f"the gate backward takes a contiguous {name}")
    d_gates = torch.empty_like(gates)
    d_c = torch.empty_like(c)
    fn = getattr(build().lib, _BWD_DTYPES[c.dtype])
    stream = torch.cuda.current_stream(c.device).cuda_stream
    with torch.cuda.device(c.device):
        err = fn(gates.data_ptr(), c.data_ptr(), dh.data_ptr(), dc_next.data_ptr(),
                 d_gates.data_ptr(), d_c.data_ptr(), outer, F, inner, stream)
    if err != 0:
        raise RuntimeError(f"lstm_gates backward kernel launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    BF16_BWD_LAUNCHES += c.dtype == torch.bfloat16
    return d_gates, d_c


class _FusedGates(torch.autograd.Function):
    """The kernels on CUDA tensors, their plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, gates, c, dim):
        ctx.save_for_backward(gates, c)
        ctx.dim = dim
        if gates.device.type == "cpu":
            return lstm_gates_reference(gates, c, dim)
        return _launch(gates, c, dim)

    @staticmethod
    def backward(ctx, grad_h, grad_c):
        # autograd hands zeros for an output without a gradient; the grads
        # can be strided views (the backward of stack, cat or flip)
        gates, c = ctx.saved_tensors
        if gates.device.type == "cpu":
            d_gates, d_c = lstm_gates_backward_reference(gates, c, grad_h, grad_c, ctx.dim)
        else:
            d_gates, d_c = _launch_bwd(gates, c, grad_h.contiguous(), grad_c.contiguous(),
                                       ctx.dim)
        return d_gates, d_c, None


def fused_lstm_gates(gates: torch.Tensor, c: torch.Tensor, dim: int = -1):
    """Gate tail with the channel axis at ``dim``: the CUDA kernels for CUDA
    tensors, the plain versions for CPU tensors.  Same values and gradients
    as :func:`lstm_gates_reference`."""
    on_cpu = gates.device.type == "cpu" and c.device.type == "cpu"
    if not on_cpu and gates.device.type != "cuda":
        raise ValueError(f"fused_lstm_gates runs on CUDA or CPU tensors, got {gates.device}")
    if torch.is_grad_enabled() and (gates.requires_grad or c.requires_grad):
        return _FusedGates.apply(gates, c, dim)
    if on_cpu:
        return lstm_gates_reference(gates, c, dim)
    # serving: no autograd node, a cheaper launch on the host; the ConvLSTM
    # steps are close to host-bound (``tools/profile_eval.py`` measures both)
    return _launch(gates, c, dim)
