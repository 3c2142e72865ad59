"""Fused ConvLSTM gate tail: the CUDA kernel's wrapper and its plain version.

The elementwise tail of every ConvLSTM step: add the gate conv's bias to its
raw output, split it into (i, f, o, g) along the channel axis, then

    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')

Counterpart of the JAX package's ``ops/pallas/lstm_gates.py`` (whose gates
carry the bias already: the plain version here with ``bias`` equals the JAX
one on ``gates + bias``).  On a CUDA tensor :func:`fused_lstm_gates` launches
the hand-written kernel of ``csrc/lstm_gates.cu`` (one pass: reads gates, c
and the bias once, writes h' and c' once) or raises; on a CPU tensor it runs
:func:`lstm_gates_reference`.  The operands are contiguous with the channel
axis at ``dim``, or 4D in ``torch.channels_last`` with ``dim=1`` (the
layout cuDNN's tensor-core convs produce), which the kernel reads as rows
of (M, 4F).  The gradient is recomputed from the saved (gates, c, bias), as
the JAX package's ``_fused_bwd`` does: on the card by the hand-written
backward kernel of the same source (one pass: reads gates, c, dh, dc' once,
writes dgates and dc once), on the CPU by its plain version
:func:`lstm_gates_backward_reference`; the bias's gradient is dgates summed
over every axis but the channel axis.

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


def _add_bias(gates: torch.Tensor, bias: torch.Tensor | None, dim: int) -> torch.Tensor:
    if bias is None:
        return gates
    shape = [1] * gates.dim()
    shape[dim] = -1
    return gates + bias.view(shape)


def lstm_gates_reference(gates: torch.Tensor, c: torch.Tensor, dim: int = -1,
                         bias: torch.Tensor | None = None):
    """Plain PyTorch gate tail: gates (..., 4F, ...) and c (..., F, ...) with
    the channel axis at ``dim``, plus ``bias`` (4F,) along that axis → (h', c')."""
    cc_i, cc_f, cc_o, cc_g = torch.chunk(_add_bias(gates, bias, dim), 4, dim=dim)
    c_next = torch.sigmoid(cc_f) * c + torch.sigmoid(cc_i) * torch.tanh(cc_g)
    h_next = torch.sigmoid(cc_o) * torch.tanh(c_next)
    return h_next, c_next


def lstm_gates_backward_reference(gates: torch.Tensor, c: torch.Tensor, dh: torch.Tensor,
                                  dc_next: torch.Tensor, dim: int = -1,
                                  bias: torch.Tensor | None = None):
    """Plain PyTorch VJP of :func:`lstm_gates_reference`: (dh', dc') →
    (dgates, dc), recomputing the activations from (gates, c, bias).  The
    bias's gradient is dgates summed over all but the channel axis."""
    cc_i, cc_f, cc_o, cc_g = torch.chunk(_add_bias(gates, bias, dim), 4, dim=dim)
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
    for names, n_ptr in ((_DTYPES, 5), (_BWD_DTYPES, 7)):
        for fn in names.values():
            f = getattr(built.lib, fn)
            f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
            f.restype = ctypes.c_int
    f = built.lib.lstm_gates_vector_width
    f.argtypes = [ctypes.c_int64] * 3 + [ctypes.c_int]
    f.restype = ctypes.c_int
    return built


def _channels_last(t: torch.Tensor) -> bool:
    return t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)


def _layout(gates: torch.Tensor, c: torch.Tensor, dim: int,
            bias: torch.Tensor | None = None) -> tuple[int, int, int]:
    """Check the operands and return the (outer, F, inner) view of c: a
    contiguous c with its channel axis at ``dim``, or (M, F, 1) for 4D
    ``channels_last`` operands with ``dim=1``."""
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
    F = c.shape[dim]
    if bias is not None and (tuple(bias.shape) != (4 * F,) or bias.dtype != c.dtype
                             or bias.device != c.device or not bias.is_contiguous()):
        raise ValueError(f"bias {tuple(bias.shape)} {bias.dtype} on {bias.device} is not a "
                         f"contiguous ({4 * F},) {c.dtype} on {c.device}")
    if gates.is_contiguous() and c.is_contiguous():
        outer = 1
        for s in c.shape[:dim]:
            outer *= s
        inner = 1
        for s in c.shape[dim + 1 :]:
            inner *= s
        return outer, F, inner
    if dim == 1 and _channels_last(gates) and _channels_last(c):
        N, _, H, W = c.shape
        return N * H * W, F, 1
    raise ValueError("fused_lstm_gates takes contiguous gates and c, or 4D channels_last "
                     "ones with dim=1")


def _same_layout(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` in the memory layout of ``like`` (contiguous or channels-last)."""
    if like.is_contiguous():
        return t.contiguous()
    return t.contiguous(memory_format=torch.channels_last)


def vector_width(*tensors: torch.Tensor, dim: int = -1) -> int:
    """Elements a vector that a launch on these operands (gates and c first,
    then any of the bias, dh and dc') takes: 8 (bf16) or 4 (fp32) on the
    16-byte path, 1 on the scalar path.  Builds the kernel library."""
    gates, c = tensors[:2]
    _, F, inner = _layout(gates, c, dim)
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return build().lib.lstm_gates_vector_width(F, inner, c.element_size(), int(aligned))


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(gates: torch.Tensor, c: torch.Tensor, dim: int, bias: torch.Tensor | None = None):
    global LAUNCHES, BF16_LAUNCHES
    outer, F, inner = _layout(gates, c, dim, bias)
    h_out = torch.empty_like(c)
    c_out = torch.empty_like(c)
    fn = getattr(build().lib, _DTYPES[c.dtype])
    stream = torch.cuda.current_stream(c.device).cuda_stream
    with torch.cuda.device(c.device):
        err = fn(gates.data_ptr(), c.data_ptr(), _ptr(bias), h_out.data_ptr(), c_out.data_ptr(),
                 outer, F, inner, stream)
    if err != 0:
        raise RuntimeError(f"lstm_gates kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    BF16_LAUNCHES += c.dtype == torch.bfloat16
    return h_out, c_out


def _launch_bwd(gates: torch.Tensor, c: torch.Tensor, dh: torch.Tensor, dc_next: torch.Tensor,
                dim: int, bias: torch.Tensor | None = None):
    global BWD_LAUNCHES, BF16_BWD_LAUNCHES
    outer, F, inner = _layout(gates, c, dim, bias)
    for name, grad in (("dh", dh), ("dc'", dc_next)):
        if grad.shape != c.shape or grad.dtype != c.dtype or grad.device != c.device:
            raise ValueError(f"{name} {tuple(grad.shape)} {grad.dtype} on {grad.device} does not "
                             f"match c {tuple(c.shape)} {c.dtype} on {c.device}")
        if not (grad.is_contiguous() if c.is_contiguous() else _channels_last(grad)):
            raise ValueError(f"the gate backward takes {name} in the layout of c")
    d_gates = torch.empty_like(gates)
    d_c = torch.empty_like(c)
    fn = getattr(build().lib, _BWD_DTYPES[c.dtype])
    stream = torch.cuda.current_stream(c.device).cuda_stream
    with torch.cuda.device(c.device):
        err = fn(gates.data_ptr(), c.data_ptr(), _ptr(bias), dh.data_ptr(), dc_next.data_ptr(),
                 d_gates.data_ptr(), d_c.data_ptr(), outer, F, inner, stream)
    if err != 0:
        raise RuntimeError(f"lstm_gates backward kernel launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    BF16_BWD_LAUNCHES += c.dtype == torch.bfloat16
    return d_gates, d_c


class _FusedGates(torch.autograd.Function):
    """The kernels on CUDA tensors, their plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, gates, c, dim, bias):
        ctx.save_for_backward(gates, c, bias)
        ctx.dim = dim
        if gates.device.type == "cpu":
            return lstm_gates_reference(gates, c, dim, bias)
        return _launch(gates, c, dim, bias)

    @staticmethod
    def backward(ctx, grad_h, grad_c):
        # autograd hands zeros for an output without a gradient; the grads
        # can be strided views (the backward of stack, cat or flip)
        gates, c, bias = ctx.saved_tensors
        if gates.device.type == "cpu":
            d_gates, d_c = lstm_gates_backward_reference(gates, c, grad_h, grad_c, ctx.dim, bias)
        else:
            d_gates, d_c = _launch_bwd(gates, c, _same_layout(grad_h, c), _same_layout(grad_c, c),
                                       ctx.dim, bias)
        d_bias = None
        if ctx.needs_input_grad[3]:
            dim = ctx.dim % d_gates.dim()
            if _channels_last(d_gates) and not d_gates.is_contiguous():
                # rows (M, 4F): a column sum, which a product with ones does at
                # the memory rate and ATen's reduction over M does not
                rows = d_gates.permute(0, 2, 3, 1).reshape(-1, d_gates.shape[1])
                d_bias = rows.new_ones(rows.shape[0]) @ rows
            else:
                d_bias = d_gates.sum(dim=[d for d in range(d_gates.dim()) if d != dim])
        return d_gates, d_c, None, d_bias


def fused_lstm_gates(gates: torch.Tensor, c: torch.Tensor, dim: int = -1,
                     bias: torch.Tensor | None = None):
    """Gate tail with the channel axis at ``dim`` and the gate conv's
    ``bias`` (4F,) added to ``gates`` first: the CUDA kernels for CUDA
    tensors, the plain versions for CPU tensors.  Same values and gradients
    as :func:`lstm_gates_reference`."""
    on_cpu = gates.device.type == "cpu" and c.device.type == "cpu"
    if not on_cpu and gates.device.type != "cuda":
        raise ValueError(f"fused_lstm_gates runs on CUDA or CPU tensors, got {gates.device}")
    if torch.is_grad_enabled() and (gates.requires_grad or c.requires_grad
                                    or (bias is not None and bias.requires_grad)):
        return _FusedGates.apply(gates, c, dim, bias)
    if on_cpu:
        return lstm_gates_reference(gates, c, dim, bias)
    # serving: no autograd node, a cheaper launch on the host; the ConvLSTM
    # steps are close to host-bound (``tools/profile_eval.py`` measures both)
    return _launch(gates, c, dim, bias)
