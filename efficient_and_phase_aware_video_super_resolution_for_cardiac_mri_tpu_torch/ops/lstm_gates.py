"""Fused ConvLSTM gate tail: the CUDA kernel's wrapper and its plain version.

The elementwise tail of every ConvLSTM step: split the gate conv's output
into (i, f, o, g) along the channel axis, then

    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')

Counterpart of the JAX package's ``ops/pallas/lstm_gates.py``.  On a CUDA
tensor :func:`fused_lstm_gates` launches the hand-written kernel of
``csrc/lstm_gates.cu`` (one pass: reads gates and c once, writes h' and c'
once) or raises; on a CPU tensor it runs :func:`lstm_gates_reference`.  The
gradient is the VJP of the plain version, recomputed from the saved
(gates, c), as the JAX package's ``_fused_bwd`` does.

``LAUNCHES`` counts kernel launches, so a run can show that it went through
the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: number of times the CUDA kernel was launched in this process
LAUNCHES = 0

_DTYPES = {torch.float32: "lstm_gates_f32", torch.bfloat16: "lstm_gates_bf16"}


def lstm_gates_reference(gates: torch.Tensor, c: torch.Tensor, dim: int = -1):
    """Plain PyTorch gate tail: gates (..., 4F, ...) and c (..., F, ...) with
    the channel axis at ``dim`` → (h', c')."""
    cc_i, cc_f, cc_o, cc_g = torch.chunk(gates, 4, dim=dim)
    c_next = torch.sigmoid(cc_f) * c + torch.sigmoid(cc_i) * torch.tanh(cc_g)
    h_next = torch.sigmoid(cc_o) * torch.tanh(c_next)
    return h_next, c_next


@functools.lru_cache(maxsize=None)
def build() -> _build.Built:
    """Compile (first call only) and load the kernel library."""
    built = _build.build("lstm_gates.cu")
    for fn in _DTYPES.values():
        f = getattr(built.lib, fn)
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
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
    global LAUNCHES
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
    return h_out, c_out


class _FusedGates(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gates, c, dim):
        ctx.save_for_backward(gates, c)
        ctx.dim = dim
        return _launch(gates, c, dim)

    @staticmethod
    def backward(ctx, grad_h, grad_c):
        gates, c = ctx.saved_tensors
        with torch.enable_grad():
            g = gates.detach().requires_grad_()
            cc = c.detach().requires_grad_()
            h_next, c_next = lstm_gates_reference(g, cc, ctx.dim)
            d_gates, d_c = torch.autograd.grad((h_next, c_next), (g, cc), (grad_h, grad_c))
        return d_gates, d_c, None


def fused_lstm_gates(gates: torch.Tensor, c: torch.Tensor, dim: int = -1):
    """Gate tail with the channel axis at ``dim``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  Same values and gradients
    as :func:`lstm_gates_reference`."""
    if gates.device.type == "cpu" and c.device.type == "cpu":
        return lstm_gates_reference(gates, c, dim)
    if gates.device.type != "cuda":
        raise ValueError(f"fused_lstm_gates runs on CUDA or CPU tensors, got {gates.device}")
    if torch.is_grad_enabled() and (gates.requires_grad or c.requires_grad):
        return _FusedGates.apply(gates, c, dim)
    # serving: no autograd node, a cheaper launch on the host; the ConvLSTM
    # steps are close to host-bound (``tools/profile_eval.py`` measures both)
    return _launch(gates, c, dim)
