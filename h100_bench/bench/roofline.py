"""Peaks of the card and the least time of each hand kernel's launch.

The peaks are NVIDIA's H100 data sheets' (dense, no sparsity): memory
bytes/s, the fp32 rate outside the tensor cores, and the bf16 tensor-core
rate, by part; the SXM part ("H100 80GB HBM3") is rated at 700 W.

A launch's least time is the larger of its bytes over the memory rate and
its operations over the fp32 rate.  Bytes count each input read once and
each output written once, fp32 throughout (the configurations' precision).
"""
from __future__ import annotations

#: part → (memory bytes/s, fp32 FLOP/s, bf16 FLOP/s)
CARDS = {"PCIe": (2.0e12, 51e12, 756e12), "NVL": (3.9e12, 60e12, 835e12),
         "SXM": (3.35e12, 67e12, 989e12)}

#: operations a gate element: 3 sigmoids and 2 tanh (3 each), 4 for c' and h'
GATE_OPS = 19
#: the backward's: the 5 activations (15), c' (3), dc (5), the 4 gate
#: gradients (4 each), dc_prev (1)
GATE_BWD_OPS = 40
#: operations a col element (one (b, c, tap, pixel) sample) of each DCN kernel
DCN_OPS = {"deform_im2col_kernel": 23, "deform_col2im_kernel": 23,
           "deform_col2im_coord_kernel": 30}


def part(device_name: str) -> str:
    for key in ("PCIe", "NVL"):
        if key in device_name:
            return key
    return "SXM"


def peaks(device_name: str) -> tuple[float, float, float]:
    return CARDS[part(device_name)]


def _least(nbytes: float, ops: float, rates) -> float:
    mem, fp32 = rates[0], rates[1]
    return max(nbytes / mem, ops / fp32)


def gate_bounds(B: int, F: int, H: int, W: int, rates) -> dict:
    """Least seconds of one forward and one backward gate launch on
    (B, 4F, H, W) gates: the forward reads gates, c and the bias and writes
    h' and c'; the backward reads gates, c, dh, dc' and the bias and writes
    the gates' gradient and dc."""
    m = B * H * W * F
    fwd = 4 * (4 * m + m + 4 * F + 2 * m)
    bwd = 4 * (4 * m + 3 * m + 4 * F + 4 * m + m)
    return {"lstm_gates_kernel": _least(fwd, GATE_OPS * m, rates),
            "lstm_gates_bwd_kernel": _least(bwd, GATE_BWD_OPS * m, rates)}


def dcn_bounds(B: int, C: int, H: int, W: int, dg: int, K: int, rates) -> dict:
    """Least seconds of one launch of each DCN kernel, stride 1, on x
    (B, C, H, W): im2col reads x, the offsets (dg·2K planes) and the mask
    (dg·K) and writes col (C·K planes); col2im reads col's gradient, the
    offsets and the mask and writes x's gradient; col2im_coord reads col's
    gradient, x, the offsets and the mask and writes the offsets' and the
    mask's gradients."""
    hw = H * W
    x, off, mask, col = B * C * hw, B * dg * 2 * K * hw, B * dg * K * hw, B * C * K * hw
    nbytes = {"deform_im2col_kernel": x + off + mask + col,
              "deform_col2im_kernel": col + off + mask + x,
              "deform_col2im_coord_kernel": col + x + 2 * (off + mask)}
    return {k: _least(4 * v, DCN_OPS[k] * col, rates) for k, v in nbytes.items()}
