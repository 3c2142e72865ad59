"""Deformable convolution v1/v2 (NCHW): the CUDA kernels' wrappers and their plain versions.

Counterpart of the JAX package's ``ops/deform_conv.py`` (``deform_conv2d``
and ``deform_conv2d_windowed``), which computes the reference's CUDA
extension (``dcn/src/deform_conv_cuda_kernel.cu:190-276``) as XLA gathers
plus one contraction.  Here the deformable im2col and its two backward
passes are the hand-written kernels of ``csrc/deform_conv.cu``, and the
contraction is one ``torch.matmul``:

* sampling point of output (ho, wo), tap (i, j), deformable group g:
    py = ho·stride − pad_h + i·dilation + offset[b, g·2K + 2·tap, ho, wo]
    px = wo·stride − pad_w + j·dilation + offset[b, g·2K + 2·tap + 1, ho, wo]
  (channel ``g·2K + 2·tap`` is y, ``+1`` is x; the mask's is ``g·K + tap``;
  K = kh·kw, tap = i·kw + j), coordinates in fp32 whatever the dtype;
* a bilinear sample with zero padding: a corner outside the image adds
  nothing, and a point that fails ``-1 < py < H, -1 < px < W`` samples 0
  (the kernel's outer test, which also zeroes the offset gradient there);
* ``col[b, c·K + tap, ho·Wo + wo] = mask · sample`` (B, Cin·K, Ho·Wo), so
  that ``weight.view(Cout, Cin·K) @ col`` is the NCHW output;
* ``max_offset=R`` (stride and dilation 1, as the JAX package dispatches
  it): the JAX package's windowed path, the same sample with every corner
  whose displacement from the tap lies outside [−R, R] dropped.  Exact for
  |offset| ≤ R, attenuating linearly to 0 at R + 1; the fractional part is
  taken from the offset itself, where the exact path takes it from py.

Gradients flow only through the fractional part, as the reference's
``col2im_coord`` and JAX's autodiff compute them.  The backward recomputes
nothing: the forward saves col (``weight``'s gradient is ``grad_out ·
colᵀ``), and the two backward kernels give d_x (``deform_col2im``, float4
atomic adds into a channels-last fp32 buffer, transposed to NCHW, cast
once) and d_offset, d_mask (``deform_col2im_coord``, a sum over the group's
channels inside one block, so its bits repeat from run to run).  The im2col
and col2im_coord kernels gather from a channels-last x, which their entry
points transpose into a buffer of the wrapper's unless x is channels-last
already; col keeps the layout above.

Dtypes follow the JAX package's promotion: col is in the promoted dtype of
x and the mask (an fp32 mask from an fp32 offset conv makes a bf16 x's col
fp32, as in JAX), the product in the promoted dtype of col and the weight.
The kernels compute in fp32 and round once, at the store.

The geometry takes a row origin: ``pad_h`` (the conv's padding by default)
may differ from ``pad_w`` and be negative, and the output height ``Ho`` is
the caller's.  Under a spatial axis (``parallel/halo.py``) the modules
below pass the kernels one of two x's for a band of output rows: with
``max_offset=R`` the band with the R + 2 frame rows above and below it
that a window reaches (fewer at the frame's border, where the frame
ends), ``pad_h`` = padding − the rows above; without, the frame gathered
whole (``parallel/halo.gather_frame``), ``pad_h`` = padding − the band's
first row.  Either way a sample's corners and its outer test are the
whole frame's.

On CUDA tensors :func:`deform_conv2d` always runs the kernels (a failed
build or launch raises); on CPU tensors the same autograd function runs the
plain versions (:func:`deform_im2col_reference`,
:func:`deform_col2im_reference`, :func:`deform_col2im_coord_reference`).
``LAUNCHES`` counts each kernel's launches and ``BF16_LAUNCHES`` those on
bfloat16 operands, so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
from torch import nn

from . import _build, telemetry

KERNELS = ("deform_im2col", "deform_col2im", "deform_col2im_coord")
#: launches of each CUDA kernel in this process
LAUNCHES = dict.fromkeys(KERNELS, 0)
#: of those launches, the ones on bfloat16 operands
BF16_LAUNCHES = dict.fromkeys(KERNELS, 0)
#: the CUDA kernels behind these wrappers, as a profiler trace names them
#: (each wrapper's entry point also runs the transpose)
TRACE_NAMES = ("deform_im2col_kernel", "deform_col2im_kernel", "deform_col2im_coord_kernel",
               "transpose_kernel")

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the kernels index in 32 bits; the grid's y and z axes take at most 65535
# blocks (the image on z, 32 pixels a block on the transposes' y)
_MAX_ELEMENTS, _MAX_GRID = 2**31 - 1, 65535


def trace_share(by_name: dict) -> dict:
    """This module's kernels in a profiler trace: ``by_name`` maps a traced
    kernel name to its (device ms, launches); the result maps each of
    ``TRACE_NAMES`` that occurs to its summed (device ms, launches)."""
    out = {}
    for name, (ms, n) in by_name.items():
        key = next((k for k in TRACE_NAMES if k in name), None)
        if key:
            t, c = out.get(key, (0.0, 0))
            out[key] = (t + ms, c + n)
    return out


def reset_launches() -> None:
    for counts in (LAUNCHES, BF16_LAUNCHES):
        for name in KERNELS:
            counts[name] = 0


@dataclass(frozen=True)
class Geometry:
    """The shapes of one deformable conv; ``R`` < 0 is the exact path."""

    B: int
    C: int
    H: int
    W: int
    Ho: int
    Wo: int
    kh: int
    kw: int
    stride: int
    pad_w: int
    dil: int
    dg: int
    R: int
    pad_h: int

    @property
    def K(self) -> int:
        return self.kh * self.kw

    def as_int64(self):
        vals = (self.B, self.C, self.H, self.W, self.Ho, self.Wo, self.kh, self.kw,
                self.stride, self.pad_w, self.dil, self.dg, self.R, self.pad_h)
        return (ctypes.c_int64 * len(vals))(*vals)


def geometry(x_shape, kh: int, kw: int, stride: int = 1, padding: int = 0, dilation: int = 1,
             deformable_groups: int = 1, max_offset: int | None = None,
             pad_h: int | None = None, out_h: int | None = None) -> Geometry:
    """The geometry of a deformable conv on x of ``x_shape``; the window
    applies at stride and dilation 1 only (the JAX package's dispatch).
    ``pad_h`` (``padding`` by default) is the row origin: output row ho
    reads x's rows from ho·stride − pad_h; ``out_h`` the output height
    (by default from H and ``padding``)."""
    B, C, H, W = x_shape
    if C % deformable_groups:
        raise ValueError(f"Cin={C} not divisible by deformable_groups={deformable_groups}.")
    Ho = (H + 2 * padding - (dilation * (kh - 1) + 1)) // stride + 1 if out_h is None else out_h
    Wo = (W + 2 * padding - (dilation * (kw - 1) + 1)) // stride + 1
    windowed = max_offset is not None and stride == 1 and dilation == 1
    return Geometry(B, C, H, W, Ho, Wo, kh, kw, stride, padding, dilation, deformable_groups,
                    int(max_offset) if windowed else -1, padding if pad_h is None else pad_h)


# ------------------------------------------------------------ plain versions


def _corners(offset: torch.Tensor, g: Geometry):
    """The four bilinear corners of every (b, group, tap, pixel) sample:
    yields (flat index into an H·W plane, weight, ∂weight/∂py, ∂weight/∂px),
    each (B, dg, 1, K·Ho·Wo), the weights 0 where the corner is dropped
    (outside the image or the window, or the sample outside)."""
    B, dg, K, Ho, Wo = g.B, g.dg, g.K, g.Ho, g.Wo
    dev = offset.device
    off = offset.float().reshape(B, dg, K, 2, Ho, Wo)
    oy, ox = off[:, :, :, 0], off[:, :, :, 1]  # (B, dg, K, Ho, Wo)
    taps = torch.arange(K, device=dev)
    ty = ((taps // g.kw) * g.dil).float().view(1, 1, K, 1, 1)
    tx = ((taps % g.kw) * g.dil).float().view(1, 1, K, 1, 1)
    by = (torch.arange(Ho, device=dev) * g.stride - g.pad_h).float().view(1, 1, 1, Ho, 1) + ty
    bx = (torch.arange(Wo, device=dev) * g.stride - g.pad_w).float().view(1, 1, 1, 1, Wo) + tx
    py, px = by + oy, bx + ox
    inside = (py > -1) & (px > -1) & (py < g.H) & (px < g.W)
    if g.R < 0:
        y0, x0 = torch.floor(py), torch.floor(px)
        fy, fx = py - y0, px - x0
    else:
        fly, flx = torch.floor(oy), torch.floor(ox)
        fy, fx = oy - fly, ox - flx
        y0, x0 = by + fly, bx + flx
    flat = (B, dg, 1, K * Ho * Wo)
    for dy in (0, 1):
        for dx in (0, 1):
            yc, xc = y0 + dy, x0 + dx
            ok = inside & (yc >= 0) & (yc <= g.H - 1) & (xc >= 0) & (xc <= g.W - 1)
            if g.R >= 0:
                ok = ok & ((fly + dy).abs() <= g.R) & ((flx + dx).abs() <= g.R)
            okf = ok.float()
            wy, wx = (fy if dy else 1 - fy), (fx if dx else 1 - fx)
            sy, sx = (1.0 if dy else -1.0), (1.0 if dx else -1.0)
            idx = (yc.clamp(0, g.H - 1) * g.W + xc.clamp(0, g.W - 1)).long()
            yield (idx.reshape(flat), (wy * wx * okf).reshape(flat),
                   (sy * wx * okf).reshape(flat), (sx * wy * okf).reshape(flat))


def _planes(x: torch.Tensor, g: Geometry) -> torch.Tensor:
    """x (B, C, H, W) as fp32 (B, dg, Cg, H·W) planes."""
    return x.float().reshape(g.B, g.dg, g.C // g.dg, g.H * g.W)


def _gather(planes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(planes, 3, idx.expand(-1, -1, planes.shape[2], -1))


def col_dtype(x: torch.Tensor, mask: torch.Tensor | None) -> torch.dtype:
    return x.dtype if mask is None else torch.promote_types(x.dtype, mask.dtype)


def deform_im2col_reference(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor | None,
                            g: Geometry) -> torch.Tensor:
    """Plain PyTorch deformable im2col: x (B, C, H, W), offset (B, dg·2K,
    Ho, Wo), mask (B, dg·K, Ho, Wo) or None → col (B, C·K, Ho·Wo) in
    :func:`col_dtype`, computed in fp32; differentiable in x, offset and
    mask."""
    planes = _planes(x, g)
    sample = None
    for idx, w, _, _ in _corners(offset, g):
        term = _gather(planes, idx) * w
        sample = term if sample is None else sample + term
    if mask is not None:
        sample = sample * mask.float().reshape(g.B, g.dg, 1, g.K * g.Ho * g.Wo)
    return sample.reshape(g.B, g.C * g.K, g.Ho * g.Wo).to(col_dtype(x, mask))


def deform_col2im_reference(grad_col: torch.Tensor, offset: torch.Tensor,
                            mask: torch.Tensor | None, g: Geometry) -> torch.Tensor:
    """Plain PyTorch VJP of the im2col in x: ``grad_col · mask · corner
    weight`` scattered onto the corners → d_x (B, C, H, W) in fp32."""
    gc = grad_col.float().reshape(g.B, g.dg, g.C // g.dg, g.K * g.Ho * g.Wo)
    if mask is not None:
        gc = gc * mask.float().reshape(g.B, g.dg, 1, g.K * g.Ho * g.Wo)
    dx = torch.zeros(g.B, g.dg, g.C // g.dg, g.H * g.W, device=gc.device)
    for idx, w, _, _ in _corners(offset, g):
        dx.scatter_add_(3, idx.expand(-1, -1, gc.shape[2], -1), gc * w)
    return dx.reshape(g.B, g.C, g.H, g.W)


def deform_col2im_coord_reference(grad_col: torch.Tensor, x: torch.Tensor, offset: torch.Tensor,
                                  mask: torch.Tensor | None, g: Geometry):
    """Plain PyTorch VJP of the im2col in the offset and the mask: for each
    (b, group, tap, pixel), summed over the group's channels, d_mask =
    Σ grad_col · sample and d_offset_{y,x} = mask · Σ grad_col · ∂sample/∂{py,px}
    → (d_offset (B, dg·2K, Ho, Wo), d_mask (B, dg·K, Ho, Wo) or None), fp32."""
    planes = _planes(x, g)
    gc = grad_col.float().reshape(g.B, g.dg, g.C // g.dg, g.K * g.Ho * g.Wo)
    s = sy = sx = 0.0
    for idx, w, wdy, wdx in _corners(offset, g):
        v = _gather(planes, idx)
        s, sy, sx = s + v * w, sy + v * wdy, sx + v * wdx
    shape = (g.B, g.dg, g.K, g.Ho, g.Wo)
    d_y, d_x = ((gc * t).sum(2).reshape(shape) for t in (sy, sx))
    d_mask = None
    if mask is not None:
        m = mask.float().reshape(shape)
        d_y, d_x = d_y * m, d_x * m
        d_mask = (gc * s).sum(2).reshape(g.B, g.dg * g.K, g.Ho, g.Wo)
    d_offset = torch.stack([d_y, d_x], dim=3).reshape(g.B, g.dg * 2 * g.K, g.Ho, g.Wo)
    return d_offset, d_mask


def _contract(col: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
              g: Geometry) -> torch.Tensor:
    dtype = torch.promote_types(col.dtype, weight.dtype)
    out = torch.matmul(weight.reshape(weight.shape[0], -1).to(dtype), col.to(dtype))
    out = out.view(g.B, weight.shape[0], g.Ho, g.Wo)
    return out if bias is None else out + bias.view(1, -1, 1, 1)


def deform_conv2d_reference(x, offset, weight, mask=None, bias=None, stride=1, padding=0,
                            dilation=1, deformable_groups=1, max_offset=None, pad_h=None,
                            out_h=None):
    """The plain version of :func:`deform_conv2d`, under autograd."""
    kh, kw = weight.shape[2:]
    g = geometry(x.shape, kh, kw, stride, padding, dilation, deformable_groups, max_offset,
                 pad_h, out_h)
    return _contract(deform_im2col_reference(x, offset, mask, g), weight, bias, g)


# ------------------------------------------------------------------ kernels


@functools.lru_cache(maxsize=None)
def build() -> _build.Built:
    """Compile (first call only) and load the kernel library."""
    built = _build.build("deform_conv.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    args = {"deform_im2col": [ptr, i32, ptr, ptr, ptr, ptr], "deform_col2im": [ptr] * 5,
            "deform_col2im_coord": [ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr]}
    for sfx in _SUFFIX.values():
        for name, operands in args.items():
            f = getattr(built.lib, f"{name}_{sfx}")
            f.argtypes = [*operands, ptr, ptr]  # + the geometry, the stream
            f.restype = ctypes.c_int
    return built


def _check(g: Geometry, dev: torch.device, dtype: torch.dtype, **operands) -> None:
    """Refuse operands the kernels do not take: another dtype than fp32 or
    bf16, another device than one card, shapes that are not ``g``'s, sizes
    beyond 32-bit indexing."""
    if dtype not in _SUFFIX:
        raise TypeError(f"the deformable conv kernels take float32 or bfloat16, got {dtype}")
    want = {"x": (g.B, g.C, g.H, g.W), "offset": (g.B, g.dg * 2 * g.K, g.Ho, g.Wo),
            "mask": (g.B, g.dg * g.K, g.Ho, g.Wo), "grad_col": (g.B, g.C * g.K, g.Ho * g.Wo)}
    for name, t in operands.items():
        if t is None:
            continue
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} on {t.device}: the kernels take tensors on one card ({dev})")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)} is not {want[name]}")
    if min(g.Ho, g.Wo) <= 0:
        raise ValueError(f"empty output {g.Ho}x{g.Wo}")
    P = g.Ho * g.Wo
    if (g.B > _MAX_GRID or -(-g.H * g.W // 32) > _MAX_GRID
            or max(g.B * g.C * g.H * g.W, g.B * g.C * g.K * P,
                   g.B * g.dg * 2 * g.K * P) > _MAX_ELEMENTS):
        raise ValueError(f"{g} is too large for the kernels' 32-bit indexing and grid (at most "
                         f"{_MAX_ELEMENTS} elements an operand, {_MAX_GRID} images and "
                         f"{_MAX_GRID * 32} pixels an image)")


def _launch(name: str, dtype: torch.dtype, x: torch.Tensor, g: Geometry, *ptrs) -> None:
    fn = getattr(build().lib, f"{name}_{_SUFFIX[dtype]}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    geom = g.as_int64()  # alive until the entry point has read it
    with torch.cuda.device(x.device):
        err = fn(*ptrs, ctypes.addressof(geom), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    BF16_LAUNCHES[name] += dtype == torch.bfloat16


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _channels_last(x: torch.Tensor, dtype: torch.dtype):
    """(x_nchw, x_cl) for an entry point that gathers from x channels-last
    (B, H, W, C) in ``dtype``: x itself and no x_nchw where it is such a
    tensor already (contiguous channels-last, 16-byte aligned); else the
    contiguous NCHW x, which the entry point transposes (and casts) into the
    new buffer x_cl."""
    if x.dtype not in _SUFFIX:
        x = x.to(dtype)
    x_cl = x.permute(0, 2, 3, 1)
    if x.dtype == dtype and x_cl.is_contiguous() and x_cl.data_ptr() % 16 == 0:
        return None, x_cl
    return x.contiguous(), torch.empty(x_cl.shape, device=x.device, dtype=dtype)


def _is_bf16(t: torch.Tensor | None) -> int:
    return int(t is not None and t.dtype == torch.bfloat16)


def deform_im2col(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor | None,
                  g: Geometry) -> torch.Tensor:
    """col (B, C·K, Ho·Wo) in :func:`col_dtype`: the ``deform_im2col``
    kernel on CUDA tensors, :func:`deform_im2col_reference` on CPU ones."""
    if x.device.type == "cpu":
        return deform_im2col_reference(x, offset, mask, g)
    dtype = col_dtype(x, mask)
    _check(g, x.device, dtype, x=x, offset=offset, mask=mask)
    col = torch.empty(g.B, g.C * g.K, g.Ho * g.Wo, device=x.device, dtype=dtype)
    x_nchw, x_cl = _channels_last(x, dtype)
    oc = offset.float().contiguous()
    mc = None if mask is None else mask.to(dtype).contiguous()
    _launch("deform_im2col", dtype, x, g, _ptr(x_nchw), _is_bf16(x_nchw), x_cl.data_ptr(),
            oc.data_ptr(), _ptr(mc), col.data_ptr())
    return col


def deform_col2im(grad_col: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor | None,
                  g: Geometry) -> torch.Tensor:
    """d_x (B, C, H, W) in fp32: the ``deform_col2im`` kernel on CUDA
    tensors (float4 atomic adds into a zeroed channels-last fp32 buffer,
    transposed to NCHW by the same entry point),
    :func:`deform_col2im_reference` on CPU ones."""
    if grad_col.device.type == "cpu":
        return deform_col2im_reference(grad_col, offset, mask, g)
    dtype = grad_col.dtype
    _check(g, grad_col.device, dtype, grad_col=grad_col, offset=offset, mask=mask)
    gc = grad_col.contiguous()
    oc = offset.float().contiguous()
    mc = None if mask is None else mask.to(dtype).contiguous()
    d_x_cl = torch.zeros(g.B, g.H, g.W, g.C, device=grad_col.device, dtype=torch.float32)
    d_x = torch.empty(g.B, g.C, g.H, g.W, device=grad_col.device, dtype=torch.float32)
    _launch("deform_col2im", dtype, grad_col, g, gc.data_ptr(), oc.data_ptr(), _ptr(mc),
            d_x_cl.data_ptr(), d_x.data_ptr())
    return d_x


def deform_col2im_coord(grad_col: torch.Tensor, x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor | None, g: Geometry):
    """(d_offset, d_mask or None), fp32: the ``deform_col2im_coord`` kernel
    on CUDA tensors (a block sums a group's channels itself: no atomics, the
    same bits from run to run; x gathered channels-last as for im2col),
    :func:`deform_col2im_coord_reference` on CPU ones."""
    if grad_col.device.type == "cpu":
        return deform_col2im_coord_reference(grad_col, x, offset, mask, g)
    dtype = grad_col.dtype
    _check(g, grad_col.device, dtype, grad_col=grad_col, x=x, offset=offset, mask=mask)
    gc = grad_col.contiguous()
    x_nchw, x_cl = _channels_last(x, dtype)
    oc = offset.float().contiguous()
    mc = None if mask is None else mask.to(dtype).contiguous()
    d_offset = torch.empty(g.B, g.dg * 2 * g.K, g.Ho, g.Wo, device=x.device)
    d_mask = None if mask is None else torch.empty(g.B, g.dg * g.K, g.Ho, g.Wo, device=x.device)
    _launch("deform_col2im_coord", dtype, x, g, gc.data_ptr(), _ptr(x_nchw), _is_bf16(x_nchw),
            x_cl.data_ptr(), oc.data_ptr(), _ptr(mc), d_offset.data_ptr(), _ptr(d_mask))
    return d_offset, d_mask


class _DeformConv(torch.autograd.Function):
    """im2col (kernel or plain) + matmul; the backward from the saved col."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, g):
        col = deform_im2col(x, offset, mask, g)
        ctx.save_for_backward(x, offset, mask, weight, col)
        ctx.g = g
        ctx.has_bias = bias is not None
        return _contract(col, weight, bias, g)

    @staticmethod
    def backward(ctx, grad_out):
        x, offset, mask, weight, col = ctx.saved_tensors
        g = ctx.g
        need_x, need_off, need_mask, need_w, need_b, _ = ctx.needs_input_grad
        dtype = torch.promote_types(col.dtype, weight.dtype)
        go = grad_out.reshape(g.B, weight.shape[0], g.Ho * g.Wo).to(dtype)
        d_x = d_off = d_mask = d_w = d_b = None
        if need_w:
            d_w = torch.matmul(go, col.to(dtype).transpose(1, 2)).sum(0)
            d_w = d_w.view(weight.shape).to(weight.dtype)
        if need_b and ctx.has_bias:
            d_b = grad_out.sum((0, 2, 3))
        if need_x or need_off or need_mask:
            w2 = weight.reshape(weight.shape[0], -1).to(dtype)
            grad_col = torch.matmul(w2.t(), go).to(col.dtype)
            if need_x:
                d_x = deform_col2im(grad_col, offset, mask, g).to(x.dtype)
            if need_off or need_mask:
                d_off, d_m = deform_col2im_coord(grad_col, x, offset, mask, g)
                d_off = d_off.to(offset.dtype)
                if need_mask:
                    d_mask = d_m.to(mask.dtype)
        return d_x, d_off, d_mask, d_w, d_b, None


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  mask: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                  stride: int = 1, padding: int = 0, dilation: int = 1,
                  deformable_groups: int = 1, max_offset: int | None = None,
                  pad_h: int | None = None, out_h: int | None = None) -> torch.Tensor:
    """(Modulated) deformable conv, NCHW.

    x (B, Cin, H, W); offset (B, dg·2K, Ho, Wo) in the layout of the module
    docstring; mask (B, dg·K, Ho, Wo) or None (DCNv1); weight (Cout, Cin,
    kh, kw); bias (Cout,) or None → (B, Cout, Ho, Wo).  ``max_offset=R``:
    the windowed sampling (stride and dilation 1).  ``pad_h`` and ``out_h``:
    the row origin and the output height (:func:`geometry`).  The CUDA
    kernels on CUDA tensors, the plain versions on CPU tensors."""
    kh, kw = weight.shape[2:]
    g = geometry(x.shape, kh, kw, stride, padding, dilation, deformable_groups, max_offset,
                 pad_h, out_h)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"deform_conv2d runs on CUDA or CPU tensors, got {x.device}")
    return _DeformConv.apply(x, offset, mask, weight, bias, g)


def modulated_deform_conv2d(x, offset, mask, weight, bias=None, **kwargs):
    """DCNv2 (reference ``deform_conv.py:116-119``)."""
    return deform_conv2d(x, offset, weight, mask=mask, bias=bias, **kwargs)


# ------------------------------------------------------------------ modules
# The reference's four classes (``dcn/deform_conv.py``): weight
# U(±1/√(Cin·k²)), bias zeros, the Pack variants' offset (+ mask) conv
# zero-initialised.  Under ``max_offset`` each call records its offsets'
# exceedance (``ops/telemetry.record_offset_exceedance``) while collecting.


def _dcn_weight(cin: int, cout: int, k: int, generator: torch.Generator) -> nn.Parameter:
    bound = 1.0 / math.sqrt(cin * k * k)
    w = torch.empty(cout, cin, k, k)
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(w)


def _zero_conv(cin: int, cout: int, k: int, stride: int, padding: int) -> nn.Conv2d:
    """A zero-initialised offset (+ mask) conv, in the promoted dtype of its
    input and parameters as flax's ``nn.Conv``."""
    from ..models.common import PromotedConv2d  # models import this module

    conv = PromotedConv2d(cin, cout, k, stride=stride, padding=padding)
    with torch.no_grad():
        conv.weight.zero_()
        conv.bias.zero_()
    return conv


#: deformable convs run under a spatial axis, by the x the kernels took:
#: the band with its window's rows (``band``), the gathered frame (``frame``)
SPATIAL_CALLS = {"band": 0, "frame": 0}


def spatial_operand(x: torch.Tensor, kh: int, padding: int, max_offset: int | None,
                    axis) -> tuple[torch.Tensor, int, str]:
    """The x the kernels take for this rank's band of output rows of a
    stride-1 deformable conv of ``x`` (…, H_local, W), and its row origin:
    ``(x, pad_h, kind)``.  Windowed (``max_offset=R``): the band with the
    frame rows a kept corner or the outer test can reach, padding + R + 1
    above and kh − 1 − padding + R + 1 below (R + 2 for EDVR's 3×3), cut
    where the frame ends, so that the kernels' outer test at the frame's
    border is the frame's; when the band cannot lend that many rows, and
    without a window, the frame gathered whole."""
    from ..parallel.halo import gather_frame, halo

    rows, S, i = x.shape[-2], axis.size, axis.index
    if max_offset is not None:
        k = max(padding, kh - 1 - padding) + int(max_offset) + 1
        if k <= rows:
            xh = halo(x, k, axis)
            above, below = (k if i > 0 else 0), (k if i < S - 1 else 0)
            return xh[..., k - above:k + rows + below, :], padding - above, "band"
    return gather_frame(x, axis), padding - i * rows, "frame"


class DeformConv(nn.Module):
    """DCNv1 with external offsets (reference ``:151-198``): no bias unless
    ``bias=True``.  Under a spatial axis (stride 1, 'same' padding) each
    rank computes its band of output rows (:func:`spatial_operand`)."""

    #: the spatial axis (``parallel/halo.shard_spatially``)
    spatial_axis = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 deformable_groups: int = 1, bias: bool = False, max_offset: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.dilation, self.deformable_groups, self.max_offset = dilation, deformable_groups, max_offset
        self.weight = _dcn_weight(in_channels, out_channels, kernel_size, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def _conv(self, x, offset, mask=None):
        axis = self.spatial_axis
        if self.max_offset is not None:
            telemetry.record_offset_exceedance(self, offset, self.deformable_groups,
                                               self.max_offset, axis=axis)
        pad_h = out_h = None
        if axis is not None:
            if self.stride != 1 or self.dilation != 1 or offset.shape[-2] != x.shape[-2]:
                raise ValueError("a sharded deformable conv takes stride 1, dilation 1 and "
                                 "'same' padding")
            out_h = x.shape[-2]
            x, pad_h, kind = spatial_operand(x, self.kernel_size, self.padding, self.max_offset,
                                             axis)
            SPATIAL_CALLS[kind] += 1
        return deform_conv2d(x, offset, self.weight, mask=mask, bias=self.bias,
                             stride=self.stride, padding=self.padding, dilation=self.dilation,
                             deformable_groups=self.deformable_groups, max_offset=self.max_offset,
                             pad_h=pad_h, out_h=out_h)

    def forward(self, x, offset):
        return self._conv(x, offset)


class ModulatedDeformConv(DeformConv):
    """DCNv2 with external offsets and mask (reference ``:221-257``)."""

    def __init__(self, *args, bias: bool = True, **kwargs):
        super().__init__(*args, bias=bias, **kwargs)

    def forward(self, x, offset, mask):
        return self._conv(x, offset, mask)


class DeformConvPack(DeformConv):
    """DCNv1 making its own offsets with a zero-initialised conv
    ``conv_offset`` (reference ``:200-218``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, **kwargs):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, **kwargs)
        k, dg = kernel_size, self.deformable_groups
        self.conv_offset = _zero_conv(in_channels, dg * 2 * k * k, k, stride, padding)

    def forward(self, x):
        return self._conv(x, self.conv_offset(x))


class ModulatedDeformConvPack(DeformConv):
    """DCNv2 making offsets and a sigmoid mask with a zero-initialised conv
    ``conv_offset_mask``; ``extra_offset_mask`` reads it from separate offset
    features (EDVR's mode, reference ``:259-291``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, extra_offset_mask: bool = False,
                 offset_in_channels: int | None = None, **kwargs):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         bias=True, **kwargs)
        k, dg = kernel_size, self.deformable_groups
        self.extra_offset_mask = extra_offset_mask
        self.conv_offset_mask = _zero_conv(offset_in_channels or in_channels, dg * 3 * k * k, k,
                                           stride, padding)

    def forward(self, x, offset_features=None):
        om = self.conv_offset_mask(offset_features if self.extra_offset_mask else x)
        o1, o2, mask = torch.chunk(om, 3, dim=1)
        return self._conv(x, torch.cat([o1, o2], dim=1), torch.sigmoid(mask))


__all__ = ["deform_conv2d", "modulated_deform_conv2d", "deform_conv2d_reference",
           "deform_im2col", "deform_col2im", "deform_col2im_coord", "deform_im2col_reference",
           "deform_col2im_reference", "deform_col2im_coord_reference", "geometry", "Geometry",
           "DeformConv", "ModulatedDeformConv", "DeformConvPack", "ModulatedDeformConvPack",
           "LAUNCHES", "BF16_LAUNCHES", "TRACE_NAMES", "trace_share", "reset_launches",
           "SPATIAL_CALLS", "spatial_operand"]
