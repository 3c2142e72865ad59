"""The port's deformable convolution (``ops/deform_conv.py``) against the JAX package's on the CPU.

On CPU tensors ``deform_conv2d`` runs the plain versions of the three
kernels (im2col, col2im, col2im_coord) inside the same autograd function
that launches the kernels on the card; these tests hold it to

* the JAX package's ``deform_conv2d`` (gathers) and
  ``deform_conv2d_windowed`` (``max_offset`` 2): the output and the
  gradients of ``sum(out · w)`` in x, offset, mask, weight and bias (JAX's
  ``jax.vjp``), over stride, padding, dilation, 1 and 2 deformable groups,
  with and without a mask, at fractional offsets that reach outside the
  image, at zero offsets (the integer knife edge, where the bilinear
  derivative is the one-sided difference) and beyond the window;
* ``tests/dcn_oracle.modulated_deform_conv_naive``, the scalar-loop oracle
  of the reference's CUDA semantics (forward);
* itself: the explicit backward plain versions against autograd of the
  plain im2col, zero offsets with a unit mask against ``F.conv2d``, and
  offsets at or beyond R + 1 contributing exactly nothing;
* the four module wrappers with weights carried from the JAX modules.

Tolerances, each measured on these inputs (numpy, seeded): outputs 1e-5
absolute (4.8e-7 measured); the gradients in x, offset and mask 2e-5
(9.5e-7), in weight and bias 2e-5 (4.8e-6: sums over every pixel); the
naive oracle 1e-5 (3.9e-7); the backward plain versions against autograd
1e-5 (9.5e-7).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.ops import (
    deform_conv as jax_dcn,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.ops import (
    telemetry as jax_telemetry,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
    deform_conv as dcn,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
    telemetry,
)
from dcn_oracle import modulated_deform_conv_naive

TOL_OUT = 1e-5
TOL_GRAD = 2e-5
K = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, stride=1, pad=1, dil=1, dg=2, with_mask=True, offsets="fractional",
          max_offset=None, B=2, C=4, H=7, W=8, Cout=3):
    """Seeded NCHW operands and the cotangent of the output."""
    rng = np.random.default_rng(seed)
    g = dcn.geometry((B, C, H, W), K, K, stride, pad, dil, dg, max_offset)
    shape_off = (B, dg * 2 * K * K, g.Ho, g.Wo)
    if offsets == "fractional":  # reaches outside the 7x8 image from the border taps
        off = rng.uniform(-2.5, 2.5, shape_off)
    elif offsets == "zero":
        off = np.zeros(shape_off)
    elif offsets == "outside":  # most samples land outside the image
        off = rng.uniform(-9.0, 9.0, shape_off)
    elif offsets == "edvr":  # EDVR-like: N(0, 0.5 px) clipped to +-1.5 px
        off = np.clip(rng.normal(0.0, 0.5, shape_off), -1.5, 1.5)
    elif offsets == "beyond":  # |o| in (R, R + 1.5): partly or wholly out of the window
        off = rng.uniform(2.0, 3.5, shape_off) * rng.choice([-1.0, 1.0], shape_off)
    else:
        raise ValueError(offsets)
    arrays = {
        "x": rng.standard_normal((B, C, H, W)),
        "offset": off,
        "mask": rng.uniform(0, 1, (B, dg * K * K, g.Ho, g.Wo)) if with_mask else None,
        "weight": rng.standard_normal((Cout, C, K, K)) * 0.3,
        "bias": rng.standard_normal(Cout),
        "cot": rng.standard_normal((B, Cout, g.Ho, g.Wo)),
    }
    arrays = {k: None if v is None else v.astype(np.float32) for k, v in arrays.items()}
    kwargs = dict(stride=stride, padding=pad, dilation=dil, deformable_groups=dg,
                  max_offset=max_offset)
    return arrays, kwargs


_NAMES = ("x", "offset", "mask", "weight", "bias")


def _port(arrays, kwargs):
    """The port's output and the gradients of sum(out · cot)."""
    leaves = {k: None if arrays[k] is None else torch.from_numpy(arrays[k]).requires_grad_()
              for k in _NAMES}
    out = dcn.deform_conv2d(leaves["x"], leaves["offset"], leaves["weight"], leaves["mask"],
                            leaves["bias"], **kwargs)
    (out * torch.from_numpy(arrays["cot"])).sum().backward()
    grads = {k: None if v is None else v.grad.numpy() for k, v in leaves.items()}
    return out.detach().numpy(), grads


def _jax(arrays, kwargs, fn=jax_dcn.deform_conv2d):
    """JAX's output and ``jax.vjp`` gradients, NCHW in and out."""
    names = [k for k in _NAMES if arrays[k] is not None]

    def f(*vals):
        a = dict(zip(names, vals))
        nhwc = lambda t: None if t is None else t.transpose(0, 2, 3, 1)  # noqa: E731
        out = fn(nhwc(a["x"]), nhwc(a["offset"]), a["weight"].transpose(2, 3, 1, 0),
                 mask=nhwc(a.get("mask")), bias=a["bias"], **kwargs)
        return out.transpose(0, 3, 1, 2)

    out, vjp = jax.vjp(f, *[jnp.asarray(arrays[k]) for k in names])
    grads = dict(zip(names, (np.asarray(g) for g in vjp(jnp.asarray(arrays["cot"])))))
    return np.asarray(out), grads


def _assert_matches_jax(arrays, kwargs, fn=jax_dcn.deform_conv2d):
    got, got_g = _port(arrays, kwargs)
    want, want_g = _jax(arrays, kwargs, fn)
    np.testing.assert_allclose(got, want, atol=TOL_OUT, rtol=0)
    for k in _NAMES:
        if arrays[k] is None:
            assert got_g[k] is None
            continue
        np.testing.assert_allclose(got_g[k], want_g[k], atol=TOL_GRAD, rtol=0, err_msg=k)
    return got, got_g


GATHER_CASES = {
    "s1p1d1-dg1": dict(dg=1),
    "s1p1d1-dg2": dict(dg=2),
    "s1p1d1-dg2-nomask": dict(dg=2, with_mask=False),
    "s2p1d1-dg2": dict(stride=2, dg=2),
    "s1p2d2-dg1": dict(pad=2, dil=2, dg=1),
    "s2p0d2-dg2-nomask": dict(stride=2, pad=0, dil=2, dg=2, with_mask=False),
    "zero-offsets": dict(offsets="zero"),
    "zero-offsets-nomask": dict(offsets="zero", with_mask=False, dg=1),
    "outside-image": dict(offsets="outside"),
    # EDVR's group width (16 channels) and two of its 16-channel chunks:
    # the widths the card's col2im_coord block walks
    "s1p1d1-dg2-c32": dict(dg=2, C=32),
    "s1p1d1-dg2-c64": dict(dg=2, C=64),
    # the offsets a trained EDVR draws, as chip_smoke.py phase 19 holds the
    # kernels at them; dg 8 of 16 channels is EDVR's own group layout
    "edvr-offsets-dg2-c32": dict(dg=2, C=32, offsets="edvr"),
    "edvr-offsets-dg2-c64-nomask": dict(dg=2, C=64, offsets="edvr", with_mask=False),
    "edvr-offsets-dg8-c128": dict(dg=8, C=128, offsets="edvr"),
}


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_plain_version_matches_jax_gather(case):
    arrays, kwargs = _case(list(GATHER_CASES).index(case), **GATHER_CASES[case])
    _assert_matches_jax(arrays, kwargs)


WINDOW_CASES = {
    "in-window-dg2": dict(dg=2, offsets="fractional"),
    "in-window-dg1-nomask": dict(dg=1, offsets="fractional", with_mask=False),
    "zero-offsets": dict(offsets="zero"),
    "beyond-window": dict(offsets="beyond"),
    "pad0-dg2": dict(pad=0, offsets="beyond"),
    "in-window-dg2-c32": dict(dg=2, C=32, offsets="fractional"),
    "in-window-dg2-c64": dict(dg=2, C=64, offsets="fractional"),
    "edvr-offsets-dg2-c32": dict(dg=2, C=32, offsets="edvr"),
    "edvr-offsets-dg8-c128": dict(dg=8, C=128, offsets="edvr"),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_windowed_plain_version_matches_jax_windowed(case):
    arrays, kwargs = _case(list(WINDOW_CASES).index(case) + 20, max_offset=2,
                           **WINDOW_CASES[case])
    _assert_matches_jax(arrays, kwargs,
                        fn=lambda *a, max_offset, stride, dilation, **kw:
                        jax_dcn.deform_conv2d_windowed(*a, max_offset=max_offset, **kw))


@pytest.mark.parametrize("dg,with_mask,stride,pad,dil", [(1, True, 1, 1, 1), (2, False, 2, 2, 2),
                                                         (2, True, 1, 0, 1)])
def test_plain_forward_matches_naive_oracle(dg, with_mask, stride, pad, dil):
    arrays, kwargs = _case(3, stride, pad, dil, dg, with_mask, B=1, C=4, H=6, W=7)
    got, _ = _port(arrays, kwargs)
    want = modulated_deform_conv_naive(arrays["x"], arrays["offset"], arrays["mask"],
                                       arrays["weight"], arrays["bias"], stride, pad, dil, 1, dg)
    np.testing.assert_allclose(got, want, atol=TOL_OUT, rtol=0)


def test_zero_offsets_at_the_border_take_the_one_sided_derivative():
    """At zero offsets every sample sits on an integer point; along the last
    row the lower corner is outside the image, so d_offset_y there is
    −(the sample), not (below − here); on row −1 (pad) the outer test fails
    and the gradient is 0.  Exact and windowed paths alike, against JAX."""
    arrays, kwargs = _case(31, dg=2, offsets="zero")
    _, grads = _assert_matches_jax(arrays, kwargs)
    _, grads_w = _assert_matches_jax(
        arrays, {**kwargs, "max_offset": 2},
        fn=lambda *a, max_offset, stride, dilation, **kw:
        jax_dcn.deform_conv2d_windowed(*a, max_offset=max_offset, **kw))
    np.testing.assert_allclose(grads_w["offset"], grads["offset"], atol=TOL_GRAD, rtol=0)
    # tap (0, ·) of output row 0 samples row −1: outside, no gradient
    d_off = grads["offset"].reshape(2, 2, K * K, 2, 7, 8)
    assert np.all(d_off[:, :, 0:3, 0, 0, :] == 0)
    # by hand at tap (2, 1) of output row H−2 = 5 (samples row 6 = H−1)
    g = dcn.geometry((2, 4, 7, 8), K, K, 1, 1, 1, 2)
    x, m, cot, w = (torch.from_numpy(arrays[k]) for k in ("x", "mask", "cot", "weight"))
    grad_col = (w.reshape(3, -1).t() @ cot.reshape(2, 3, -1)).reshape(2, 2, 2, K * K, 7, 8)
    tap, ho, wo = 7, 5, 3
    sample = x.reshape(2, 2, 2, 7, 8)[:, :, :, 6, wo]  # (B, dg, Cg) at the integer point
    by_hand = -(grad_col[:, :, :, tap, ho, wo] * sample).sum(2) * m.reshape(
        2, 2, K * K, 7, 8)[:, :, tap, ho, wo]
    np.testing.assert_allclose(d_off[:, :, tap, 0, ho, wo], by_hand.numpy(), atol=TOL_GRAD)


@pytest.mark.parametrize("R", [1, 2])
def test_offsets_beyond_the_window_contribute_exactly_nothing(R):
    arrays, kwargs = _case(5, dg=2, max_offset=R)
    rng = np.random.default_rng(6)
    off = arrays["offset"]
    arrays["offset"] = (np.sign(rng.standard_normal(off.shape)) *
                        rng.uniform(R + 1, R + 4, off.shape)).astype(np.float32)
    out, grads = _port(arrays, kwargs)
    np.testing.assert_array_equal(out, np.broadcast_to(arrays["bias"].reshape(1, -1, 1, 1),
                                                       out.shape))
    for k in ("x", "offset", "mask", "weight"):
        assert np.all(grads[k] == 0), k
    # the exact path samples there
    exact, _ = _port(arrays, {**kwargs, "max_offset": None})
    assert np.abs(exact - out).max() > 1e-2


@pytest.mark.parametrize("stride,dil", [(1, 1), (2, 2)])
def test_zero_offsets_and_a_unit_mask_are_the_dense_conv(stride, dil):
    arrays, kwargs = _case(9, stride=stride, pad=dil, dil=dil, dg=2, offsets="zero")
    arrays["mask"] = np.ones_like(arrays["mask"])
    got, _ = _port(arrays, kwargs)
    want = F.conv2d(torch.from_numpy(arrays["x"]), torch.from_numpy(arrays["weight"]),
                    torch.from_numpy(arrays["bias"]), stride=stride, padding=dil, dilation=dil)
    np.testing.assert_allclose(got, want.numpy(), atol=TOL_OUT, rtol=0)


@pytest.mark.parametrize("max_offset", [None, 2], ids=["exact", "windowed"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_backward_plain_versions_equal_autograd_of_the_im2col(max_offset, with_mask):
    arrays, _ = _case(11, dg=2, with_mask=with_mask, offsets="beyond" if max_offset else "outside")
    g = dcn.geometry(arrays["x"].shape, K, K, 1, 1, 1, 2, max_offset)
    x, off = (torch.from_numpy(arrays[k]).requires_grad_() for k in ("x", "offset"))
    m = torch.from_numpy(arrays["mask"]).requires_grad_() if with_mask else None
    col = dcn.deform_im2col_reference(x, off, m, g)
    grad_col = torch.randn(col.shape, generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(col, [t for t in (x, off, m) if t is not None], grad_col)
    d_x = dcn.deform_col2im(grad_col, off.detach(), None if m is None else m.detach(), g)
    d_off, d_m = dcn.deform_col2im_coord(grad_col, x.detach(), off.detach(),
                                         None if m is None else m.detach(), g)
    got = [d_x, d_off] + ([d_m] if with_mask else [])
    assert (d_m is None) == (not with_mask)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL_OUT, rtol=0)


def test_cpu_tensors_launch_nothing_and_bad_shapes_raise():
    before = dict(dcn.LAUNCHES)
    arrays, kwargs = _case(2)
    _port(arrays, kwargs)
    assert dcn.LAUNCHES == before
    with pytest.raises(ValueError, match="not divisible"):
        dcn.deform_conv2d(torch.zeros(1, 3, 5, 5), torch.zeros(1, 36, 5, 5),
                          torch.zeros(2, 3, 3, 3), padding=1, deformable_groups=2)


def test_bf16_operands_follow_jax_promotion():
    """col is in the promoted dtype of x and the mask, the product in that of
    col and the weight (a bf16 x with an fp32 mask computes in fp32)."""
    arrays, kwargs = _case(4)
    x = torch.from_numpy(arrays["x"])
    off, w = torch.from_numpy(arrays["offset"]), torch.from_numpy(arrays["weight"])
    m = torch.from_numpy(arrays["mask"])
    bf = torch.bfloat16
    assert dcn.deform_conv2d(x.to(bf), off, w.to(bf), m.to(bf), **kwargs).dtype == bf
    assert dcn.deform_conv2d(x.to(bf), off, w.to(bf), m, **kwargs).dtype == torch.float32
    full = dcn.deform_conv2d(x, off, w, m, **kwargs)
    half = dcn.deform_conv2d(x.to(bf), off.to(bf), w.to(bf), m.to(bf), **kwargs)
    assert (half.float() - full).abs().max() < 0.1 * full.abs().max()


# ------------------------------------------------------------------ modules
def _jax_module_params(mod, *inputs):
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), *inputs)["params"]
    rng = np.random.default_rng(21)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32), shapes)


def _w_oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


MODULES = ["DeformConv", "ModulatedDeformConv", "DeformConvPack", "ModulatedDeformConvPack"]


@pytest.mark.parametrize("max_offset", [None, 2], ids=["exact", "windowed"])
@pytest.mark.parametrize("name", MODULES)
def test_module_wrappers_match_jax_with_carried_weights(name, max_offset):
    B, C, H, W, Cout, dg = 2, 4, 6, 7, 5, 2
    rng = np.random.default_rng(13)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    off = rng.uniform(-2.5, 2.5, (B, H, W, dg * 2 * K * K)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, H, W, dg * K * K)).astype(np.float32)
    extra = {"DeformConv": (off,), "ModulatedDeformConv": (off, mask)}.get(name, ())
    jmod = getattr(jax_dcn, name)(features=Cout, kernel_size=K, padding=1, deformable_groups=dg,
                                  max_offset=max_offset)
    params = _jax_module_params(jmod, x, *extra)
    want, state = jmod.apply({"params": params}, x, *extra, mutable=["telemetry"])

    pmod = getattr(dcn, name)(C, Cout, K, padding=1, deformable_groups=dg, max_offset=max_offset)
    sd = {"weight": _w_oihw(params["weight"])}
    if "bias" in params:
        sd["bias"] = torch.from_numpy(np.asarray(params["bias"]))
    for conv in ("conv_offset", "conv_offset_mask"):
        if conv in params:
            sd[f"{conv}.weight"] = _w_oihw(params[conv]["kernel"])
            sd[f"{conv}.bias"] = torch.from_numpy(np.asarray(params[conv]["bias"]))
    pmod.load_state_dict(sd, strict=True)
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa: E731
    with telemetry.collect(pmod) as col:
        got = pmod(nchw(x), *[nchw(a) for a in extra])
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=TOL_OUT, rtol=0)
    summary = col.summary()
    if max_offset is None:
        assert summary == {}
    else:  # the JAX module's sown triple
        want_s = jax_telemetry.summarize(state["telemetry"])
        assert list(summary) == ["dcn_offset_window"] == [p.split("/")[-1] for p in want_s]
        for key in ("n", "frac_out", "max_abs"):
            np.testing.assert_allclose(summary["dcn_offset_window"][key],
                                       list(want_s.values())[0][key], rtol=1e-6)


def test_pack_modules_start_at_zero_offsets():
    """The packs' offset convs start at zero: the DCNv1 pack is the dense
    conv, the DCNv2 pack half of it (mask sigmoid(0))."""
    x = torch.randn(2, 4, 6, 7, generator=torch.Generator().manual_seed(0))
    for cls, scale in ((dcn.DeformConvPack, 1.0), (dcn.ModulatedDeformConvPack, 0.5)):
        mod = cls(4, 3, 3, padding=1)
        assert all(torch.count_nonzero(p) == 0 for n, p in mod.named_parameters()
                   if n.startswith("conv_offset"))
        bias = mod.bias if mod.bias is not None else None
        want = F.conv2d(x, mod.weight * scale, None, padding=1)
        if bias is not None:
            want = want + bias.view(1, -1, 1, 1)
        np.testing.assert_allclose(mod(x).detach().numpy(), want.detach().numpy(), atol=TOL_OUT)


@pytest.mark.parametrize("memory_format", [torch.contiguous_format, torch.channels_last])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gathers_take_x_channels_last_or_a_transposed_copy(memory_format, x_dtype, dtype):
    """The im2col and col2im_coord entry points gather from x in (B, H, W,
    C) of the kernel's dtype: a channels-last x of that dtype is used as it
    is, any other goes to the entry point's transpose with a new buffer."""
    x = torch.randn(2, 16, 5, 7).to(x_dtype).to(memory_format=memory_format)
    x_nchw, x_cl = dcn._channels_last(x, dtype)
    assert tuple(x_cl.shape) == (2, 5, 7, 16) and x_cl.dtype == dtype and x_cl.is_contiguous()
    if memory_format == torch.channels_last and x_dtype == dtype:
        assert x_nchw is None and x_cl.data_ptr() == x.data_ptr()
    else:
        assert x_nchw.is_contiguous() and torch.equal(x_nchw, x)
        assert x_cl.data_ptr() != x.data_ptr()

