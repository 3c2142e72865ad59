"""The port's EDVR (``models/edvr_net.py``) against the JAX package's on the CPU.

A small EDVR (nf 16, 2 deformable groups, one residual block each side, 5
frames) on LR frames of 10×11, which the net pads to 12×12 and crops back.
The JAX net's parameters have the structure of its ``init``
(``jax.eval_shape``) and seeded values: kernels U(±1/√fan_in), biases
U(±0.05), and the offset convs N(0, 0.05), so that the offsets are
fractional (|offset| up to ~2 px) and every DCN samples off the integer
grid.  They reach the port through ``state_dict_from_jax_params(…,
"EDVRNet")`` with ``strict=True``.

* Exact DCN (``dcn_max_offset`` None): the output, the input's gradient and
  every parameter's gradient of ``sum(out · w)`` against
  ``jax.value_and_grad`` at atol 5e-5 / rtol 1e-4 (the multi-frame
  family's tolerance; measured 4.8e-7 on outputs of 2.9, 4.1e-5 on input
  gradients of 8.3, 3.5e-6 of the largest element on parameter
  gradients).  This is also one training step's loss and gradients.
* Windowed DCN (``dcn_max_offset`` 2): the output and the four
  ``pcd_align/{L3,L2,L1,cas}_dcnpack/dcn_offset_window`` sites (paths,
  counts and ``max_abs``; the five neighbours' calls merged into one
  triple a site) against JAX's ``telemetry`` collection; the gradients
  against the exact net's at zero offsets (where the window is exact),
  the JAX package's own check of its windowed net.  (JAX's gradient of the
  windowed net, 225 shifted products a DCN call, takes minutes on the CPU;
  ``tests/test_torch_deform_conv.py`` holds the windowed DCN's gradients
  to JAX's at the op and module level.)
* The ``predeblur``, ``HR_in`` and ``w_TSA=False`` branches: the output
  against JAX's, the port's seeded weights carried into JAX by its key
  map; the predeblur pyramid's output and gradients at the module level.
* Keys: the port's ``state_dict`` through the JAX package's
  ``variables_from_torch_state_dict`` and back is bit-exact, every branch,
  and has the JAX init's structure and shapes.
* bf16: the port's bf16-vs-fp32 output gap is 0.6–1.5× JAX's (the bound of
  ``tests/test_torch_tpu_knobs.py``).  Both compute most of the net in fp32
  (the fp32 resize products promote from the L2 offsets on), so the gap is
  about that of the bf16-rounded input frames and L3 level: rounding only
  the outputs gives a gap of the same size, and the bound cannot tell the
  two apart here, as it does for RefineNet.
* The five edvr_net YAMLs resolve, and their nets construct at the
  published width with the JAX net's parameter count (``chip_smoke.py``
  runs them at that width on the card).
"""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import models as jax_models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.models import (
    edvr_net as jax_edvr,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.ops import (
    telemetry as jax_telemetry,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.casting import (
    cast_floating as jax_cast_floating,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.torch_import import (
    variables_from_torch_state_dict,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import (
    NETS,
    load_config,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
    _import_components,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
    edvr_net,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
    telemetry,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.casting import (
    forward_in,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(in_channels=1, out_channels=1, nf=16, nframes=5, groups=2, front_RBs=1, back_RBs=1)
B, N, LR_HW = 2, 5, (10, 11)
TOL = dict(atol=5e-5, rtol=1e-4)
BF16_GAP_RATIO = (0.6, 1.5)
DCN_SITES = sorted(f"pcd_align/{lvl}_dcnpack/dcn_offset_window" for lvl in ("L3", "L2", "L1", "cas"))
EDVR_YAMLS = sorted(p for sub in ("test", "train")
                    for p in (REPO / "configs" / sub / "edvr_net").glob("*.yaml"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lr(seed=0, hw=LR_HW):
    return np.random.default_rng(seed).standard_normal((B, N, *hw, 1)).astype(np.float32)


def _jax_params(shapes: dict, seed: int = 1) -> dict:
    """Seeded parameters of the JAX net's ``init`` structure ``shapes``."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        keys = [getattr(k, "key", "") for k in path]
        if "conv_offset_mask" in keys:
            return rng.normal(0.0, 0.05, s.shape).astype(np.float32)
        if len(s.shape) == 4:  # (kh, kw, in, out)
            bound = 1.0 / math.sqrt(np.prod(s.shape[:3]))
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        return rng.uniform(-0.05, 0.05, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_net(kwargs: dict, params: dict) -> models.EDVRNet:
    net = models.EDVRNet(**kwargs)
    net.load_state_dict(state_dict_from_jax_params({"params": params}, "EDVRNet"), strict=True)
    return net


# ------------------------------------------------------------ exact DCN, grads
@pytest.fixture(scope="module")
def exact_pair():
    """JAX's and the port's output and gradients of sum(out · w), exact DCN."""
    lr = _lr()
    shapes = jax.eval_shape(jax_models.EDVRNet(**SMALL).init, jax.random.PRNGKey(0), lr)["params"]
    params = _jax_params(shapes)
    net = jax_models.EDVRNet(**SMALL)
    wts = np.random.default_rng(2).standard_normal((B, 40, 44, 1)).astype(np.float32)
    (value, out), (g_params, g_lr) = jax.value_and_grad(
        lambda p, x: (lambda o: (jnp.sum(o * wts), o))(net.apply({"params": p}, x)),
        argnums=(0, 1), has_aux=True)(params, lr)
    port = _port_net(SMALL, params)
    x = torch.from_numpy(lr).requires_grad_()
    got = port(x)
    loss = (got * torch.from_numpy(wts)).sum()
    loss.backward()
    want_grads = state_dict_from_jax_params(jax.tree.map(np.asarray, g_params), "EDVRNet")
    return {"shapes": shapes, "params": params, "lr": lr, "jax_out": np.asarray(out), "jax_loss": float(value),
            "jax_dx": np.asarray(g_lr), "jax_grads": want_grads, "port": port,
            "port_out": got.detach().numpy(), "port_loss": loss.item(), "port_dx": x.grad.numpy()}


def test_exact_output_matches_jax(exact_pair):
    assert exact_pair["port_out"].shape == (B, 40, 44, 1)
    np.testing.assert_allclose(exact_pair["port_out"], exact_pair["jax_out"], **TOL)
    np.testing.assert_allclose(exact_pair["port_loss"], exact_pair["jax_loss"], rtol=1e-5)


def test_exact_input_gradient_matches_jax(exact_pair):
    np.testing.assert_allclose(exact_pair["port_dx"], exact_pair["jax_dx"], **TOL)


def test_exact_parameter_gradients_match_jax(exact_pair):
    port, want = exact_pair["port"], exact_pair["jax_grads"]
    names = {n for n, _ in port.named_parameters()}
    assert names == set(want)
    for name, p in port.named_parameters():
        scale = want[name].abs().max().item()
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0,
                                   atol=max(TOL["atol"], TOL["rtol"] * scale), err_msg=name)
    # the DCN packs' offset convs are trained: their gradients are not zero
    assert port.pcd_align.L1_dcnpack.conv_offset_mask.weight.grad.abs().max() > 0


# ------------------------------------------------------------- windowed DCN
@pytest.fixture(scope="module")
def windowed_pair(exact_pair):
    kwargs = dict(SMALL, dcn_max_offset=2)
    params, lr = exact_pair["params"], exact_pair["lr"]
    out, state = jax_models.EDVRNet(**kwargs).apply({"params": params}, lr, mutable=["telemetry"])
    port = _port_net(kwargs, params)
    with torch.no_grad(), telemetry.collect(port) as col:
        got = port(torch.from_numpy(lr))
    return {"jax_out": np.asarray(out), "jax_tel": jax_telemetry.summarize(state["telemetry"]),
            "port_out": got.numpy(), "port_tel": col.summary(), "exact_out": exact_pair["port_out"]}


def test_windowed_output_matches_jax(windowed_pair):
    np.testing.assert_allclose(windowed_pair["port_out"], windowed_pair["jax_out"], **TOL)
    # offsets of up to ~2 px with R = 2: some corners drop, the output moves
    assert np.abs(windowed_pair["port_out"] - windowed_pair["exact_out"]).max() > 0


def test_windowed_telemetry_sites_match_jax(windowed_pair):
    got, want = windowed_pair["port_tel"], windowed_pair["jax_tel"]
    assert sorted(got) == sorted(want) == DCN_SITES
    for site in DCN_SITES:
        assert got[site]["n"] == want[site]["n"]  # 5 neighbours × B·h·w·dg·K samples
        np.testing.assert_allclose(got[site]["max_abs"], want[site]["max_abs"], rtol=1e-5)
        np.testing.assert_allclose(got[site]["frac_out"], want[site]["frac_out"], atol=1e-6)
    assert got["pcd_align/L1_dcnpack/dcn_offset_window"]["n"] == N * B * 12 * 12 * 2 * 9


def test_exact_net_records_no_telemetry_and_nothing_outside_collect(exact_pair):
    port = exact_pair["port"]
    with torch.no_grad(), telemetry.collect(port) as col:
        port(torch.from_numpy(exact_pair["lr"][:, :, :8, :8]))
    assert col.summary() == {}
    assert all("_telemetry" not in m.__dict__ for m in port.modules())


def test_windowed_gradients_equal_exact_ones_at_zero_offsets():
    """At the zero-init offsets every |offset| is 0 ≤ R: the windowed net's
    output and gradients, offset convs included, equal the exact net's."""
    grads = {}
    for R in (None, 2):
        net = models.EDVRNet(**SMALL, dcn_max_offset=R, generator=torch.Generator().manual_seed(3))
        x = torch.from_numpy(_lr(4)).requires_grad_()
        (net(x) ** 2).mean().backward()
        grads[R] = {n: p.grad for n, p in net.named_parameters()} | {"x": x.grad}
    for name, g in grads[None].items():
        np.testing.assert_allclose(grads[2][name].numpy(), g.numpy(), rtol=0,
                                   atol=1e-6 * max(1.0, g.abs().max().item()), err_msg=name)
    assert grads[2]["pcd_align.cas_dcnpack.conv_offset_mask.weight"].abs().max() > 0


# ----------------------------------------------------------------- branches
BRANCHES = {
    "predeblur": (dict(predeblur=True), LR_HW),
    "HR_in": (dict(HR_in=True), (48, 48)),
    "no_TSA": (dict(w_TSA=False), LR_HW),
}


def _offset_net(kwargs: dict, seed: int) -> models.EDVRNet:
    """The port's seeded net with its offset convs drawn off zero."""
    net = models.EDVRNet(**kwargs, generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "conv_offset_mask" in name:
                p.normal_(0.0, 0.05, generator=gen)
    return net


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branch_output_matches_jax(branch):
    """Weights from the port's init into JAX through its key map, whose
    ``apply`` then finds every parameter of the branch's net."""
    extra, hw = BRANCHES[branch]
    kwargs = dict(SMALL, **extra)
    lr = _lr(5, hw)
    net = _offset_net(kwargs, 6)
    variables = variables_from_torch_state_dict("EDVRNet", net.state_dict())
    want = jax_models.EDVRNet(**kwargs).apply({"params": variables["params"]}, lr)
    with torch.no_grad():
        got = net(torch.from_numpy(lr))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_predeblur_pyramid_and_its_gradients_match_jax():
    nf = 8
    x = np.random.default_rng(7).standard_normal((2, 12, 12, 1)).astype(np.float32)
    jmod = jax_edvr.PredeblurPyramid(1, nf, False)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(8)
    params = jax.tree.map(lambda s: rng.uniform(-0.3, 0.3, s.shape).astype(np.float32), shapes)
    wts = np.random.default_rng(9).standard_normal((2, 12, 12, nf)).astype(np.float32)
    (_, out), (gp, gx) = jax.value_and_grad(
        lambda p, a: (lambda o: (jnp.sum(o * wts), o))(jmod.apply({"params": p}, a)),
        argnums=(0, 1), has_aux=True)(params, x)
    mod = edvr_net.PredeblurPyramid(1, nf, False, torch.Generator().manual_seed(0))
    sd = {k[len("pre_deblur."):]: v for k, v in state_dict_from_jax_params(
        {"params": {"pre_deblur": params}}, "EDVRNet").items()}
    mod.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_()
    got = mod(xt)
    (got * torch.from_numpy(np.ascontiguousarray(wts.transpose(0, 3, 1, 2)))).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx), **TOL)
    want = {k[len("pre_deblur."):]: v for k, v in state_dict_from_jax_params(
        {"params": {"pre_deblur": jax.tree.map(np.asarray, gp)}}, "EDVRNet").items()}
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **TOL, err_msg=name)


# ---------------------------------------------------------------------- keys
@pytest.mark.parametrize("extra", [{}, {"predeblur": True}, {"HR_in": True}, {"w_TSA": False}],
                         ids=["default", "predeblur", "HR_in", "no_TSA"])
def test_state_dict_round_trips_through_the_jax_key_map(extra):
    net = models.EDVRNet(**SMALL, **extra, generator=torch.Generator().manual_seed(0))
    sd = net.state_dict()
    variables = variables_from_torch_state_dict("EDVRNet", sd)
    back = state_dict_from_jax_params(variables, "EDVRNet")
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_jax_variables_have_the_init_structure(exact_pair):
    """The carried variables have the JAX init's tree and shapes."""
    variables = variables_from_torch_state_dict("EDVRNet", exact_pair["port"].state_dict())
    shapes = exact_pair["shapes"]
    assert jax.tree.structure(variables["params"]) == jax.tree.structure(shapes)
    assert all(np.shape(a) == s.shape for a, s in zip(jax.tree.leaves(variables["params"]),
                                                      jax.tree.leaves(shapes)))


def test_dcn_pack_init_is_the_reference_init():
    net = models.EDVRNet(**SMALL, generator=torch.Generator().manual_seed(0))
    pack = net.pcd_align.L1_dcnpack
    assert torch.count_nonzero(pack.conv_offset_mask.weight) == 0
    assert torch.count_nonzero(pack.conv_offset_mask.bias) == 0
    assert torch.count_nonzero(pack.bias) == 0
    assert pack.weight.abs().max() <= 1 / math.sqrt(16 * 9)
    rb = net.recon_trunk[0].conv1
    assert torch.count_nonzero(rb.bias) == 0
    assert 0.05 * math.sqrt(2 / (16 * 9)) < rb.weight.std() < 0.2 * math.sqrt(2 / (16 * 9))


# ---------------------------------------------------------------------- bf16
def test_bf16_forward_gap_to_fp32_matches_jax(exact_pair):
    lr, params = exact_pair["lr"], exact_pair["params"]
    net = jax_models.EDVRNet(**SMALL)
    jax32 = exact_pair["jax_out"]
    jax16 = net.apply({"params": jax_cast_floating(jax.tree.map(jnp.asarray, params),
                                                    jnp.bfloat16)},
                      jax_cast_floating(jnp.asarray(lr), jnp.bfloat16))
    port = exact_pair["port"]
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        port16 = forward_in(port, torch.bfloat16, torch.from_numpy(lr)).numpy()
        port32 = port(torch.from_numpy(lr)).numpy()
    jax_gap = np.linalg.norm(np.asarray(jax16, np.float64) - jax32)
    ratio = np.linalg.norm(port16.astype(np.float64) - port32) / jax_gap
    assert BF16_GAP_RATIO[0] <= ratio <= BF16_GAP_RATIO[1], ratio


# ----------------------------------------------------------------------- zoo
def test_the_edvr_yamls_are_all_here():
    assert len(EDVR_YAMLS) == 5


def _jax_param_count(kwargs: dict) -> int:
    """The JAX net's parameter count (the window adds none; tracing the
    windowed net's 4,500 shifted products would take a minute)."""
    kwargs = {k: v for k, v in kwargs.items() if k != "dcn_max_offset"}
    shapes = jax.eval_shape(jax_models.EDVRNet(**kwargs).init, jax.random.PRNGKey(0),
                            np.zeros((1, kwargs["nframes"], 8, 8, 1), np.float32))
    return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))


@pytest.mark.parametrize("path", EDVR_YAMLS,
                         ids=[str(p.relative_to(REPO / "configs")) for p in EDVR_YAMLS])
def test_edvr_yaml_resolves_and_constructs(path):
    _import_components()
    cfg = load_config(path)
    assert cfg.net.name == "EDVRNet"
    net = NETS.build(cfg.net, generator=torch.Generator().manual_seed(0))
    assert isinstance(net, models.EDVRNet)
    assert net.dcn_max_offset == cfg.net.kwargs.get("dcn_max_offset")
    kwargs = dict(cfg.net.kwargs)
    assert sum(p.numel() for p in net.parameters()) == _jax_param_count(kwargs)
