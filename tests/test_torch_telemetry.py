"""The PyTorch port's windowed-warp exceedance telemetry against the JAX package's.

* ``ops/telemetry.py``: the triple, its merges over sites and over time,
  ``summarize``, ``merge_summaries``, ``format_summary`` and ``check`` (its
  return and its warning text) equal the JAX package's.
* Through the nets: the port's summary of one forward inside
  ``telemetry.collect`` equals JAX's summary of the ``telemetry``
  collection for FRVSR (``max_flow`` 2) and for TOFlow (``max_flow`` 2, eval
  and train), at the JAX init and with the flows pushed out of the window
  (FNet's tail bias at 50: the tanh saturates; every SpyNet block's flow
  bias at 10): the same site names, identical counts, ``max_abs`` within
  1e-5, relative above 1 px (the saturated TOFlow flows reach 151 px, where
  one float32 ulp is 1.5e-5; measured one ulp).  Outside ``collect`` no
  triple is computed.
* Through the runners, as the JAX package's ``tests/test_telemetry.py``
  holds its own: out-of-window flows log the warning with its remedy (per
  item, naming the file, in the predictor; per valid epoch in the
  trainer) and in-window flows do not, for FRVSR and TOFlow; the summaries
  and the run's ``Windowed-op telemetry`` line are published; a tiled item
  merges its windows and drops its seam probes (the sample count is the
  same with and without probes); ``telemetry: false`` collects nothing and
  ``telemetry_warn_frac`` is accepted and raises the warning's threshold.
"""
import functools
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import models as jax_models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.ops import (
    telemetry as jax_tel,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import losses as PL
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import metrics as PM
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import (
    Dataloader,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
    telemetry as tel,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import (
    predictors,
    trainers,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.optim import (
    Optimizer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)

WARNING = "windowed-approximation exceedance"
FRVSR = dict(in_channels=1, out_channels=1, upscale_factor=4, num_resblocks=1, max_flow=2)
TOFLOW = dict(in_channels=1, out_channels=1, num_frames=3, upscale_factor=4, max_flow=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (test workers run side by
    side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ helpers
def _triple(seed, n=40, scale=4.0):
    rng = np.random.default_rng(seed)
    return [np.abs(rng.standard_normal(n) * scale).astype(np.float32) for _ in range(2)]


def test_triples_merges_and_summaries_match_jax(caplog):
    mags = [_triple(s) for s in range(3)]
    port = [tel.exceedance_triple(2.0, *(torch.from_numpy(m) for m in ms)) for ms in mags]
    ref = [jax_tel.exceedance_triple(2.0, *(jnp.asarray(m) for m in ms)) for ms in mags]
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    np.testing.assert_array_equal(tel.merge_triples(port[0], port[1]).numpy(),
                                  np.asarray(jax_tel.merge_triples(ref[0], ref[1])))
    np.testing.assert_array_equal(tel.merge_time_axis(torch.stack(port, dim=1)).numpy(),
                                  np.asarray(jax_tel.merge_time_axis(jnp.stack(ref, axis=1))))
    got = tel.summarize({"a": port[0], "b/c": tel.merge_triples(port[1], port[2])})
    want = jax_tel.summarize({"a": ref[0], "b": {"c": (ref[1], ref[2])}})
    assert got == want and got["b/c"]["n"] == 80.0
    assert tel.summarize({}) == jax_tel.summarize({}) == {}
    acc_p, acc_j = tel.merge_summaries({}, got), jax_tel.merge_summaries({}, want)
    assert tel.merge_summaries(acc_p, got) == jax_tel.merge_summaries(acc_j, want)
    assert tel.format_summary(got) == jax_tel.format_summary(want)
    with caplog.at_level(logging.WARNING):
        warned = tel.check(got, 0.1, context="patient001")
        n_port = len(caplog.records)
        assert warned == jax_tel.check(want, 0.1, context="patient001") == ["a", "b/c"]
    messages = [r.getMessage() for r in caplog.records]
    assert n_port == 2 and messages[:2] == messages[2:]
    assert "[patient001]" in messages[0] and "max_flow" in messages[0]
    assert tel.check(got, 1.0) == []


# ----------------------------------------------------------------- the nets
def _init(jax_net, x):
    """The JAX init without the telemetry collection ``init`` sows (the JAX
    package's ``strip``: fed back to ``apply``, it would be merged into)."""
    return jax.tree.map(np.asarray, jax_tel.strip(jax_net.init(jax.random.PRNGKey(0), x)))


def _frvsr_pair(saturate: bool, hw=(8, 11)):
    x = np.random.default_rng(1).uniform(-1, 1, (2, 3, *hw, 1)).astype(np.float32)
    jax_net = jax_models.FRVSRNet(**FRVSR)
    variables = _init(jax_net, x)
    if saturate:
        bias = variables["params"]["steps"]["fnet"]["tail_conv2"]["bias"]
        variables["params"]["steps"]["fnet"]["tail_conv2"]["bias"] = np.full_like(bias, 50.0)
    net = models.FRVSRNet(**FRVSR)
    net.load_state_dict(state_dict_from_jax_params(variables, "FRVSRNet"), strict=True)
    return jax_net, variables, net, x


def _toflow_pair(saturate: bool):
    x = np.random.default_rng(2).uniform(-1, 1, (2, 3, 6, 6, 1)).astype(np.float32)
    jax_net = jax_models.TOFlowNet(**TOFLOW)
    variables = _init(jax_net, x)
    if saturate:
        for block in variables["params"]["spy_net"].values():
            block["conv5"]["bias"] = np.full_like(block["conv5"]["bias"], 10.0)
    net = models.TOFlowNet(**TOFLOW)
    net.load_state_dict(state_dict_from_jax_params(variables, "TOFlowNet"), strict=True)
    return jax_net, variables, net, x


@functools.lru_cache(maxsize=None)
def _jax_apply(jax_net, train):
    """The jitted apply that collects the telemetry (one compile a net and
    mode: the cases differ in weights only)."""
    kwargs = {"train": train} if isinstance(jax_net, jax_models.TOFlowNet) else {}
    mutable = ["telemetry", "batch_stats"] if train else ["telemetry"]
    return jax.jit(lambda v, a: jax_net.apply(v, a, mutable=mutable, **kwargs))


NET_CASES = [("FRVSRNet", False, False), ("FRVSRNet", True, False), ("TOFlowNet", False, False),
             ("TOFlowNet", True, False), ("TOFlowNet", True, True)]


@pytest.mark.parametrize("name,saturate,train", NET_CASES,
                         ids=[f"{n}-{'out' if s else 'in'}{'-train' if t else ''}"
                              for n, s, t in NET_CASES])
def test_net_summaries_match_jax(name, saturate, train):
    jax_net, variables, net, x = (_frvsr_pair if name == "FRVSRNet" else _toflow_pair)(saturate)
    _, collections = _jax_apply(jax_net, train)(variables, x)
    want = jax_tel.summarize(collections["telemetry"])
    net.train(train)
    with torch.no_grad(), tel.collect(net) as collector:
        net(torch.from_numpy(x))
    got = collector.summary()
    sites = {"FRVSRNet": ["lr_flow_window", "sr_flow_window"],
             "TOFlowNet": ["flow_window", "spy_net/pyramid_flow_window"]}[name]
    assert sorted(got) == sorted(want) == sites
    for site in sites:
        g, w = got[site], want[site]
        assert g["n"] == w["n"] and round(g["frac_out"] * g["n"]) == round(w["frac_out"] * w["n"])
        assert abs(g["max_abs"] - w["max_abs"]) <= 1e-5 * max(1.0, w["max_abs"]), site
        assert (g["frac_out"] > 0.5) == saturate, site
    if name == "FRVSRNet" and saturate:  # tanh at 1: half the HR frame's width in pixels
        assert got["sr_flow_window"]["max_abs"] == pytest.approx(11 * 4 / 2, rel=1e-3)
    assert "_telemetry" not in net.__dict__  # collect leaves nothing behind


def test_no_triple_is_computed_outside_collect(monkeypatch):
    def refuse(*args):
        raise AssertionError("a triple was computed while not collecting")

    monkeypatch.setattr(tel, "exceedance_triple", refuse)
    for pair in (_frvsr_pair, _toflow_pair):
        _, _, net, x = pair(True)
        with torch.no_grad():
            net.eval()(torch.from_numpy(x))
        with torch.no_grad(), tel.collect(net) as collector, collector.pause():
            net(torch.from_numpy(x))
        assert collector.triples == {}


# -------------------------------------------------------------- the runners
class _Ds:
    """In-memory items with the file names the predictors parse."""

    def __init__(self, items, misr=False):
        self.items = items
        self.data = [(Path(f"patient{i:03d}_2d+1d_sequence01.nii.gz"), None, 0) if misr else
                     (Path(f"patient{i:03d}_2d_sequence01.nii.gz"), None)
                     for i in range(len(items))]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _vsr_items(n=2, t=3, hw=16, seed=0):
    rng = np.random.default_rng(seed)
    return [{"lr_imgs": rng.uniform(-1, 1, (t, hw, hw, 1)).astype(np.float32),
             "hr_imgs": rng.uniform(-1, 1, (t, 4 * hw, 4 * hw, 1)).astype(np.float32),
             "index": i} for i in range(n)]


def _misr_items(n=2, hw=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"lr_imgs": rng.uniform(-1, 1, (3, hw, hw, 1)).astype(np.float32),
             "hr_img": rng.uniform(-1, 1, (4 * hw, 4 * hw, 1)).astype(np.float32),
             "index": i} for i in range(n)]


def _flows(net, mode):
    """``mode`` "out": the flow convs' biases pushed out of the window (FNet's
    tanh saturates); "in": their weights scaled by 0.1 and biases zeroed,
    so the flows stay well inside it; "init": as constructed (seed 0)."""
    convs = ([net.fnet.tail["conv2"]] if isinstance(net, models.FRVSRNet)
             else [block.block[12] for block in net.spy_net.blocks])
    with torch.no_grad():
        for conv in convs:
            if mode == "out":
                conv.bias.fill_(50.0 if isinstance(net, models.FRVSRNet) else 10.0)
            elif mode == "in":
                conv.weight.mul_(0.1)
                conv.bias.zero_()
    return net


def _predictor(name, mode, items, **kw):
    if name == "FRVSRNet":
        cls, net, ds = predictors.FRVSRPredictor, models.FRVSRNet(**FRVSR), _Ds(items)
    else:
        cls, net, ds = predictors.MISRPredictor, models.TOFlowNet(**TOFLOW), _Ds(items, misr=True)
    return cls(device="cpu", test_dataloader=Dataloader(ds, batch_size=1, shuffle=False),
               net=_flows(net, mode), loss_fns=[PL.L1Loss()], metric_fns=[PM.PSNR()], **kw)


@pytest.mark.parametrize("name", ["FRVSRNet", "TOFlowNet"])
def test_predictor_warns_for_out_of_window_flows_only(name, caplog):
    items = _vsr_items() if name == "FRVSRNet" else _misr_items()
    site = "sr_flow_window" if name == "FRVSRNet" else "flow_window"
    pred = _predictor(name, "out", items)
    with caplog.at_level(logging.INFO):
        pred.predict()
    warnings = [r.getMessage() for r in caplog.records if WARNING in r.getMessage()]
    assert len(warnings) >= len(items) and "max_flow" in warnings[0]
    assert any("[patient000_2d" in w for w in warnings)  # per item, with its file
    assert pred.telemetry_summary[site]["frac_out"] > 0.9
    assert [r for r in caplog.records if r.getMessage().startswith("Windowed-op telemetry: ")]
    if name == "FRVSRNet":  # tanh at 1: half the HR frame's width
        assert pred.telemetry_summary[site]["max_abs"] == pytest.approx(32.0, rel=0.05)
        assert pred.telemetry_summary["lr_flow_window"]["frac_out"] > 0.9
    caplog.clear()
    pred = _predictor(name, "in", items)
    with caplog.at_level(logging.WARNING):
        pred.predict()
    assert not [r for r in caplog.records if "exceedance" in r.getMessage()]
    assert pred.telemetry_summary[site]["frac_out"] == 0.0 and pred.telemetry_summary[site]["n"] > 0


def test_predictor_telemetry_off_and_warn_frac(caplog):
    pred = _predictor("FRVSRNet", "out", _vsr_items(n=1), telemetry=False)
    pred.predict()
    assert pred.telemetry_summary == {}
    # at the seed-0 init some of the flows leave the window: above the
    # threshold the fraction is published and not warned about
    pred = _predictor("FRVSRNet", "init", _vsr_items(n=1), telemetry_warn_frac=0.95)
    assert pred.telemetry_warn_frac == 0.95
    with caplog.at_level(logging.WARNING):
        pred.predict()
    fracs = [s["frac_out"] for s in pred.telemetry_summary.values()]
    assert len(fracs) == 2 and 0.0 < max(fracs) < 0.95
    assert not [r for r in caplog.records if "exceedance" in r.getMessage()]


def test_tiled_predictor_merges_windows_and_drops_seam_probes(caplog):
    items = _vsr_items(n=1, hw=24)
    counts = {}
    for seam in (True, False):
        pred = _predictor("FRVSRNet", "out", items, tile=16, tile_overlap=4, seam_stats=seam)
        with caplog.at_level(logging.WARNING):
            pred.predict()
        counts[seam] = {site: s["n"] for site, s in pred.telemetry_summary.items()}
        assert pred.telemetry_summary["sr_flow_window"]["frac_out"] > 0.9
        assert bool(pred.seam_summary) == seam
    assert [r for r in caplog.records if WARNING in r.getMessage()]
    # 2×2 windows of 16×16 LR pixels, 3 frames: the probes add nothing
    assert counts[True] == counts[False] == {"lr_flow_window": 4 * 3 * 16 * 16,
                                              "sr_flow_window": 4 * 3 * 64 * 64}


def _trainer(name, mode, **kw):
    rng = np.random.default_rng(11)
    if name == "FRVSRNet":
        items = [{"lr_imgs": rng.standard_normal((3, 8, 8, 1)).astype(np.float32),
                  "hr_imgs": rng.standard_normal((3, 32, 32, 1)).astype(np.float32)}
                 for _ in range(2)]
        cls, net = trainers.FRVSRTrainer, models.FRVSRNet(**FRVSR)
        loss_fns = [PL.FlowLoss(), PL.MSELoss()]
    else:
        items = _misr_items(seed=11)
        cls, net = trainers.MISRTrainer, models.TOFlowNet(**TOFLOW)
        loss_fns = [PL.L1Loss()]
    loader = Dataloader(_Ds(items), batch_size=2, shuffle=False)
    return cls(device="cpu", train_dataloader=loader, valid_dataloader=loader,
               net=_flows(net, mode), loss_fns=loss_fns, metric_fns=[PM.PSNR()],
               optimizer=Optimizer("Adam", lr=1e-7), num_epochs=2, **kw)


@pytest.mark.parametrize("name", ["FRVSRNet", "TOFlowNet"])
def test_trainer_valid_epochs_warn_for_out_of_window_flows_only(name, caplog, monkeypatch):
    trainer = _trainer(name, "out")
    collects = []
    orig = tel.collect

    def spy(net, collector=None):
        collects.append(net.training)
        return orig(net, collector)

    monkeypatch.setattr(tel, "collect", spy)
    with caplog.at_level(logging.INFO):
        trainer.train()
    assert collects == [False, False]  # the valid epochs only, never a train step
    warnings = [r.getMessage() for r in caplog.records if WARNING in r.getMessage()]
    assert any("[valid epoch 1]" in w for w in warnings)
    assert any("[valid epoch 2]" in w for w in warnings)
    assert any(r.getMessage().startswith("Windowed-op telemetry (valid epoch 2): ")
               for r in caplog.records)
    site = "sr_flow_window" if name == "FRVSRNet" else "flow_window"
    assert len(trainer.telemetry_history) == 2
    assert trainer.telemetry_history[0][site]["frac_out"] > 0.9
    assert trainer.telemetry_summary[site]["n"] == 2 * trainer.telemetry_history[0][site]["n"]
    caplog.clear()
    trainer = _trainer(name, "in")
    with caplog.at_level(logging.WARNING):
        trainer.train()
    assert not [r for r in caplog.records if "exceedance" in r.getMessage()]
    assert trainer.telemetry_history[0][site]["frac_out"] == 0.0


def test_trainer_telemetry_off_and_warn_frac():
    trainer = _trainer("FRVSRNet", "out", telemetry=False)
    trainer.train()
    assert trainer.telemetry_summary == {} and trainer.telemetry_history == []
    trainer = _trainer("FRVSRNet", "out", telemetry_warn_frac=1.0)
    assert trainer.telemetry_warn_frac == 1.0
    trainer.train()
    assert len(trainer.telemetry_history) == 2
