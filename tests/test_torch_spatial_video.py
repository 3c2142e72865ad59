"""The port's spatial axis for TOFlowNet, FRVSRNet and EDVRNet against the JAX package.

Ranks are processes of a gloo group on the CPU, spawned twice for the
whole file (``parallel/distributed.spawn``; the bodies are in
``tests/torch_parallel_workers.py``): 2 ranks (spatial 2) and 4 ranks
(data 2 × spatial 2; spatial 4 for the units).  The weights are the port's
seeded init, carried into the JAX package by its
``variables_from_torch_state_dict``.

* the units (``video_units``), each on a band against the whole op on
  every rank (float64 operands): the warps at a band edge (windowed with a
  halo, windowed from the gathered frame, exact; ``zeros`` and ``border``;
  output and the gradients of the image and the flow, 1e-6), the 3×3/s2/p1
  conv and FRVSR's k 3, s 2, p 1, output-padding-1 transposed conv (output
  1e-6, gradients 1e-5, ``test_torch_spatial_zoo.py``'s bounds),
  ``pad_to_multiple`` at a height that needs a pad with the minimum on
  rank 1 (value 0, gradient 1e-6), TSA's pools (1e-6), and the DCN's plain
  twin with its row origin on a band and on the gathered frame (output
  1e-6; the gradients of x, offsets, mask 1e-6, of the weight 1e-5), each
  DCN call counted by the operand it took;
* each net's forward, with and without its window knob (``max_flow: 2``,
  ``dcn_max_offset: 2``), on spatial 2 and on data 2 × spatial 2 against
  the JAX package's meshless forward (atol 1e-5; EDVR's eagerly, its
  offset convs drawn so that every DCN samples off the grid and some taps
  fall past the window), with the exchanges and gathers
  ``chip_smoke.video_counts`` predicts;
* LR heights of the repo's data whose bands would not fit a net's pad and
  pyramid (36 and 54 rows on spatial 2): ``parallel.spatial_step``
  replicates the item with the one-time warning, or shards it where the
  bands fit, and the output is the meshless forward's;
* one SGD step of each net on data 2 × spatial 2 against the JAX
  trainer's step on one device (loss rel 1e-5, parameters and running
  statistics 1e-5; EDVR's step eager, under ``jax.disable_jit``: jitting
  its gradient alone takes ~50 s here), with their counts.  Windowed EDVR
  steps from the seeded init, where every offset conv is zero and the
  window is exact: its step is held to JAX's exact one (the JAX
  package's own check of its windowed net; ``tests/test_torch_edvr.py``
  holds the port's windowed gradients to the exact ones there);
* ``exp1_x4.yaml`` and ``exp1_x4_tpu.yaml`` of the three test families
  through ``main`` on spatial 2 against the port's meshless run (Test log
  rel 1e-5; the bf16 ``_tpu`` runs 1e-4 and their SSIMs 1e-4 absolute,
  ``_assert_log``) with the windowed runs' telemetry equal to the meshless
  one, and one step of each family's train YAML (EDVR's ``_tpu`` too)
  against the meshless one, its valid epoch included (the same bounds).
  The YAMLs are cut to 3-frame windows and 4-frame clips on a 4-frame
  tree.  The fp32 TOFlow, FRVSR and EDVR test YAMLs on spatial 2 are also held
  to the JAX package's ``main`` on the same config (rel 1e-5); the other
  meshless runs are held to it by ``tests/test_torch_misr_runner.py``,
  ``tests/test_torch_vsr_yamls.py`` and ``tests/test_torch_edvr_yamls.py``
  (JAX's ``main`` compiles EDVR's bf16 windowed net for ~150 s here).
"""
import functools
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import losses as JL
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import metrics as JM
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import models as jax_models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.config import Cfg as JaxCfg
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.data.loader import (
    Dataloader as JaxDataloader,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.main import (
    test_from_config as run_jax_test,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner import (
    trainers as jax_trainers,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.optim import (
    Optimizer as JaxOptimizer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.torch_import import (
    variables_from_torch_state_dict,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import (
    Cfg,
    load_config,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
    test_from_config as run_port_test,
    train_from_config as run_port_train,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import (
    distributed,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)

sys.path.insert(0, str(Path(__file__).parent))
import torch_parallel_workers as workers  # noqa: E402
from fixtures import make_acdc_tree  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

B, T, HW = 2, 3, 16  # items, frames, LR side (HR 64: no pad for any of the three)
SGD = ("SGD", {"lr": 1e-2})
NETS = {
    "TOFlowNet": dict(in_channels=1, out_channels=1, num_frames=T, upscale_factor=4),
    "FRVSRNet": dict(in_channels=1, out_channels=1, upscale_factor=4, num_resblocks=2),
    "EDVRNet": dict(in_channels=1, out_channels=1, nf=8, nframes=T, groups=2, front_RBs=1,
                    back_RBs=1),
}
KNOB = {"TOFlowNet": "max_flow", "FRVSRNet": "max_flow", "EDVRNet": "dcn_max_offset"}
R = 2
CASES = [(name, windowed) for name in NETS for windowed in (False, True)]
IDS = [f"{n}-{'windowed' if w else 'exact'}" for n, w in CASES]
KIND = {"TOFlowNet": "toflow", "FRVSRNet": "frvsr", "EDVRNet": "edvr"}


def _kwargs(name: str, windowed: bool, prediction: bool = True) -> dict:
    kw = dict(NETS[name])
    if windowed:
        kw[KNOB[name]] = R
    if name == "FRVSRNet" and prediction:
        kw["is_prediction"] = True
    return kw


@functools.lru_cache(maxsize=None)
def _state(name: str, offsets: bool = False) -> dict:
    """The port's seeded init (the knobs add no parameter); with
    ``offsets``, EDVR's zero-initialised offset convs drawn (weights
    N(0, 0.1), biases N(0, 1.5)): offsets of a few pixels, fractional, some
    past the window R."""
    net = getattr(models, name)(**NETS[name], generator=torch.Generator().manual_seed(0))
    state = net.state_dict()
    if offsets:
        rng = np.random.default_rng(4)
        for key, value in state.items():
            if "conv_offset_mask" in key:
                sd = 1.5 if key.endswith("bias") else 0.1
                state[key] = torch.from_numpy(rng.normal(0, sd, tuple(value.shape)).astype(
                    np.float32))
    return state


def _variables(name: str, offsets: bool = False) -> dict:
    return variables_from_torch_state_dict(name, _state(name, offsets))


@pytest.fixture(autouse=True, scope="module")
def _one_thread_a_rank():
    """One intra-op thread here and in every rank spawned (they inherit
    ``OMP_NUM_THREADS``): test workers and ranks share the cores."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


# ------------------------------------------------------------- the nets
def _input() -> np.ndarray:
    return np.random.default_rng(1).standard_normal((B, T, HW, HW, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def oracle():
    """Each case's meshless forward: the JAX package's (jitted for TOFlow
    and FRVSR, eager for EDVR)."""
    out = {}
    x = _input()
    for name, windowed in CASES:
        kw = _kwargs(name, windowed)
        net, variables = getattr(jax_models, name)(**kw), _variables(name, offsets=True)
        apply = functools.partial(net.apply, **({"train": False} if "batch_stats" in variables
                                                else {}))
        if name != "EDVRNet":
            apply = jax.jit(apply)
        out[name, windowed] = np.asarray(apply(variables, x))
    return out


def _forward_tasks() -> list:
    return [("zoo_forward", dict(name=name, net_kwargs=_kwargs(name, windowed),
                                 net_state=_state(name, offsets=True), lr=_input(), spatial=2))
            for name, windowed in CASES]


#: LR heights of the repo's data (HR 144 and 216 at ×4) on spatial 2, and
#: whether each net's bands fit them after its centred pad: TOFlow's
#: upsampled 144 rows give bands of 72 (not a multiple of 16) and its 216
#: padded to 224 bands of 112; FRVSR's 36 padded to 40 give 20 and its 54
#: padded to 56 give 28 (not multiples of 8); EDVR's 36 give 18 (not a
#: multiple of 4) and its 54 padded to 56 give 28
BAND_FIT = {("TOFlowNet", 36): False, ("TOFlowNet", 54): True, ("FRVSRNet", 36): False,
            ("FRVSRNet", 54): False, ("EDVRNet", 36): False, ("EDVRNet", 54): True}


def _band_input(height: int) -> np.ndarray:
    return np.random.default_rng(5).standard_normal((1, T, height, 8, 1)).astype(np.float32)


def _band_fit_tasks() -> list:
    return [("band_fit", dict(name=name, net_kwargs=_kwargs(name, False), net_state=_state(name),
                              lr=_band_input(height), spatial=2)) for name, height in BAND_FIT]


# ------------------------------------------------------------ the steps
def _items(name: str, seed: int = 3) -> list:
    rng = np.random.default_rng(seed)
    hr = (T, 4 * HW, 4 * HW, 1) if name == "FRVSRNet" else (4 * HW, 4 * HW, 1)
    key = "hr_imgs" if name == "FRVSRNet" else "hr_img"
    return [{"lr_imgs": rng.standard_normal((T, HW, HW, 1)).astype(np.float32),
             key: rng.standard_normal(hr).astype(np.float32)} for _ in range(B)]


STEPS = [("TOFlowNet", False), ("FRVSRNet", False), ("EDVRNet", False), ("EDVRNet", True)]


def _step_task(name: str, windowed: bool):
    return ("zoo_steps", dict(kind=KIND[name], net_state=_state(name),
                              net_kwargs=_kwargs(name, windowed, prediction=False),
                              items=_items(name), batch=B, spatial=2, optimizer=SGD))


def _jax_step(name: str) -> tuple:
    """One SGD step of the JAX trainer on one device (EDVR's eager) →
    (train log, the port's state_dict of the stepped weights and
    statistics)."""
    cls, loss = {"TOFlowNet": (jax_trainers.MISRTrainer, [JL.L1Loss()]),
                 "FRVSRNet": (jax_trainers.FRVSRTrainer, [JL.FlowLoss(), JL.MSELoss()]),
                 "EDVRNet": (jax_trainers.MISRTrainer, [JL.CharbonnierLoss(epsilon=1e-6)])}[name]
    net = getattr(jax_models, name)(**_kwargs(name, False, prediction=False))
    variables = _variables(name)
    loader = JaxDataloader(workers.ListDataset(_items(name)), batch_size=B, shuffle=False)
    optimizer = JaxOptimizer(SGD[0], **SGD[1])
    trainer = cls(device="cpu", train_dataloader=loader, valid_dataloader=loader, net=net,
                  loss_fns=loss, loss_weights=[1.0] * len(loss), metric_fns=[JM.PSNR()],
                  optimizer=optimizer, num_epochs=1, telemetry=False)
    trainer.params = jax.tree.map(jnp.asarray, variables["params"])
    trainer.model_state = {k: jax.tree.map(jnp.asarray, v) for k, v in variables.items()
                           if k != "params"}
    trainer.opt_state = optimizer.init(trainer.params)
    with jax.disable_jit(name == "EDVRNet"):
        log, _, _ = trainer._run_epoch("training")
    state = state_dict_from_jax_params(
        {"params": jax.tree.map(np.asarray, trainer.params),
         **jax.tree.map(np.asarray, trainer.model_state)}, name)
    return log, state


@pytest.fixture(scope="module")
def reference_steps():
    """The JAX single-device step of each net; windowed EDVR's is the exact
    one (its offsets are zero at the seeded init)."""
    out = {(name, False): _jax_step(name) for name in NETS}
    out["EDVRNet", True] = out["EDVRNet", False]
    return out


# ------------------------------------------------------------ the YAMLs
#: the nets shrunk, and their windows or clips (``num_frames``) cut to
#: the tree's frames
SHRINK = {"TOFlowNet": ({}, 3), "FRVSRNet": ({"num_resblocks": 2}, 4),
          "EDVRNet": ({"nf": 8, "groups": 2, "front_RBs": 1, "back_RBs": 1}, 3)}
FRAMES = 4  # a train split of 4 windows or clips: one step of batch 4
FAMILIES = ["toflow_net", "frvsr_net", "edvr_net"]
TEST_YAMLS = [(f, v) for f in FAMILIES for v in ("exp1_x4", "exp1_x4_tpu")]
TRAIN_YAMLS = [(f, "exp1_x4") for f in FAMILIES] + [("edvr_net", "exp1_x4_tpu")]


def _yaml(kind: str, family: str, variant: str, tmp: Path, tree: dict, parallel=None) -> dict:
    """``configs/{kind}/{family}/{variant}.yaml`` as shipped, patched for a
    small CPU run: the net shrunk, its frames cut, the data paths into
    ``tree``, seeded weights, no export; a train YAML one epoch of one
    step (batch 4, which EDVR's ``grad_accum_steps: 2`` divides)."""
    cfg = load_config(REPO / "configs" / kind / family / f"{variant}.yaml")
    name = cfg["net"]["name"]
    widths, frames = SHRINK[name]
    net_kw = cfg["net"]["kwargs"]
    net_kw.update(widths)
    for key in ("num_frames", "nframes"):
        if key in net_kw:
            net_kw[key] = frames
    cfg["main"]["saved_dir"] = str(tmp)
    kw = cfg["dataset"]["kwargs"]
    kw["num_frames"] = frames
    kw["data_dir"] = str(tree["videos_dir"])
    cfg["dataloader"]["kwargs"]["num_workers"] = 0
    for metric in cfg["metrics"]:
        if "coordinates_path" in (metric.get("kwargs") or {}):
            metric["kwargs"]["coordinates_path"] = str(tree["coordinates_path"])
    if kind == "test":
        ckpt = tmp.parent / f"{family}.pth"
        if not ckpt.exists():
            net = getattr(models, name)(**cfg["net"]["kwargs"],
                                        generator=torch.Generator().manual_seed(0))
            torch.save({"net": net.state_dict()}, ckpt)
        cfg["main"]["loaded_path"] = str(ckpt)
        cfg["predictor"]["kwargs"].update(device="cpu", exported=False, saved_dir=str(tmp))
    else:
        cfg["trainer"]["kwargs"].update(device="cpu", num_epochs=1)
        cfg["dataloader"]["kwargs"]["train_batch_size"] = FRAMES
        for aug in kw["augments"]:
            if aug["name"] == "RandomCropPatch":
                aug["kwargs"]["size"] = [HW, HW]  # LR pixels: the tree's whole frame
        cfg.pop("logger", None)
    if parallel:
        cfg["parallel"] = parallel
    return cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_video")
    # LR 16×16, FRVSR's clips and TOFlow's and EDVR's windows of the cut YAMLs
    return {"root": root, **make_acdc_tree(root / "tree", patients_per_split=1, slices=1,
                                           frames=FRAMES, hr_size=(4 * HW, 4 * HW))}


def _yaml_tasks(tree: dict) -> list:
    root, parallel = tree["root"], {"num_devices": 2, "spatial_parallel": 2}
    return ([("predict_from_config", dict(cfg=_yaml("test", f, v, root / f"sp_{f}_{v}", tree,
                                                    parallel))) for f, v in TEST_YAMLS]
            + [("train_from_config", dict(cfg=_yaml("train", f, v, root / f"sp_train_{f}_{v}",
                                                    tree, parallel))) for f, v in TRAIN_YAMLS])


@pytest.fixture(scope="module")
def world2(tree):
    """Spatial 2: the units, the forwards, the YAMLs through ``main``."""
    stream = ("frvsr_stream", dict(net_kwargs=_kwargs("FRVSRNet", True, prediction=True),
                                   net_state=_state("FRVSRNet"), lr=_input()))
    tasks = [("video_units", {}), stream, *_forward_tasks(), *_band_fit_tasks(),
             *_yaml_tasks(tree)]
    out = distributed.spawn(workers.run_tasks, (tasks,), world=2)
    n, f, m = len(CASES), len(BAND_FIT), len(TEST_YAMLS)
    return {"units": out[0], "stream": out[1], "forward": dict(zip(CASES, out[2:2 + n])),
            "band_fit": dict(zip(BAND_FIT, out[2 + n:2 + n + f])),
            "test": dict(zip(TEST_YAMLS, out[2 + n + f:2 + n + f + m])),
            "train": dict(zip(TRAIN_YAMLS, out[2 + n + f + m:]))}


@pytest.fixture(scope="module")
def world4():
    """Data 2 × spatial 2 (the units at spatial 4 first): the forwards and
    the steps."""
    tasks = [("video_units", {}), *_forward_tasks(), *(_step_task(*s) for s in STEPS)]
    out = distributed.spawn(workers.run_tasks, (tasks,), world=4)
    n = len(CASES)
    return {"units": out[0], "forward": dict(zip(CASES, out[1:1 + n])),
            "steps": {s: got[False] for s, got in zip(STEPS, out[1 + n:])}}


# ------------------------------------------------------------------ units
WARPS = [f"{fn} {mode} {path} {rows} rows" for rows, label in ((4, "halo"), (2, "gathered"))
         for mode in ("zeros", "border") for path in (label, "exact")
         for fn in ("flow_warp", "stn_warp")]


@pytest.mark.parametrize("op", WARPS)
@pytest.mark.parametrize("world", ["world2", "world4"])
def test_warp_at_a_band_edge_equals_the_whole_frame(world, op, request):
    e = request.getfixturevalue(world)["units"]["errors"][op]
    assert max(e.values()) <= 1e-6, e


@pytest.mark.parametrize("op", ["conv k3 s2 p1", "deconv k3 s2 p1 op1"])
@pytest.mark.parametrize("world", ["world2", "world4"])
def test_strided_and_output_padded_halos_equal_the_whole_conv(world, op, request):
    e = request.getfixturevalue(world)["units"]["errors"][op]
    assert e["out"] <= 1e-6 and e["d0"] <= 1e-5 and e["d1"] <= 1e-5, e


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_pad_to_multiple_takes_the_frames_minimum(world, request):
    e = request.getfixturevalue(world)["units"]["errors"]["pad_to_multiple"]
    assert e["out"] == 0.0 and e["d0"] <= 1e-6, e
    if world == "world2":  # 10 rows padded to 12: one row on each rank
        assert e["rows"] == 6 and e["crop"] in ([1, 6], [0, 5])
    else:  # 8 rows need no pad
        assert e["rows"] == 2 and e["crop"] == [0, 2]


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_tsa_pools_at_a_band_edge(world, request):
    e = request.getfixturevalue(world)["units"]["errors"]["tsa pools"]
    assert e["out"] <= 1e-6 and e["d0"] <= 1e-6, e


DCN_UNITS = ["dcn R=1 4 rows", "dcn R=2 2 rows", "dcn R=None 4 rows"]


@pytest.mark.parametrize("op", DCN_UNITS)
@pytest.mark.parametrize("world", ["world2", "world4"])
def test_dcn_row_origin_on_a_band_and_on_the_gathered_frame(world, op, request):
    got = request.getfixturevalue(world)["units"]
    e = got["errors"][op]
    assert e["out"] <= 1e-6 and max(e["d0"], e["d1"], e["d2"]) <= 1e-6 and e["d3"] <= 1e-5, e
    # R = 1 reaches 3 rows past a band of 4: a halo; R = 2 reaches 4 past a
    # band of 2, and no window at all: the frame gathered, with its backward
    band = op == "dcn R=1 4 rows"
    assert got["dcn_calls"][op] == {"band": int(band), "frame": int(not band),
                                    "gathers": {"forward": int(not band),
                                                "backward": int(not band)}}


# ---------------------------------------------------------------- forward
def _counts(name: str, windowed: bool) -> dict:
    kw = _kwargs(name, windowed)
    c = chip_smoke.video_counts(name, kw, (HW, HW), T, 2)["forward"]
    return {"exchanges": {"forward": c[0], "backward": 0},
            "gathers": {"forward": c[1], "backward": 0}}


@pytest.mark.parametrize("name,windowed", CASES, ids=IDS)
@pytest.mark.parametrize("world,items", [("world2", B), ("world4", B // 2)])
def test_spatial_forward_matches_the_meshless_forward(world, items, name, windowed, oracle,
                                                      request):
    got = request.getfixturevalue(world)["forward"][name, windowed]
    want = oracle[name, windowed]
    assert got["out"].shape == (1, items, *want.shape[1:])
    np.testing.assert_allclose(got["out"][0], want[:items], atol=1e-5)
    want_counts = _counts(name, windowed)
    assert {k: got[k] for k in ("exchanges", "gathers")} == want_counts
    if name == "EDVRNet":  # 4 DCN packs a frame; windowed L3 (2 rows a band) gathers
        n = 4 * T
        assert got["dcn"] == ({"band": 3 * T, "frame": T} if windowed else
                              {"band": 0, "frame": n})


@pytest.mark.parametrize("name,height", list(BAND_FIT),
                         ids=[f"{n}-LR{h}" for n, h in BAND_FIT])
def test_an_item_whose_bands_do_not_fit_is_replicated(world2, name, height):
    """No item raises mid-run: one whose bands would not fit the net's pad
    and pyramid is computed whole on each rank, warned once, as the JAX
    package's GSPMD runs any height; the others shard."""
    got, sharded = world2["band_fit"][name, height], BAND_FIT[name, height]
    net = getattr(models, name)(**_kwargs(name, False))
    net.load_state_dict(_state(name))
    assert (net.band_misfit(height, 2) is None) == sharded
    with torch.no_grad():
        want = net.eval()(torch.from_numpy(_band_input(height))).numpy()
    assert got["sharded"] == sharded
    assert got["warned"] == ([] if sharded else ["spatial"])
    assert got["out"].shape == want.shape
    np.testing.assert_allclose(got["out"], want, atol=1e-5)


def test_frvsr_stream_keeps_each_ranks_band(world2):
    """``FRVSRStream`` of a sharded FRVSR, fed a rank's band frame by frame,
    equals the clip forward on that band (the CPU: bit for bit), and its
    bf16 cast copy keeps the axis."""
    got = world2["stream"]
    assert got["band_shape"] == (B, T, HW // 2, HW, 1)
    assert got["diff"] == 0.0
    assert got["bf16_shape"] == (B, 4 * HW // 2, 4 * HW, 1)


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("name,windowed", STEPS, ids=[f"{n}-{w}" for n, w in STEPS])
def test_dp_sp_step_matches_the_single_device_step(world4, reference_steps, name, windowed):
    got = world4["steps"][name, windowed]
    want_log, want_state = reference_steps[name, windowed]
    assert got["mesh"] == {"data": 2, "spatial": 2} and got["warned"] == []
    assert got["log"]["Loss"] == pytest.approx(want_log["Loss"], rel=1e-5)
    assert got["log"]["PSNR"] == pytest.approx(want_log["PSNR"], rel=1e-5)
    for key, value in want_state.items():
        if value.is_floating_point():  # the running statistics too
            np.testing.assert_allclose(got["state"][key].numpy(), np.asarray(value), atol=1e-5,
                                       rtol=1e-5, err_msg=key)
    # the step's forward and backward over this rank's item, then the
    # trainer's no further forward (train_steps runs the training epoch only)
    c = chip_smoke.video_counts(name, _kwargs(name, windowed, prediction=False), (HW, HW), T,
                                2, train=True)
    assert got["exchanges"] == {"forward": c["forward"][0], "backward": c["backward"][0]}
    assert got["gathers"] == {"forward": c["forward"][1], "backward": c["backward"][1]}


# ----------------------------------------------------------- the YAMLs
@pytest.fixture(scope="module")
def meshless(tree):
    root = tree["root"]
    test = {}
    for f, v in TEST_YAMLS:
        pred = run_port_test(Cfg(_yaml("test", f, v, root / f"one_{f}_{v}", tree)))
        test[f, v] = {"log": pred.log, "telemetry": pred.telemetry_summary}
    train = {(f, v): run_port_train(Cfg(_yaml("train", f, v, root / f"one_train_{f}_{v}",
                                              tree))).history for f, v in TRAIN_YAMLS}
    return {"test": test, "train": train}


def _assert_log(got: dict, want: dict, variant: str, where=()):
    """fp32 runs rel 1e-5; the bf16 ``_tpu`` runs rel 1e-4, and their SSIMs
    1e-4 absolute: a band's conv sums in another order than the whole
    frame's, bf16 rounds the difference to a last bit now and then (oneDNN's
    bf16 conv keeps no fp32 sum between calls), and FRVSR's recurrence
    carries it over the clip (5.3e-5 measured here on a CardiacSSIM of
    0.0176; the fp32 runs were bit-equal)."""
    assert list(got) == list(want)
    bf16 = variant.endswith("_tpu")
    for key, value in want.items():
        floor = 1e-4 if bf16 and "SSIM" in key else 0.0
        assert got[key] == pytest.approx(value, rel=1e-4 if bf16 else 1e-5, abs=floor), (
            *where, key)


@pytest.mark.parametrize("family,variant", TEST_YAMLS, ids=[f"{f}-{v}" for f, v in TEST_YAMLS])
def test_test_yaml_on_spatial_2_matches_the_meshless_run(world2, meshless, family, variant):
    got, want = world2["test"][family, variant], meshless["test"][family, variant]
    assert got["mesh"] == {"data": 1, "spatial": 2} and got["warned"] == []
    _assert_log(got["log"], want["log"], variant)
    # the windowed runs' telemetry: every site's counts and largest
    # displacement over the frame's bands, the meshless run's
    assert bool(want["telemetry"]) == variant.endswith("_tpu")
    assert got["telemetry"] == want["telemetry"]


@pytest.mark.parametrize("family", ["toflow_net", "frvsr_net", "edvr_net"])
def test_fp32_test_yaml_on_spatial_2_matches_the_jax_main(world2, tree, family):
    """The spatial run's Test log against the JAX package's ``main`` on the
    same config without the ``parallel:`` section (its weights read from
    the same ``.pth``)."""
    cfg = _yaml("test", family, "exp1_x4", tree["root"] / f"jax_{family}", tree)
    want = run_jax_test(JaxCfg(cfg)).log
    got = world2["test"][family, "exp1_x4"]["log"]
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(float(value), rel=1e-5), key


@pytest.mark.parametrize("family,variant", TRAIN_YAMLS,
                         ids=[f"{f}-{v}" for f, v in TRAIN_YAMLS])
def test_train_yaml_on_spatial_2_matches_the_meshless_epoch(world2, meshless, family, variant):
    got, want = world2["train"][family, variant], meshless["train"][family, variant]
    assert got["mesh"] == {"data": 1, "spatial": 2} and got["warned"] == []
    for split in ("train", "valid"):
        _assert_log(got["history"][split][0], want[split][0], variant, (split,))
