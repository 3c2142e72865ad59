"""The port's spatial axis (height sharded over ranks, halo exchange) and
``pad_h`` against the JAX package.

Ranks are processes of a gloo group on the CPU, spawned twice for the
whole file (``parallel/distributed.spawn``; the bodies are in
``tests/torch_parallel_workers.py``): 2 ranks (spatial 2) and 4 ranks
(data 2 × spatial 2, then spatial 4).  The JAX package is the oracle, as
its ``tests/test_parallel.py`` holds its own spatial mesh to one device:

* ``halo_conv2d`` / ``halo_conv3d`` (float64, so that only the exchange is
  measured) against the whole conv on every rank: output 1e-6, input and
  weight gradients 1e-5;
* RefineNet's fused output at spatial 2 and at data 2 × spatial 2 against
  the JAX package's meshless forward (atol 1e-5, JAX
  ``test_spatial_sharded_forward_matches_replicated``);
* one SGD step on data 2 × spatial 2 against the JAX trainer's step on one
  device (loss rel 1e-5, parameters 1e-5, JAX
  ``test_multi_axis_train_step_matches_single_device[dp_sp]``), and
  ``remat`` against the plain step on that mesh (1e-6);
* ``grad_accum_steps: 2``, ``compute_dtype: bfloat16`` (1e-4: bf16
  rounds each conv's output, measured 2e-5 apart) and ``skip_nonfinite``
  on spatial 2 against the same epoch on one device, and the ``.pth`` and
  directory checkpoints written there; the bf16 forward's gap to fp32
  against the JAX package's (``tests/test_torch_tpu_knobs.py``'s (0.6,
  1.5));
* the flagship's test YAML (shrunk) through ``main`` on spatial 2 and on
  data 2 × spatial 2 against the port's meshless run (rel 1e-5) and the
  JAX package's (the port's 2e-3 log bound); its train YAML for one epoch
  on both meshes against the port's meshless epoch (rel 1e-5);
* ``pad_h`` with LR height 11 over spatial 4, ``t_bucket: 4``, 10 frames
  and CardiacPSNR against the JAX package's own ``pad_h`` run on its 8
  virtual devices (rel 1e-5), with no spatial warning;
* ``batch_infer --spatial-parallel 2 --pad-h`` rows against the JAX
  tool's (PSNR 1e-4 dB, SSIM 1e-5, ``tests/test_torch_batch_infer.py``'s
  bounds).
"""
import csv
import functools
import json
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
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.config import (
    Cfg as JaxCfg,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.data.loader import (
    Dataloader as JaxDataloader,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.main import (
    test_from_config as run_jax_test,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.models import (
    RefineNet as JaxRefineNet,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.parallel import (
    mesh as jax_mesh_mod,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner import (
    checkpoint as jax_ckpt,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.optim import (
    Optimizer as JaxOptimizer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.trainers import (
    VSRRefineNetTrainer as JaxTrainer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.tools import (
    batch_infer as jax_tool,
)
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
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.checkpoint import (
    load_checkpoint,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)

sys.path.insert(0, str(Path(__file__).parent))
import torch_parallel_workers as workers  # noqa: E402
from fixtures import make_acdc_tree  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# the JAX package's tests/test_parallel.py CFG and batch
NET = dict(in_channels=1, out_channels=1, num_features=[4, 4], num_stages=1, upscale_factor=4,
           update_memory=True, num_updated_frames=2, refine_window_size=5,
           positional_encoding=True)
B, T, H, W = 8, 7, 8, 8
SGD = ("SGD", {"lr": 1e-2})
SHRINK = {"num_features": [4, 4]}  # the flagship YAMLs' 3 stages, 6 warm-up frames kept


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


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"lr_imgs": rng.standard_normal((B, T, H, W, 1)).astype(np.float32),
            "pos_code": rng.uniform(-1, 1, (B, T, 1)).astype(np.float32),
            "hr_imgs": rng.standard_normal((B, 3, H * 4, W * 4, 1)).astype(np.float32)}


def _items(batch):
    return [{k: v[i] for k, v in batch.items()} for i in range(B)]


def _poisoned():
    """Two batches of 4, the first with a NaN in the LR rows of spatial rank 1."""
    items = _items(_batch(4))
    items[0]["lr_imgs"] = items[0]["lr_imgs"].copy()
    items[0]["lr_imgs"][0, H - 1, 0, 0] = np.nan
    return items


@pytest.fixture(scope="module")
def params():
    batch = _batch(0)
    out = jax.jit(JaxRefineNet(**NET).init)(jax.random.PRNGKey(0), batch["lr_imgs"][:1],
                                            batch["pos_code"][:1])["params"]
    return jax.tree.map(np.asarray, out)


def _flagship(kind: str, tmp: Path, tree: dict, ckpt: Path | None, parallel=None) -> dict:
    """``configs/{kind}/refine_net/exp1_x4.yaml`` as shipped, patched for a
    small CPU run: the net shrunk, the data paths into ``tree``, one epoch
    of batch 4 on 8×8 LR crops, no export."""
    cfg = load_config(REPO / "configs" / kind / "refine_net" / "exp1_x4.yaml")
    cfg["net"]["kwargs"].update(SHRINK)
    cfg["main"]["saved_dir"] = str(tmp)
    kw = cfg["dataset"]["kwargs"]
    kw.update(data_dir=str(tree["videos_dir"]), pos_code_path=str(tree["pos_code_path"]))
    cfg["dataloader"]["kwargs"]["num_workers"] = 0
    for metric in cfg["metrics"]:
        if "coordinates_path" in (metric.get("kwargs") or {}):
            metric["kwargs"]["coordinates_path"] = str(tree["coordinates_path"])
    if kind == "test":
        cfg["main"]["loaded_path"] = str(ckpt)
        cfg["predictor"]["kwargs"].update(device="cpu", exported=False, saved_dir=str(tmp))
    else:
        cfg["trainer"]["kwargs"].update(device="cpu", num_epochs=1)
        cfg["dataloader"]["kwargs"]["train_batch_size"] = 4
        for aug in kw["augments"]:
            if aug["name"] == "RandomCropPatch":
                aug["kwargs"]["size"] = [8, 8]
        cfg["logger"]["kwargs"]["dummy_input"] = [4, 1, 8, 8]
    if parallel:
        cfg["parallel"] = parallel
    return cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)


def _pad_h_cfg(tree: dict, ckpt: Path, saved: Path, parallel=None) -> dict:
    """The JAX package's ``test_predictor_pad_h_shards_indivisible_heights``
    config (its ``tests/test_parallel.py:609-650``)."""
    out = {
        "main": {"saved_dir": str(saved), "loaded_path": str(ckpt)},
        "dataset": {"name": "AcdcVSRRefineNetDataset", "kwargs": {
            "data_dir": str(tree["videos_dir"]), "downscale_factor": 4,
            "pos_code_path": str(tree["pos_code_path"]),
            "transforms": [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                           {"name": "ToTensor"}],
            "num_frames": 5, "num_updated_frames": 2}},
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"batch_size": 1, "shuffle": False, "num_workers": 0}},
        "net": {"name": "RefineNet", "kwargs": NET},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [{"name": "PSNR"}, {"name": "SSIM"},
                    {"name": "CardiacPSNR",
                     "kwargs": {"coordinates_path": str(tree["coordinates_path"])}}],
        "predictor": {"name": "AcdcVSRRefineNetPredictor",
                      "kwargs": {"device": "cpu", "saved_dir": str(saved), "exported": False,
                                 "t_bucket": 4}},
    }
    if parallel:
        out["parallel"] = parallel
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory, params):
    root = tmp_path_factory.mktemp("spatial")
    # the flagship YAMLs: LR 12×12, which spatial 2 divides
    flagship = make_acdc_tree(root / "flagship", patients_per_split=1, slices=1, frames=12,
                              hr_size=(48, 48))
    flagship_params = jax.jit(JaxRefineNet(**{**NET, **SHRINK, "num_stages": 3,
                                                "num_updated_frames": 6}).init)(
        jax.random.PRNGKey(0), np.zeros((1, 19, 8, 8, 1), np.float32),
        np.zeros((1, 19, 1), np.float32))["params"]
    flagship_ckpt = root / "flagship.pth"
    torch.save({"net": state_dict_from_jax_params(jax.tree.map(np.asarray, flagship_params))},
               flagship_ckpt)
    # pad_h: LR height 44 / 4 = 11, which spatial 4 (and 2) does not divide;
    # 10 frames, so that t_bucket 4 pads the cycle to 12
    padded = make_acdc_tree(root / "pad_h", frames=10, hr_size=(44, 44))
    ckpt = root / "model.pth"
    jax_ckpt.save_checkpoint(ckpt, params=params)
    return {"root": root, "flagship": flagship, "flagship_ckpt": flagship_ckpt,
            "pad_h": padded, "ckpt": ckpt}


def _flagship_tasks(trees: dict, parallel: dict) -> list:
    """The flagship's test YAML and its train YAML (one epoch) under
    ``parallel`` through ``main``."""
    tag = f"{parallel['num_devices']}_{parallel['spatial_parallel']}"
    return [("predict_from_config",
             dict(cfg=_flagship("test", trees["root"] / f"test_{tag}", trees["flagship"],
                                trees["flagship_ckpt"], parallel))),
            ("train_from_config",
             dict(cfg=_flagship("train", trees["root"] / f"train_{tag}", trees["flagship"], None,
                                parallel)))]


@pytest.fixture(scope="module")
def world2(trees, params):
    """Spatial 2: the halos, the forward (fp32 and bf16), the trainer's
    knobs, the flagship YAMLs, and ``batch_infer --spatial-parallel 2
    --pad-h``."""
    root = trees["root"]
    batch = _batch(1)
    tasks = [
        ("halo_errors", {}),
        ("spatial_forward", dict(net_state=state_dict_from_jax_params(params), net_kwargs=NET,
                                 lr=batch["lr_imgs"], pos=batch["pos_code"], spatial=2)),
        ("spatial_forward", dict(net_state=state_dict_from_jax_params(params), net_kwargs=NET,
                                 lr=batch["lr_imgs"], pos=batch["pos_code"], spatial=2,
                                 compute_dtype="bfloat16")),
        ("spatial_knobs", dict(net_state=state_dict_from_jax_params(params), net_kwargs=NET,
                               items=_items(_batch(3)), poisoned=_poisoned(), batch=B // 2,
                               spatial=2, saved_dir=str(root))),
        *_flagship_tasks(trees, {"num_devices": 2, "spatial_parallel": 2}),
        ("batch_infer", dict(argv=_infer_args(trees, root / "sp.csv", "--device", "cpu",
                                              "--num-devices", "2", "--spatial-parallel", "2",
                                              "--pad-h"))),
    ]
    return dict(zip(("halo", "forward", "forward_bf16", "knobs", "test", "train", "batch_infer"),
                    distributed.spawn(workers.run_tasks, (tasks,), world=2)))


@pytest.fixture(scope="module")
def world4(trees, params):
    """Data 2 × spatial 2 (the halos at spatial 4 first): the forward, an
    SGD step plain and with ``remat``, the flagship YAMLs; then ``pad_h``
    over spatial 4."""
    root = trees["root"]
    batch = _batch(1)
    state = state_dict_from_jax_params(params)
    tasks = [
        ("halo_errors", {}),
        ("spatial_forward", dict(net_state=state, net_kwargs=NET, lr=batch["lr_imgs"],
                                 pos=batch["pos_code"], spatial=2)),
        ("spatial_steps", dict(net_state=state, net_kwargs=NET, items=_items(_batch(3)), batch=B,
                               spatial=2, optimizer=SGD)),
        *_flagship_tasks(trees, {"num_devices": 4, "spatial_parallel": 2}),
        ("predict_from_config", dict(cfg=_pad_h_cfg(trees["pad_h"], trees["ckpt"], root / "pad_sp",
                                                    {"num_devices": 4, "spatial_parallel": 4,
                                                     "pad_h": True}))),
    ]
    return dict(zip(("halo", "forward", "steps", "test", "train", "pad_h"),
                    distributed.spawn(workers.run_tasks, (tasks,), world=4)))


def _infer_args(trees, out, *extra):
    return [str(trees["ckpt"]), str(trees["pad_h"]["videos_dir"]),
            str(trees["pad_h"]["pos_code_path"]), str(out), "--net-kwargs", json.dumps(NET),
            *extra]


# ------------------------------------------------------------------ halos
@pytest.mark.parametrize("world", ["world2", "world4"])
def test_halo_convs_equal_the_whole_conv(world, request):
    errors = request.getfixturevalue(world)["halo"]
    assert set(errors) == {"conv2d torch.contiguous_format", "conv2d torch.channels_last",
                           "conv3d"}
    for name, e in errors.items():
        assert e["out"] <= 1e-6 and e["dx"] <= 1e-5 and e["dw"] <= 1e-5, (name, e)


# ---------------------------------------------------------------- forward
@pytest.fixture(scope="module")
def jax_forward(params):
    batch = _batch(1)
    apply = jax.jit(lambda p, lr, pos: JaxRefineNet(**NET).apply({"params": p}, lr, pos)[-1])
    return np.asarray(apply(params, batch["lr_imgs"], batch["pos_code"]))


@pytest.mark.parametrize("world,items", [("world2", B), ("world4", B // 2)])
def test_spatial_forward_matches_the_jax_meshless_forward(world, items, jax_forward, request):
    got = request.getfixturevalue(world)["forward"]
    assert got.shape == (items, 3, H * 4, W * 4, 1)  # rank 0: its data slice, rows gathered
    np.testing.assert_allclose(got, jax_forward[:items], atol=1e-5)


def test_bf16_spatial_forward_gap_to_fp32_matches_jax(world2, jax_forward, params):
    """bf16 halos: the spatial bf16 forward's gap to the fp32 one is the
    size of the JAX package's bf16-vs-fp32 gap (``tests/test_torch_tpu_knobs.py``'s
    ``BF16_GAP_RATIO``), and its outputs are bf16 values."""
    batch = _batch(1)
    apply = jax.jit(lambda p, lr, pos: JaxRefineNet(**NET).apply({"params": p}, lr, pos)[-1])
    as16 = functools.partial(jax.tree.map, lambda x: jnp.asarray(x, jnp.bfloat16))
    jax16 = np.asarray(apply(as16(params), *as16((batch["lr_imgs"], batch["pos_code"]))),
                       np.float32)
    got = world2["forward_bf16"]
    assert np.array_equal(got, np.asarray(jnp.asarray(got, jnp.bfloat16), np.float32))
    ratio = np.linalg.norm(got - jax_forward) / np.linalg.norm(jax16 - jax_forward)
    assert 0.6 <= ratio <= 1.5, ratio


# ------------------------------------------------------------- train step
def test_dp_sp_step_matches_the_jax_single_device_step(world4, params):
    items = _items(_batch(3))
    loader = JaxDataloader(workers.ListDataset(items), batch_size=B, shuffle=False)
    optimizer = JaxOptimizer(SGD[0], **SGD[1])
    trainer = JaxTrainer(device="cpu", train_dataloader=loader, valid_dataloader=loader,
                         net=JaxRefineNet(**NET), loss_fns=[JL.L1Loss()], loss_weights=[1.0],
                         metric_fns=[JM.PSNR()], optimizer=optimizer, num_epochs=1,
                         telemetry=False)
    trainer.params = jax.tree.map(jnp.asarray, params)
    trainer.opt_state = optimizer.init(trainer.params)
    want_log, _, _ = trainer._run_epoch("training")
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, trainer.params))
    got = world4["steps"]["plain"]
    assert got["mesh"] == {"data": 2, "spatial": 2} and got["warned"] == []
    assert got["log"]["Loss"] == pytest.approx(want_log["Loss"], rel=1e-5)
    assert got["log"]["PSNR"] == pytest.approx(want_log["PSNR"], rel=1e-5)
    for key, value in want.items():
        np.testing.assert_allclose(got["state"][key].numpy(), value, atol=1e-5, rtol=1e-5,
                                   err_msg=key)


def test_dp_sp_remat_step_equals_the_plain_step(world4):
    plain, remat = world4["steps"]["plain"], world4["steps"]["remat"]
    assert remat["log"]["Loss"] == pytest.approx(plain["log"]["Loss"], rel=1e-6)
    for key, value in plain["state"].items():
        np.testing.assert_allclose(remat["state"][key].numpy(), value.numpy(), atol=1e-6,
                                   err_msg=key)
    # the recompute repeats the core steps' gate-conv exchanges: 2 layers ×
    # 2 directions × 3 core frames
    assert remat["exchanges"]["forward"] - plain["exchanges"]["forward"] == 12
    assert remat["exchanges"]["backward"] == plain["exchanges"]["backward"] > 0


# ------------------------------------------------- the trainer's knobs
def _single(items, batch, **kwargs):
    return workers.train_steps("refine", kwargs.pop("state"), NET, items, batch, None, **kwargs)


@pytest.fixture(scope="module")
def single_knobs(params):
    """The same epochs on one device, no mesh."""
    state = state_dict_from_jax_params(params)
    return {"accum": _single(_items(_batch(3)), B // 2, state=state, optimizer=SGD,
                             grad_accum_steps=2),
            "bf16": _single(_items(_batch(3)), B // 2, state=state, optimizer=SGD, onednn=False,
                            compute_dtype="bfloat16"),
            "skip": _single(_poisoned(), B // 2, state=state,
                            optimizer=("SGD", {"lr": 1e-2, "skip_nonfinite": 3}))}


@pytest.mark.parametrize("knob,tol", [
    ("accum", 1e-5),
    # bf16 rounds each conv's output; the bands' sums round as the whole
    # frame's do up to the order of a few additions
    ("bf16", 1e-4),
    ("skip", 1e-5),
])
def test_trainer_knobs_on_spatial_2_match_one_device(world2, single_knobs, knob, tol):
    got, want = world2["knobs"][knob], single_knobs[knob]
    assert got["mesh"] == {"data": 1, "spatial": 2} and got["warned"] == []
    for key, value in want["log"].items():
        if np.isfinite(value):
            assert got["log"][key] == pytest.approx(value, rel=tol), key
        else:  # the poisoned step's loss is logged as it came
            assert not np.isfinite(got["log"][key]), key
    for key, value in want["state"].items():
        np.testing.assert_allclose(got["state"][key].numpy(), value.numpy(), atol=tol, rtol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["accum.pth", "accum_dir"])
def test_spatial_checkpoints_hold_the_whole_state(world2, trees, name):
    """A ``.pth`` (the lead's) and a directory checkpoint (every rank's)
    written on the spatial mesh hold the trained weights whole."""
    ckpt = load_checkpoint(trees["root"] / name)
    want = world2["knobs"]["accum"]["state"]
    assert ckpt["net"].keys() == want.keys()
    for key, value in want.items():
        torch.testing.assert_close(ckpt["net"][key], value, rtol=0, atol=0, msg=key)


# --------------------------------------------------- the flagship YAMLs
@pytest.fixture(scope="module")
def flagship_meshless(trees):
    """The flagship's test YAML through the port's and the JAX package's
    ``main`` and its train YAML's epoch through the port's, all meshless."""
    root, tree, ckpt = trees["root"], trees["flagship"], trees["flagship_ckpt"]
    return {"test": run_port_test(Cfg(_flagship("test", root / "test_port", tree, ckpt))).log,
            "test_jax": run_jax_test(JaxCfg(_flagship("test", root / "test_jax", tree, ckpt))).log,
            "train": run_port_train(Cfg(_flagship("train", root / "train_port", tree,
                                                  None))).history}


MESHES = {"world2": {"data": 1, "spatial": 2}, "world4": {"data": 2, "spatial": 2}}


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_flagship_test_yaml_matches_meshless_runs(world, flagship_meshless, request):
    port, jax_log = flagship_meshless["test"], flagship_meshless["test_jax"]
    got = request.getfixturevalue(world)["test"]
    assert got["mesh"] == MESHES[world] and got["warned"] == []
    assert list(got["log"]) == list(port)
    for key in port:
        assert got["log"][key] == pytest.approx(port[key], rel=1e-5), key
        np.testing.assert_allclose(got["log"][key], float(jax_log[key]), rtol=2e-3, atol=2e-3,
                                   err_msg=key)


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_flagship_train_yaml_matches_the_meshless_epoch(world, flagship_meshless, request):
    got = request.getfixturevalue(world)["train"]
    assert got["mesh"] == MESHES[world] and got["warned"] == []
    for split in ("train", "valid"):
        want = flagship_meshless["train"][split][0]
        assert list(got["history"][split][0]) == list(want)
        for key, value in want.items():
            assert got["history"][split][0][key] == pytest.approx(value, rel=1e-5), (split, key)


# ------------------------------------------------------------------ pad_h
def test_pad_h_matches_the_jax_pad_h_run(world4, trees):
    jax_mesh_mod._WARNED.clear()
    want = run_jax_test(JaxCfg(_pad_h_cfg(trees["pad_h"], trees["ckpt"],
                                          trees["root"] / "pad_jax",
                                          {"num_devices": 8, "spatial_parallel": 4,
                                           "pad_h": True})))
    assert not any(k[0] == "spatial" for k in jax_mesh_mod._WARNED)
    got = world4["pad_h"]
    assert got["pad_h"] and got["mesh"] == {"data": 1, "spatial": 4}
    assert got["warned"] == []  # padded heights shard: no downgrade
    assert list(got["log"]) == list(want.log)
    for key, value in want.log.items():
        assert got["log"][key] == pytest.approx(float(value), rel=1e-5), key


# ------------------------------------------------------------ batch_infer
def test_batch_infer_spatial_pad_h_rows_equal_the_jax_tool(world2, trees):
    out = trees["root"] / "jax_sp.csv"
    jax_tool.main(_infer_args(trees, out, "--num-devices", "2", "--spatial-parallel", "2",
                              "--pad-h"))
    with open(out, newline="") as f:
        want = list(csv.reader(f))
    with open(trees["root"] / "sp.csv", newline="") as f:
        got = list(csv.reader(f))
    assert world2["batch_infer"]["devices"] == 1
    assert got[0] == want[0] and [r[:2] for r in got] == [r[:2] for r in want]
    assert len(got) > 1
    for g, w in zip(got[1:], want[1:]):
        assert float(g[2]) == pytest.approx(float(w[2]), abs=1e-4), g[0]
        assert float(g[3]) == pytest.approx(float(w[3]), abs=1e-5), g[0]
