"""The port's spatial axis for the zoo (EDSRNet, SRFBNet, DRFSISRNet, DRFNet,
Bicubic, DUFNet, RBPNet) against the JAX package.

Ranks are processes of a gloo group on the CPU, spawned twice for the
whole file (``parallel/distributed.spawn``; the bodies are in
``tests/torch_parallel_workers.py``): 2 ranks (spatial 2), and 4 ranks
(data 2 × spatial 2; spatial 4 for the halo units and ``pad_h``).  The
JAX package is the oracle, as its ``tests/test_parallel.py`` holds its own
spatial mesh to one device, on the same weights (the port's seeded init,
carried into the JAX package by its ``variables_from_torch_state_dict``):

* the strided ``halo_conv2d`` and ``halo_conv_transpose2d`` at every
  ``PROJ_PARAMS`` factor (float64) against the whole op on every rank:
  output 1e-6, input and weight gradients 1e-5 (``test_torch_spatial.py``'s
  bounds for the stride-1 halos); the band resizes against the whole
  frame's (1e-6), at 2 rows a rank (a halo) and 1 (bicubic gathers);
* each net's forward on spatial 2 and on data 2 × spatial 2, rows
  gathered, against the JAX package's meshless forward (atol 1e-5; SRFB
  and RBPN at ×2, ×3, ×4, the rest at ×4), with the halo exchanges each
  forward makes; SRFBNet's also against the JAX package's own (data 2,
  spatial 4) forward on its 8 virtual devices;
* one SGD step of SRFBNet and of DUFNet on data 2 × spatial 2 against the
  JAX trainer's step on one device (loss rel 1e-5, parameters and running
  statistics 1e-5, ``test_dp_sp_step_matches_the_jax_single_device_step``'s
  bounds), and DUFNet at a height spatial 2 does not divide (every rank of
  a group then holds the whole item) on both meshes against the same;
* DRFNet with ``remat: true`` on spatial 2 against the plain step (1e-6);
* one shrunk test YAML of each family through ``main`` on spatial 2 against
  the port's meshless run (Test log rel 1e-5), and
  ``train/srfb_net/exp1_x4.yaml`` for one epoch against the meshless epoch;
* ``pad_h`` for EDSRNet at LR height 11 over spatial 4 against the JAX
  package's own ``pad_h`` run on its 8 virtual devices (rel 1e-5; the
  SSIMs of this random net on noise are near 0, where the two frameworks'
  float32 sums agree to 1e-6 absolute), with no spatial warning;
* ``main._check_parallel`` accepts the seven, and TOFlowNet, FRVSRNet and
  EDVRNet too (their axis: ``tests/test_torch_spatial_video.py``), and
  refuses the spatial axis with the model axis.
"""
import functools
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
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.config import (
    Cfg as JaxCfg,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.data.loader import (
    Dataloader as JaxDataloader,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.main import (
    test_from_config as run_jax_test,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.parallel import (
    make_mesh as jax_make_mesh,
    mesh as jax_mesh_mod,
    replicate_tree,
    shard_batch,
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
    _check_parallel,
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
B, HW = 4, 8  # items of a batch, LR side
SGD = ("SGD", {"lr": 1e-2})
#: name → (kwargs without upscale_factor, frames (None: one image), factors)
NETS = {
    "EDSRNet": (dict(in_channels=1, out_channels=1, num_resblocks=2, num_features=8), None,
                (4,)),
    "SRFBNet": (dict(in_channels=1, out_channels=1, num_steps=2, num_features=8, num_groups=2),
                None, (2, 3, 4)),
    "DRFSISRNet": (dict(in_channels=1, out_channels=1, num_steps=2, num_features=8,
                        num_groups=2), None, (4,)),
    "Bicubic": ({}, None, (4,)),
    "DRFNet": (dict(in_channels=1, out_channels=1, num_features=8, num_groups=2), 3, (4,)),
    "DUFNet": (dict(in_channels=1, out_channels=1, num_frames=7, size_filter=5,
                    backbone="_DenseLayer16"), 7, (4,)),
    "RBPNet": (dict(in_channels=1, out_channels=1, base_filter=16, feat=8, num_stages=3,
                    num_resblocks=2, num_frames=5), 5, (2, 3, 4)),
}
CASES = [(name, r) for name, (_, _, factors) in NETS.items() for r in factors]


def _exchanges(name: str) -> int:
    """Halo exchanges of one forward of the shrunk net (``PERF.md`` §5's
    counts at these depths): one a conv with an H window, one a resize or
    unfold."""
    kw, T, _ = NETS[name]
    up = 2 + 1  # ×4: 2 conv+shuffle stages and the final conv
    if name == "EDSRNet":
        return 2 * kw["num_resblocks"] + 3 + 2
    if name == "SRFBNet":  # LR conv, the skip; a step: up and down projections, deconv, conv
        return 2 + kw["num_steps"] * (2 * kw["num_groups"] + 2)
    if name == "DRFSISRNet":
        return 1 + kw["num_steps"] * (2 * kw["num_groups"] + up)
    if name == "DRFNet":
        return 1 + T * (2 * kw["num_groups"] + up)
    if name == "Bicubic":
        return 1
    if name == "DUFNet":  # head, 6 blocks' 3×3×3, the tail's (1,3,3), the unfold
        return 1 + 6 + 1 + 1
    n, chain = T - 1, 2 * kw["num_resblocks"] + 1  # RBPNet
    return 1 + n + (n - 1) * chain + 15 * n + 2 * n * chain + 1


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
def _input(name: str, seed: int = 1) -> np.ndarray:
    T = NETS[name][1]
    shape = (B, HW, HW, 1) if T is None else (B, T, HW, HW, 1)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights(name: str, r: int) -> tuple[dict, dict]:
    """The port's seeded init at ×r and the same weights as the JAX
    package's variables (its ``variables_from_torch_state_dict``, a
    bit-exact round trip: ``tests/test_torch_{sisr,misr,vsr}_nets.py``);
    the JAX init of these nets is slower than the rest of the file."""
    net = getattr(models, name)(upscale_factor=r, **NETS[name][0],
                                generator=torch.Generator().manual_seed(0))
    state = net.state_dict()
    return state, variables_from_torch_state_dict(name, state) if state else {}


def _jax_pair(name: str, r: int):
    """The JAX net at ×r and its variables."""
    return getattr(jax_models, name)(upscale_factor=r, **NETS[name][0]), _weights(name, r)[1]


def _state(name: str, r: int) -> dict:
    return _weights(name, r)[0]


def _jax_apply(net, variables, x):
    """The forward in eval, each step's output stacked (one for the nets
    with one output)."""
    out = net.apply(variables, x, **({"train": False} if "batch_stats" in variables else {}))
    return jnp.stack(out) if isinstance(out, (list, tuple)) else out[None]


@pytest.fixture(scope="module")
def jax_forwards():
    out = {}
    for name, r in CASES:
        net, variables = _jax_pair(name, r)
        out[name, r] = np.asarray(jax.jit(functools.partial(_jax_apply, net))(
            variables, _input(name)))
    return out


def _forward_tasks() -> list:
    return [("zoo_forward", dict(name=name, net_kwargs={**NETS[name][0], "upscale_factor": r},
                                 net_state=_state(name, r), lr=_input(name), spatial=2))
            for name, r in CASES]


# ------------------------------------------------------------ the steps
def _sisr_items(seed=3, n=B, hw=HW, r=4):
    rng = np.random.default_rng(seed)
    return [{"lr_img": rng.standard_normal((hw, hw, 1)).astype(np.float32),
             "hr_img": rng.standard_normal((hw * r, hw * r, 1)).astype(np.float32)}
            for _ in range(n)]


def _duf_items(h: int, seed=3, n=B, w=6, r=4):
    rng = np.random.default_rng(seed)
    return [{"lr_imgs": rng.standard_normal((7, h, w, 1)).astype(np.float32),
             "hr_img": rng.standard_normal((h * r, w * r, 1)).astype(np.float32)}
            for _ in range(n)]


def _drf_items(seed=3, n=B, T=3, hw=HW, r=4):
    rng = np.random.default_rng(seed)
    return [{"lr_imgs": rng.standard_normal((T, hw, hw, 1)).astype(np.float32),
             "hr_imgs": rng.standard_normal((T, hw * r, hw * r, 1)).astype(np.float32)}
            for _ in range(n)]


DUF_KW = {**NETS["DUFNet"][0], "upscale_factor": 4}
SRFB_KW = {**NETS["SRFBNet"][0], "upscale_factor": 4}
DRF_KW = {**NETS["DRFNet"][0], "upscale_factor": 4}
ODD_H = 5  # spatial 2 does not divide it: every rank of a group holds the whole item


def _step_task(kind, items, remat=(False,)):
    kwargs = {"srfb": SRFB_KW, "duf": DUF_KW, "drf": DRF_KW}[kind]
    name = {"srfb": "SRFBNet", "duf": "DUFNet", "drf": "DRFNet"}[kind]
    return ("zoo_steps", dict(kind=kind, net_state=_state(name, 4), net_kwargs=kwargs,
                              items=items, batch=B, spatial=2, optimizer=SGD, remat=remat))


# ------------------------------------------------------------ the YAMLs
SHRINK = {"EDSRNet": {"num_resblocks": 2, "num_features": 8},
          "SRFBNet": {"num_steps": 2, "num_features": 8, "num_groups": 2},
          "DUFNet": {}, "Bicubic": {},
          "RBPNet": {"base_filter": 16, "feat": 8, "num_resblocks": 2},
          "DRFNet": {"num_features": 8, "num_groups": 2}}
FAMILIES = ["edsr_net", "srfb_net", "bicubic", "duf_net", "rbp_net", "drf_net"]


def _yaml(kind: str, family: str, tmp: Path, tree: dict, parallel=None) -> dict:
    """``configs/{kind}/{family}/exp1_x4.yaml`` as shipped, patched for a
    small CPU run: the net shrunk, the data paths into ``tree``, seeded
    weights, no export; a train YAML one epoch of batch 4."""
    cfg = load_config(REPO / "configs" / kind / family / "exp1_x4.yaml")
    name = cfg["net"]["name"]
    cfg["net"]["kwargs"].update(SHRINK[name])
    cfg["main"]["saved_dir"] = str(tmp)
    kw = cfg["dataset"]["kwargs"]
    video = "num_frames" in kw
    kw["data_dir"] = str(tree["videos_dir"] if video else tree["imgs_dir"])
    cfg["dataloader"]["kwargs"]["num_workers"] = 0
    for metric in cfg["metrics"]:
        if "coordinates_path" in (metric.get("kwargs") or {}):
            metric["kwargs"]["coordinates_path"] = str(tree["coordinates_path"])
    if kind == "test":
        if name != "Bicubic":
            ckpt = tmp.parent / f"{family}.pth"
            if not ckpt.exists():
                net = getattr(models, name)(**cfg["net"]["kwargs"],
                                            generator=torch.Generator().manual_seed(0))
                torch.save({"net": net.state_dict()}, ckpt)
            cfg["main"]["loaded_path"] = str(ckpt)
        cfg["predictor"]["kwargs"].update(device="cpu", exported=False, saved_dir=str(tmp))
    else:
        cfg["trainer"]["kwargs"].update(device="cpu", num_epochs=1)
        cfg["dataloader"]["kwargs"]["train_batch_size"] = 4
        for aug in kw["augments"]:
            if aug["name"] == "RandomCropPatch":
                aug["kwargs"]["size"] = [HW, HW]  # LR pixels: the tree's whole frame
        cfg["logger"]["kwargs"]["dummy_input"] = [4, 1, HW, HW]
    if parallel:
        cfg["parallel"] = parallel
    return cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)


def _pad_h_cfg(tree: dict, ckpt: Path, saved: Path, parallel=None) -> dict:
    """The shrunk EDSR test YAML on a tree of LR height 11."""
    out = _yaml("test", "edsr_net", saved, tree)
    out["main"]["loaded_path"] = str(ckpt)
    if parallel:
        out["parallel"] = parallel
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_zoo")
    # LR 8×8; 10 frames: windows of 7 and a clip
    tree = make_acdc_tree(root / "tree", patients_per_split=1, slices=1, frames=10,
                          hr_size=(32, 32))
    # pad_h: LR height 44 / 4 = 11, which spatial 4 does not divide
    padded = make_acdc_tree(root / "pad_h", patients_per_split=1, slices=1, frames=4,
                            hr_size=(44, 44))
    ckpt = root / "edsr_pad_h.pth"
    torch.save({"net": _state("EDSRNet", 4)}, ckpt)
    return {"root": root, "tree": tree, "pad_h": padded, "pad_h_ckpt": ckpt}


def _yaml_tasks(trees: dict) -> list:
    root, tree = trees["root"], trees["tree"]
    parallel = {"num_devices": 2, "spatial_parallel": 2}
    return [("predict_from_config", dict(cfg=_yaml("test", f, root / f"sp_{f}", tree, parallel)))
            for f in FAMILIES] + [
        ("train_from_config", dict(cfg=_yaml("train", "srfb_net", root / "sp_train", tree,
                                             parallel)))]


@pytest.fixture(scope="module")
def world2(trees):
    """Spatial 2: the halo units, the forwards, DUF at an odd height, DRF's
    remat step, the YAMLs through ``main``."""
    tasks = [("zoo_halo_errors", {}), *_forward_tasks(),
             _step_task("duf", _duf_items(ODD_H)),
             _step_task("drf", _drf_items(), remat=(False, True)),
             *_yaml_tasks(trees)]
    out = distributed.spawn(workers.run_tasks, (tasks,), world=2)
    n = len(CASES)
    return {"halo": out[0], "forward": dict(zip(CASES, out[1:1 + n])),
            "duf_odd": out[1 + n][False], "drf": out[2 + n],
            "test": dict(zip(FAMILIES, out[3 + n:3 + n + len(FAMILIES)])), "train": out[-1]}


@pytest.fixture(scope="module")
def world4(trees):
    """Data 2 × spatial 2 (the halo units at spatial 4 first): the forwards,
    the SRFB and DUF steps, DUF at an odd height; then ``pad_h`` over
    spatial 4."""
    tasks = [("zoo_halo_errors", {}), *_forward_tasks(),
             _step_task("srfb", _sisr_items()), _step_task("duf", _duf_items(HW)),
             _step_task("duf", _duf_items(ODD_H)),
             ("predict_from_config", dict(cfg=_pad_h_cfg(
                 trees["pad_h"], trees["pad_h_ckpt"], trees["root"] / "pad_sp",
                 {"num_devices": 4, "spatial_parallel": 4, "pad_h": True})))]
    out = distributed.spawn(workers.run_tasks, (tasks,), world=4)
    n = len(CASES)
    return {"halo": out[0], "forward": dict(zip(CASES, out[1:1 + n])),
            "srfb": out[1 + n][False], "duf": out[2 + n][False], "duf_odd": out[3 + n][False],
            "pad_h": out[4 + n]}


# ------------------------------------------------------------------ halos
HALO_OPS = [f"{op} x{r}" for r in (2, 3, 4, 8) for op in ("conv", "deconv")]
RESIZES = [f"{kind} x{r} {rows} rows" for rows in (2, 1) for kind in ("bilinear", "bicubic")
           for r in (2, 3, 4)]


@pytest.mark.parametrize("op", HALO_OPS)
@pytest.mark.parametrize("world", ["world2", "world4"])
def test_strided_and_transposed_halos_equal_the_whole_conv(world, op, request):
    e = request.getfixturevalue(world)["halo"]["errors"][op]
    assert e["out"] <= 1e-6 and e["dx"] <= 1e-5 and e["dw"] <= 1e-5, e


@pytest.mark.parametrize("resize", RESIZES)
@pytest.mark.parametrize("world", ["world2", "world4"])
def test_band_resize_equals_the_whole_frames(world, resize, request):
    got = request.getfixturevalue(world)["halo"]
    assert got["errors"][resize]["out"] <= 1e-6
    # a bilinear band reaches one row past its own, a bicubic one two; at
    # one row a rank over 4 ranks bicubic gathers the frame
    want = 1 if "bilinear" in resize else 2 if "2 rows" in resize else (
        1 if world == "world2" else None)
    assert got["halos"][resize] == want


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("name,r", CASES, ids=[f"{n}-x{r}" for n, r in CASES])
@pytest.mark.parametrize("world,items", [("world2", B), ("world4", B // 2)])
def test_spatial_forward_matches_the_jax_meshless_forward(world, items, name, r, jax_forwards,
                                                          request):
    got = request.getfixturevalue(world)["forward"][name, r]
    want = jax_forwards[name, r]
    assert got["out"].shape == (want.shape[0], items, *want.shape[2:])
    np.testing.assert_allclose(got["out"], want[:, :items], atol=1e-5)
    assert got["exchanges"] == {"forward": _exchanges(name), "backward": 0}


def test_srfb_matches_the_jax_package_spatial_mesh(world2, jax_forwards):
    """The JAX package's own (data 2, spatial 4) forward on its 8 virtual
    devices is its meshless one, which the port's spatial forward is."""
    net, variables = _jax_pair("SRFBNet", 4)
    mesh = jax_make_mesh(8, spatial_parallel=4)
    x = shard_batch(mesh, {"lr_img": _input("SRFBNet")})["lr_img"]
    got = np.asarray(jax.jit(functools.partial(_jax_apply, net))(
        replicate_tree(mesh, variables), x))
    np.testing.assert_allclose(got, jax_forwards["SRFBNet", 4], atol=1e-5)
    np.testing.assert_allclose(world2["forward"]["SRFBNet", 4]["out"], got, atol=1e-5)


# ------------------------------------------------------------ train steps
def _jax_step(name: str, trainer_cls, items: list, loss):
    """One SGD step of the JAX trainer on one device over ``items`` → (train
    log, the port's state_dict of the stepped weights and statistics)."""
    net, variables = _jax_pair(name, 4)
    loader = JaxDataloader(workers.ListDataset(items), batch_size=B, shuffle=False)
    optimizer = JaxOptimizer(SGD[0], **SGD[1])
    trainer = trainer_cls(device="cpu", train_dataloader=loader, valid_dataloader=loader,
                          net=net, loss_fns=[loss], loss_weights=[1.0], metric_fns=[JM.PSNR()],
                          optimizer=optimizer, num_epochs=1, telemetry=False)
    trainer.params = jax.tree.map(jnp.asarray, variables["params"])
    trainer.model_state = {k: jax.tree.map(jnp.asarray, v) for k, v in variables.items()
                           if k != "params"}
    trainer.opt_state = optimizer.init(trainer.params)
    log, _, _ = trainer._run_epoch("training")
    state = state_dict_from_jax_params(
        {"params": jax.tree.map(np.asarray, trainer.params),
         **jax.tree.map(np.asarray, trainer.model_state)}, name)
    return log, state


@pytest.fixture(scope="module")
def jax_steps():
    return {"srfb": _jax_step("SRFBNet", jax_trainers.SISRSRFBTrainer, _sisr_items(),
                              JL.L1Loss()),
            "duf": _jax_step("DUFNet", jax_trainers.MISRTrainer, _duf_items(HW), JL.MSELoss()),
            "duf_odd": _jax_step("DUFNet", jax_trainers.MISRTrainer, _duf_items(ODD_H),
                                 JL.MSELoss())}


def _assert_step(got: dict, want: tuple, mesh: dict, warned: list):
    want_log, want_state = want
    assert got["mesh"] == mesh and got["warned"] == warned
    assert got["log"]["Loss"] == pytest.approx(want_log["Loss"], rel=1e-5)
    assert got["log"]["PSNR"] == pytest.approx(want_log["PSNR"], rel=1e-5)
    for key, value in want_state.items():
        if value.is_floating_point():  # the running statistics too
            np.testing.assert_allclose(got["state"][key].numpy(), value.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("kind", ["srfb", "duf"])
def test_dp_sp_step_matches_the_jax_single_device_step(world4, jax_steps, kind):
    got = world4[kind]
    _assert_step(got, jax_steps[kind], {"data": 2, "spatial": 2}, [])
    # every exchange of the forward has a backward but the LR input's
    forward = _exchanges("SRFBNet" if kind == "srfb" else "DUFNet")
    assert got["exchanges"] == {"forward": forward, "backward": forward - 2}


@pytest.mark.parametrize("world,mesh", [("world2", {"data": 1, "spatial": 2}),
                                        ("world4", {"data": 2, "spatial": 2})])
def test_duf_step_at_an_indivisible_height_matches_the_jax_step(world, mesh, jax_steps, request):
    """Every rank of a spatial group holds the whole item: BatchNorm reduces
    over the data ranks only, so each item is counted once (the unbiased
    running variance reads the count)."""
    got = request.getfixturevalue(world)["duf_odd"]
    _assert_step(got, jax_steps["duf_odd"], mesh, ["spatial"])
    assert got["exchanges"] == {"forward": 0, "backward": 0}


def test_drf_remat_step_equals_the_plain_step(world2):
    plain, remat = world2["drf"][False], world2["drf"][True]
    assert plain["mesh"] == {"data": 1, "spatial": 2} and plain["warned"] == []
    assert remat["log"]["Loss"] == pytest.approx(plain["log"]["Loss"], rel=1e-6)
    for key, value in plain["state"].items():
        np.testing.assert_allclose(remat["state"][key].numpy(), value.numpy(), atol=1e-6,
                                   err_msg=key)
    # the recompute repeats each frame step's exchanges: T × (2 groups × 2
    # projections + 3 upsampler convs)
    forward = _exchanges("DRFNet")
    assert plain["exchanges"] == {"forward": forward, "backward": forward - 1}
    assert remat["exchanges"] == {"forward": 2 * forward - 1, "backward": forward - 1}


# ----------------------------------------------------------- the YAMLs
@pytest.fixture(scope="module")
def meshless(trees):
    root, tree = trees["root"], trees["tree"]
    return {"test": {f: run_port_test(Cfg(_yaml("test", f, root / f"one_{f}", tree))).log
                     for f in FAMILIES},
            "train": run_port_train(Cfg(_yaml("train", "srfb_net", root / "one_train",
                                               tree))).history}


@pytest.mark.parametrize("family", FAMILIES)
def test_test_yaml_on_spatial_2_matches_the_meshless_run(world2, meshless, family):
    got, want = world2["test"][family], meshless["test"][family]
    assert got["mesh"] == {"data": 1, "spatial": 2} and got["warned"] == []
    assert list(got["log"]) == list(want)
    for key, value in want.items():
        assert got["log"][key] == pytest.approx(value, rel=1e-5), key


def test_srfb_train_yaml_on_spatial_2_matches_the_meshless_epoch(world2, meshless):
    got = world2["train"]
    assert got["mesh"] == {"data": 1, "spatial": 2} and got["warned"] == []
    for split in ("train", "valid"):
        want = meshless["train"][split][0]
        assert list(got["history"][split][0]) == list(want)
        for key, value in want.items():
            assert got["history"][split][0][key] == pytest.approx(value, rel=1e-5), (split, key)


# ------------------------------------------------------------------ pad_h
#: SSIM of 255-scale frames in float32 against another framework's: σ_xy =
#: E[xy] − μxμy cancels terms of ~1e4 rounded to ~1e-7 relative, and XLA's
#: and oneDNN's window convolutions sum in other orders, so the means of a
#: near-zero SSIM (a random net on a noise tree) differ by up to ~1e-6
#: absolute (3.0e-7 measured here); the other keys hold rel 1e-5
SSIM_FLOOR = 1e-6


def test_pad_h_for_a_sisr_net_matches_the_jax_pad_h_run(world4, trees):
    jax_mesh_mod._WARNED.clear()
    want = run_jax_test(JaxCfg(_pad_h_cfg(trees["pad_h"], trees["pad_h_ckpt"],
                                          trees["root"] / "pad_jax",
                                          {"num_devices": 8, "spatial_parallel": 4,
                                           "pad_h": True})))
    assert not any(k[0] == "spatial" for k in jax_mesh_mod._WARNED)
    got = world4["pad_h"]
    assert got["pad_h"] and got["mesh"] == {"data": 1, "spatial": 4}
    assert got["warned"] == []  # padded heights shard: no downgrade
    assert list(got["log"]) == list(want.log)
    for key, value in want.log.items():
        floor = SSIM_FLOOR if "SSIM" in key else 0.0
        assert got["log"][key] == pytest.approx(float(value), rel=1e-5, abs=floor), key


# ------------------------------------------------------------- the boundary
@pytest.mark.parametrize("net", list(NETS))
def test_check_parallel_accepts_the_ready_nets(net):
    cfg = Cfg({"parallel": {"num_devices": 2, "spatial_parallel": 2}, "net": {"name": net}})
    assert _check_parallel(cfg, torch.device("cpu")) == {"num_devices": 2, "spatial_parallel": 2}
    # no band of theirs asks for a multiple of rows: any height the spatial
    # size divides shards
    assert not hasattr(getattr(models, net), "band_misfit")


@pytest.mark.parametrize("net", ["TOFlowNet", "FRVSRNet", "EDVRNet"])
def test_check_parallel_refuses_the_unbounded_nets(net):
    """The warping and deformable nets were refused until their spatial
    axis was ported (``tests/test_torch_spatial_video.py`` holds it to the
    JAX package); what stays refused for them, as for every net, is the
    spatial axis together with the model axis.  Their pads and pyramids
    ask a band for a multiple of rows: an LR height of 16 gives such bands
    on 2 ranks, one of 36 does not (``parallel/mesh.spatial_step`` then
    replicates the item)."""
    cfg = Cfg({"parallel": {"num_devices": 2, "spatial_parallel": 2}, "net": {"name": net}})
    assert _check_parallel(cfg, torch.device("cpu")) == {"num_devices": 2, "spatial_parallel": 2}
    small = {"TOFlowNet": dict(num_frames=3, upscale_factor=4),
             "FRVSRNet": dict(upscale_factor=4, num_resblocks=1),
             "EDVRNet": dict(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)}[net]
    built = getattr(models, net)(in_channels=1, out_channels=1, **small)
    assert built.band_misfit(16, 2) is None
    assert "a band must be a multiple" in built.band_misfit(36, 2)
    cfg = Cfg({"parallel": {"num_devices": 4, "spatial_parallel": 2, "model_parallel": 2},
               "net": {"name": net}})
    with pytest.raises(ValueError, match="cannot be combined"):
        _check_parallel(cfg, torch.device("cpu"))
