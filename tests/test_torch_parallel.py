"""The port's data axis and checkpoint backends against the JAX package.

Ranks are processes of a gloo group on the CPU (``parallel/distributed.spawn``;
their bodies are in ``tests/torch_parallel_workers.py``).  The JAX package is
the oracle: its trainer on ``make_mesh(2)`` (8 virtual CPU devices,
``conftest.py``) and on one device, as ``tests/test_parallel.py:89`` holds
its own mesh step to the single-device one.  Tolerances: a step's loss
and parameters within 1e-5 (the JAX test's); DUF's BatchNorm running
statistics within 1e-5, its gradients as the JAX test's (5e-5 abs, 1e-4
rel), since the all-reduced sums and the single-device sums add in
another order.
"""
import csv
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
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.data.loader import (
    Dataloader as JaxDataloader,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.models import (
    DUFNet as JaxDUFNet,
    RefineNet as JaxRefineNet,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.parallel import (
    make_mesh as jax_make_mesh,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.optim import (
    Optimizer as JaxOptimizer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.trainers import (
    MISRTrainer as JaxMISRTrainer,
    VSRRefineNetTrainer as JaxTrainer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import parallel
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import Cfg
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import run
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import (
    distributed,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import (
    checkpoint as ckpt_io,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)

sys.path.insert(0, str(Path(__file__).parent))
import torch_parallel_workers as workers  # noqa: E402
from fixtures import make_acdc_tree  # noqa: E402

TC, U, HW, SCALE = 3, 2, 6, 4
NET = dict(in_channels=1, out_channels=1, num_features=[4, 4], num_stages=1,
           refine_window_size=5, upscale_factor=SCALE, update_memory=True,
           num_updated_frames=U, positional_encoding=True)
DUF = dict(in_channels=1, out_channels=1, num_frames=7, size_filter=5, upscale_factor=SCALE,
           backbone="_DenseLayer16")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_a_rank():
    """One intra-op thread here and in every rank spawned (they inherit
    ``OMP_NUM_THREADS``): test workers and ranks run side by side, and
    spinning thread pools that share the cores stall each other and gloo."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env



def _refine_items(n, seed=0):
    rng = np.random.default_rng(seed)
    T = TC + 2 * U
    return [{"lr_imgs": rng.standard_normal((T, HW, HW, 1)).astype(np.float32),
             "hr_imgs": rng.standard_normal((TC, HW * SCALE, HW * SCALE, 1)).astype(np.float32),
             "pos_code": rng.uniform(-1, 1, (T, 1)).astype(np.float32)} for _ in range(n)]


def _duf_items(n, seed=1):
    rng = np.random.default_rng(seed)
    return [{"lr_imgs": rng.standard_normal((7, HW, HW, 1)).astype(np.float32),
             "hr_img": rng.standard_normal((HW * SCALE, HW * SCALE, 1)).astype(np.float32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def refine_params():
    items = _refine_items(1)
    params = jax.jit(JaxRefineNet(**NET).init)(
        jax.random.PRNGKey(0), items[0]["lr_imgs"][None], items[0]["pos_code"][None])["params"]
    return jax.tree.map(np.asarray, params)


def _spawn(world, *args, **kwargs):
    body = functools.partial(workers.train_steps, *args, **kwargs)
    return distributed.spawn(body, (), world=world) if world > 1 else body()


def _jax_refine_epoch(params, items, batch, mesh):
    loader = JaxDataloader(workers.ListDataset(items), batch_size=batch, shuffle=False)
    optimizer = JaxOptimizer("Adam", lr=1e-3)
    trainer = JaxTrainer(device="cpu", train_dataloader=loader, valid_dataloader=loader,
                         net=JaxRefineNet(**NET), loss_fns=[JL.L1Loss()], loss_weights=[1.0],
                         metric_fns=[JM.PSNR()], optimizer=optimizer, num_epochs=1, mesh=mesh,
                         telemetry=False)
    trainer.params = jax.tree.map(jnp.asarray, params)
    trainer.opt_state = optimizer.init(trainer.params)
    log, _, _ = trainer._run_epoch("training")
    return log, state_dict_from_jax_params(jax.tree.map(np.asarray, trainer.params))


def _assert_state_close(got, want, atol=1e-5, rtol=1e-5):
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(want[key], np.float64), atol=atol, rtol=rtol,
                                   err_msg=key)


def test_data_axis_refine_step_matches_single_device_and_jax_mesh(refine_params):
    """One Adam step of batch 4 over 2 gloo ranks (DDP, 2 items a rank)
    equals the port's single-device step and the JAX trainer's step on
    ``make_mesh(2)``: loss and parameters within 1e-5."""
    items = _refine_items(4)
    state = state_dict_from_jax_params(refine_params)
    single = _spawn(1, "refine", state, NET, items, 4, None)
    ranks = _spawn(2, "refine", state, NET, items, 4, 2)
    want_log, want_state = _jax_refine_epoch(refine_params, items, 4, jax_make_mesh(2))
    assert ranks["mesh"] == {"data": 2} and ranks["warned"] == []
    for got in (single, ranks):
        assert got["log"]["Loss"] == pytest.approx(want_log["Loss"], rel=1e-5)
        assert got["log"]["PSNR"] == pytest.approx(want_log["PSNR"], rel=1e-5)
        _assert_state_close({k: v for k, v in got["state"].items() if k in want_state},
                            {k: v for k, v in want_state.items() if k in got["state"]})
    _assert_state_close(ranks["state"], single["state"])


def test_indivisible_batch_is_replicated_with_the_warning(refine_params):
    """A global batch of 3 on 2 data ranks is computed whole on each rank,
    warned once, and equals the single-device step."""
    items = _refine_items(3, seed=2)
    state = state_dict_from_jax_params(refine_params)
    single = _spawn(1, "refine", state, NET, items, 3, None)
    ranks = _spawn(2, "refine", state, NET, items, 3, 2)
    assert ranks["warned"] == ["data"] and single["warned"] == []
    assert ranks["log"]["Loss"] == pytest.approx(single["log"]["Loss"], rel=1e-6)
    _assert_state_close(ranks["state"], single["state"], atol=1e-6, rtol=1e-6)


def test_data_axis_grad_accum_syncs_the_last_microbatch(refine_params):
    """``grad_accum_steps: 2`` over 2 ranks (``no_sync`` on the first
    microbatch) equals the single-device accumulated step (1e-5)."""
    items = _refine_items(8, seed=3)
    state = state_dict_from_jax_params(refine_params)
    single = _spawn(1, "refine", state, NET, items, 8, None, grad_accum_steps=2)
    ranks = _spawn(2, "refine", state, NET, items, 8, 2, grad_accum_steps=2)
    assert ranks["log"]["Loss"] == pytest.approx(single["log"]["Loss"], rel=1e-5)
    _assert_state_close(ranks["state"], single["state"])


def test_model_axis_bf16_step_matches_the_single_device_bf16_step(refine_params):
    """``compute_dtype: bfloat16`` under a (data 2, model 2) mesh: FSDP2
    gathers the bf16 weights and reduces fp32 gradients, as the single
    device's bf16 copies of fp32 masters do.  The forward is the same per
    item (loss within 1e-4 relative); each data rank's bf16 weight
    gradients round in other sums, so an Adam step (lr 1e-3) may move a
    parameter up to twice its lr apart (atol 2e-3).  oneDNN off, as the
    port's bf16 comparisons on the CPU run."""
    items = _refine_items(4, seed=8)
    state = state_dict_from_jax_params(refine_params)
    kwargs = dict(compute_dtype="bfloat16", onednn=False)
    single = _spawn(1, "refine", state, NET, items, 4, None, **kwargs)
    ranks = _spawn(4, "refine", state, NET, items, 4, 4, model_parallel=2, **kwargs)
    assert ranks["mesh"] == {"data": 2, "model": 2}
    assert ranks["log"]["Loss"] == pytest.approx(single["log"]["Loss"], rel=1e-4)
    _assert_state_close(ranks["state"], single["state"], atol=2e-3, rtol=0)
    moved = max(float((single["state"][k] - state[k]).abs().max()) for k in state)
    assert moved > 5e-4  # the step moved the weights by about its lr


def test_data_axis_batch_norm_reduces_over_the_global_batch():
    """DUF's BatchNorm3d under 2 ranks normalises over the global batch:
    one SGD step's loss, parameters (the gradients times the lr) and
    running statistics equal the single-device port step and the JAX
    trainer's step on one device (JAX ``tests/test_parallel.py:118`` holds
    its mesh to that)."""
    items = _duf_items(4)
    jax_net = JaxDUFNet(**DUF)
    variables = jax.jit(lambda x: jax_net.init(jax.random.PRNGKey(1), x, train=False))(
        items[0]["lr_imgs"][None])
    variables = jax.tree.map(np.asarray, dict(variables))
    state = state_dict_from_jax_params(variables, "DUFNet")
    sgd = ("SGD", {"lr": 1.0})  # the update is the gradient: compared at its tolerance
    single = _spawn(1, "duf", state, DUF, items, 4, None, optimizer=sgd)
    ranks = _spawn(2, "duf", state, DUF, items, 4, 2, optimizer=sgd)

    loader = JaxDataloader(workers.ListDataset(items), batch_size=4, shuffle=False)
    optimizer = JaxOptimizer("SGD", lr=1.0)
    jax_trainer = JaxMISRTrainer(device="cpu", train_dataloader=loader, valid_dataloader=loader,
                                 net=jax_net, loss_fns=[JL.MSELoss()], loss_weights=[1.0],
                                 metric_fns=[JM.PSNR()], optimizer=optimizer, num_epochs=1,
                                 telemetry=False)
    jax_trainer.params = jax.tree.map(jnp.asarray, variables["params"])
    jax_trainer.model_state = {"batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"])}
    jax_trainer.opt_state = optimizer.init(jax_trainer.params)
    want_log, _, _ = jax_trainer._run_epoch("training")
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, {
        "params": jax_trainer.params, **jax_trainer.model_state}), "DUFNet")

    stats = [k for k in want if "running_" in k]
    assert stats
    for got in (single, ranks):
        assert got["log"]["Loss"] == pytest.approx(want_log["Loss"], rel=1e-5)
        _assert_state_close({k: got["state"][k] for k in stats}, {k: want[k] for k in stats})
        params = [k for k in want if "running_" not in k and "num_batches" not in k]
        _assert_state_close({k: got["state"][k] for k in params}, {k: want[k] for k in params},
                            atol=5e-5, rtol=1e-4)
    _assert_state_close(ranks["state"], single["state"], atol=5e-5, rtol=1e-4)


# ------------------------------------------------------------- refusals
def test_multi_host_require_without_signal_raises(monkeypatch):
    """JAX ``tests/test_parallel.py:733``: an explicit ``multi_host`` with
    nothing to coordinate against fails; without the request, False."""
    for var in distributed._CLUSTER_ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    # (a test run earlier in this process may have made main's group of one)
    with monkeypatch.context() as m:
        m.setattr(torch.distributed, "is_initialized", lambda: False)
        with pytest.raises(ValueError, match="multi_host"):
            distributed.initialize(require=True)
        assert distributed.initialize() is False
        assert distributed.process_local_batch_slice(16) == (16, 0)  # one process
    cfg = Cfg({"main": {"saved_dir": "unused"}, "parallel": {"num_devices": 2, "multi_host": True},
               "trainer": {"name": "AcdcVSRRefineNetTrainer", "kwargs": {"device": "cpu"}}})
    with pytest.raises(ValueError, match="multi_host"):
        run(cfg)


def test_cuda_oversubscription_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    parallel.check_devices(1, "cuda:0")
    parallel.check_devices(8, "cpu")
    with pytest.raises(ValueError, match="only 1 device"):
        parallel.check_devices(2, "cuda:0")


@pytest.mark.parametrize("section", [{"num_devices": 2, "spatial_parallel": 2},
                                     {"num_devices": 1, "pad_h": True}])
@pytest.mark.parametrize("test", [False, True], ids=["train", "test"])
def test_spatial_axis_and_pad_h_name_item_10b(section, test):
    """Item 10b is ported: both sections pass ``main``'s checks for
    RefineNet (``tests/test_torch_spatial.py`` runs them) and for the rest
    of the zoo, EDSRNet and FRVSRNet among them
    (``tests/test_torch_spatial_zoo.py``, ``tests/test_torch_spatial_video.py``);
    the spatial axis with the model axis raises ``ValueError`` before any
    rank starts, while ``pad_h`` alone (a no-op without a spatial axis) is
    accepted for any net."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
        _check_parallel,
    )

    engine = "predictor" if test else "trainer"
    cfg = {"main": {"saved_dir": "unused"}, "parallel": section,
           "net": {"name": "RefineNet", "kwargs": {}},
           engine: {"name": "AcdcVSRRefineNet" + engine.capitalize(),
                    "kwargs": {"device": "cpu"}}}
    assert _check_parallel(Cfg(cfg), torch.device("cpu")) == section
    cfg["net"] = {"name": "EDSRNet", "kwargs": {}}
    assert _check_parallel(Cfg(cfg), torch.device("cpu")) == section
    cfg["net"] = {"name": "FRVSRNet", "kwargs": {}}
    assert _check_parallel(Cfg(cfg), torch.device("cpu")) == section
    if section.get("spatial_parallel", 1) > 1:
        cfg["parallel"] = {**section, "num_devices": 4, "model_parallel": 2}
        with pytest.raises(ValueError, match="cannot be combined"):
            run(Cfg(cfg), test)


def test_make_mesh_refusals(monkeypatch):
    """The JAX package's refusals: spatial with model, an indivisible
    device count; and no group."""
    with pytest.raises(ValueError, match="cannot be combined"):
        parallel.make_mesh(4, model_parallel=2, spatial_parallel=2)
    with pytest.raises(ValueError, match="not divisible by spatial_parallel=2"):
        parallel.check_axes(3, spatial_parallel=2)
    # (a test run earlier in this process may have made main's group of one)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="initialized"):
        parallel.make_mesh(1)
    assert parallel.batch_slice(4, None) == slice(None)


# ----------------------------------------------------------- checkpoints
def _trainer(tmp_path, backend, params, items):
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
        RefineNet,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.monitor import (
        Monitor,
    )

    net = RefineNet(**NET)
    net.load_state_dict(state_dict_from_jax_params(params), strict=True)
    loader = workers.Dataloader(workers.ListDataset(items), batch_size=2, shuffle=True)
    return workers.VSRRefineNetTrainer(
        device="cpu", train_dataloader=loader, valid_dataloader=loader, net=net,
        loss_fns=[workers.PL.L1Loss()], loss_weights=[1.0], metric_fns=[workers.PM.PSNR()],
        optimizer=workers.Optimizer("Adam", lr=1e-3, skip_nonfinite=2), num_epochs=2,
        monitor=Monitor(tmp_path, "min", "Loss", saved_freq=1), checkpoint_backend=backend,
        telemetry=False)


@pytest.mark.parametrize("backend", ["orbax", "orbax_async"])
def test_directory_checkpoints_round_trip_and_resume(tmp_path, refine_params, backend):
    """A directory checkpoint (``torch.distributed.checkpoint`` arrays +
    ``meta.pt``) resumes to the uninterrupted run bit for bit, its optimizer
    state and guard counters included."""
    items = _refine_items(4, seed=5)
    straight = _trainer(tmp_path / "a", backend, refine_params, items)
    straight.train()
    first = _trainer(tmp_path / "b", backend, refine_params, items)
    first.num_epochs = 1
    first.train()
    path = tmp_path / "b" / "model_1.pth"
    assert path.is_dir() and (path / "meta.pt").is_file() and (path / "arrays" / ".metadata").is_file()
    assert ckpt_io.find_latest_checkpoint(tmp_path / "b") == path
    resumed = _trainer(tmp_path / "b", backend, _perturbed(refine_params), items)
    resumed.load(path)
    assert resumed.epoch == 2
    assert resumed.opt.state_dict()["state"].keys() == first.opt.state_dict()["state"].keys()
    resumed.train()
    assert resumed.history["train"][0] == straight.history["train"][1]
    for (name, a), b in zip(straight.net.state_dict().items(), resumed.net.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)
    assert resumed.opt.nonfinite.tolist() == straight.opt.nonfinite.tolist() == [0, 0]


def _perturbed(params):
    return jax.tree.map(lambda x: x + 0.5, params)


def test_half_written_directory_is_skipped(tmp_path, refine_params):
    """A directory whose arrays never committed (meta only) is skipped by
    auto-resume and refused by the loader (JAX ``runner/checkpoint.py:250-290``)."""
    trainer = _trainer(tmp_path, "orbax", refine_params, _refine_items(2, seed=6))
    trainer.save(tmp_path / "model_1.pth")
    half = tmp_path / "model_3.pth"
    half.mkdir()
    torch.save({"epoch": 3}, half / "meta.pt")
    assert ckpt_io.find_latest_checkpoint(tmp_path) == tmp_path / "model_1.pth"
    with pytest.raises(FileNotFoundError, match="half-written"):
        ckpt_io.load_checkpoint(half)
    trainer.checkpoint_backend = "pickle"  # the same name as a file replaces the directory
    trainer.save(half)
    assert half.is_file() and ckpt_io.find_latest_checkpoint(tmp_path) == half


def test_unknown_checkpoint_backend_raises():
    with pytest.raises(ValueError, match="checkpoint_backend"):
        workers.VSRRefineNetTrainer(device="cpu", checkpoint_backend="zarr")


# ------------------------------------------------------------ predictor
def test_predictor_with_a_data_mesh_equals_the_meshless_run(tmp_path, refine_params):
    """Two ranks deal the sequences between them; the lead's Test log and
    CSV equal the meshless run's (1e-6 relative, the rows in the same order)."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
        RefineNet,
    )

    tree = make_acdc_tree(tmp_path / "acdc", patients_per_split=2, slices=2, frames=5,
                          hr_size=(24, 24), splits=("test",))
    net = RefineNet(**NET)
    net.load_state_dict(state_dict_from_jax_params(refine_params), strict=True)
    torch.save({"net": net.state_dict()}, tmp_path / "m.pth")

    def cfg(saved, section):
        out = {
            "main": {"saved_dir": str(saved), "loaded_path": str(tmp_path / "m.pth")},
            "dataset": {"name": "AcdcVSRRefineNetDataset", "kwargs": {
                "data_dir": str(tree["videos_dir"]), "downscale_factor": SCALE,
                "pos_code_path": str(tree["pos_code_path"]),
                "transforms": [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                               {"name": "ToTensor"}],
                "num_frames": 5, "num_updated_frames": U}},
            "dataloader": {"name": "Dataloader", "kwargs": {"batch_size": 1, "shuffle": False}},
            "net": {"name": "RefineNet", "kwargs": NET},
            "losses": [{"name": "L1Loss", "weight": 1.0}],
            "metrics": [{"name": "PSNR"}, {"name": "SSIM"}],
            "predictor": {"name": "AcdcVSRRefineNetPredictor",
                          "kwargs": {"device": "cpu", "saved_dir": str(saved), "exported": True}}}
        if section:
            out["parallel"] = section
        return Cfg(out)

    base = run(cfg(tmp_path / "one", None), test=True)
    split = run(cfg(tmp_path / "two", {"num_devices": 2}), test=True)
    assert split.mesh == {"data": 2}
    # a rank runs its convolutions on its share of the CPU threads, which
    # sums in another order: the last float32 bit may differ
    assert split.log.keys() == base.log.keys()
    for key in base.log:
        assert split.log[key] == pytest.approx(base.log[key], rel=1e-6), key
    rows = [list(csv.reader(open(tmp_path / d / "results.csv"))) for d in ("one", "two")]
    assert len(rows[0]) == len(rows[1]) == 1 + 4 * 5
    assert rows[0][0] == rows[1][0]
    for want, got in zip(rows[0][1:], rows[1][1:]):
        assert got[0] == want[0]
        np.testing.assert_allclose([float(v) for v in got[1:]], [float(v) for v in want[1:]],
                                   rtol=1e-6)
