"""A ``parallel:`` section through the port's ``main``: the ranks it spawns.

The cases of the JAX package's ``tests/test_parallel.py:276-287`` (``dp``,
``dp_tp``, ``dp_tp_accum``), each with a checkpoint round trip, the
flagship's ``exp1_x4_tpu.yaml`` as written (``num_devices: 8``), a
two-host run on this machine and ``torchrun``'s way in, all over gloo
ranks on the CPU.  The oracle is the port's own meshless run on the same
tree and seed, whose single-device steps ``tests/test_torch_parallel.py``
and ``tests/test_torch_train.py`` hold to the JAX package.  Tolerance: the
logged losses and metrics and the checkpointed parameters within 1e-5
relative (the JAX mesh test's).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import (
    Cfg,
    load_config,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import run
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel.distributed import (
    free_port,
)

sys.path.insert(0, str(Path(__file__).parent))
from fixtures import make_acdc_tree  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
NET = {"in_channels": 1, "out_channels": 1, "num_features": [4, 4], "upscale_factor": 4,
       "num_stages": 1, "update_memory": True, "num_updated_frames": 2,
       "refine_window_size": 5, "positional_encoding": True}


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


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # 24 train items (2 patients × 2 slices × 6 frames): 6 steps of 4, or
    # one batch of 16 and one of 8 for the tpu YAML; 24 valid clips
    return make_acdc_tree(tmp_path_factory.mktemp("parallel_main") / "acdc", patients_per_split=2,
                          slices=2, frames=6, hr_size=(32, 32), splits=("train", "valid"))


def _cfg(tree, saved, num_epochs, parallel=None, loaded_path=None, **trainer):
    out = {
        "main": {"random_seed": "vsr", "saved_dir": str(saved), "loaded_path": loaded_path},
        "dataset": {"name": "AcdcVSRRefineNetDataset", "kwargs": {
            "data_dir": str(tree["videos_dir"]), "downscale_factor": 4,
            "pos_code_path": str(tree["pos_code_path"]),
            "transforms": [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                           {"name": "ToTensor"}],
            "augments": [{"name": "RandomCropPatch", "kwargs": {"size": [8, 8], "ratio": 4}}],
            "num_frames": 3, "num_updated_frames": 2}},
        "dataloader": {"name": "Dataloader", "kwargs": {
            "train_batch_size": 4, "valid_batch_size": 1, "shuffle": True, "num_workers": 0,
            "drop_last": True}},
        "net": {"name": "RefineNet", "kwargs": NET},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [{"name": "PSNR"}],
        "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-3}},
        "logger": {"name": "AcdcVSRLogger", "kwargs": {"dummy_input": [4, 1, 8, 8]}},
        "monitor": {"name": "Monitor", "kwargs": {
            "mode": "min", "target": "Loss", "saved_freq": 1, "early_stop": 0}},
        "trainer": {"name": "AcdcVSRRefineNetTrainer",
                    "kwargs": {"device": "cpu", "num_epochs": num_epochs, **trainer}}}
    if parallel:
        out["parallel"] = parallel
    return Cfg(out)


@pytest.fixture(scope="module")
def meshless(tree, tmp_path_factory):
    """The port's two epochs on one device, without a ``parallel:`` section."""
    saved = tmp_path_factory.mktemp("meshless")
    trainer = run(_cfg(tree, saved, 2))
    return trainer.history, saved


def _close_logs(got, want):
    assert [list(g) for g in got] == [list(w) for w in want]
    for g, w in zip(got, want):
        for key in w:
            assert g[key] == pytest.approx(w[key], rel=1e-5), key


def _close_checkpoints(a, b):
    a = torch.load(a, map_location="cpu", weights_only=True)
    b = torch.load(b, map_location="cpu", weights_only=True)
    assert a["epoch"] == b["epoch"] and a["net"].keys() == b["net"].keys()
    for key in a["net"]:
        torch.testing.assert_close(a["net"][key], b["net"][key], atol=1e-5, rtol=1e-5, msg=key)
    a_state, b_state = a["optimizer"]["state"], b["optimizer"]["state"]
    # FSDP2 hands the dead parameter (quirk 3) a zero gradient: a zero state
    for index in a_state.keys() ^ b_state.keys():
        state = {**a_state, **b_state}[index]
        assert not state["exp_avg"].any() and not state["exp_avg_sq"].any()
    for index in a_state.keys() & b_state.keys():
        state = a_state[index]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(state[key], b_state[index][key],
                                       atol=1e-6, rtol=1e-4, msg=f"{index} {key}")


@pytest.mark.parametrize("parallel,trainer", [
    ({"num_devices": 2}, {}),
    ({"num_devices": 4, "model_parallel": 2}, {}),
    ({"num_devices": 4, "model_parallel": 2}, {"grad_accum_steps": 2}),
], ids=["dp", "dp_tp", "dp_tp_accum"])
def test_trainer_with_mesh_through_config(tree, meshless, tmp_path, parallel, trainer):
    """The first epoch under the mesh equals the meshless epoch; the lead alone
    writes one log and the checkpoint (gathered whole under the model
    axis, in the single-device layout); under a model axis, resuming it
    (FSDP2 loads the whole state back into its shards) gives the meshless
    second epoch."""
    history, saved_one = meshless
    # two epochs' seeds, stopped after the first (as a preempted run is)
    first = run(_cfg(tree, tmp_path / "run", 2, parallel, preempt_after_epochs=1, **trainer))
    want = {"data": parallel["num_devices"] // parallel.get("model_parallel", 1)}
    if parallel.get("model_parallel", 1) > 1:
        want["model"] = parallel["model_parallel"]
    assert first.mesh == want
    _close_logs(first.history["train"], history["train"][:1])
    _close_logs(first.history["valid"], history["valid"][:1])
    assert len(list((tmp_path / "run" / "log").glob("events*"))) == 1
    ckpt = tmp_path / "run" / "checkpoints" / "model_1.pth"
    _close_checkpoints(ckpt, saved_one / "checkpoints" / "model_1.pth")
    if "model_parallel" not in parallel:
        return  # the round trip is the model axis's, as in the JAX test
    second = run(_cfg(tree, tmp_path / "run", 2, parallel, loaded_path=str(ckpt), **trainer))
    assert second.epoch == 3 and len(second.history["train"]) == 1  # resumed at epoch 2
    _close_logs(second.history["train"], history["train"][1:])
    _close_checkpoints(tmp_path / "run" / "checkpoints" / "model_2.pth",
                       saved_one / "checkpoints" / "model_2.pth")


def test_the_tpu_train_yaml_as_written_spawns_eight_ranks(tree, tmp_path):
    """``configs/train/refine_net/exp1_x4_tpu.yaml`` with its
    ``parallel: {num_devices: 8}``, bf16, remat, ``int_feed`` and
    ``aot_cache``, the net shrunk and the data paths patched: 8 gloo ranks
    take 2 items each of a 16-item batch, then 1 each of an 8-item batch,
    and write one log."""
    cfg = load_config(REPO / "configs" / "train" / "refine_net" / "exp1_x4_tpu.yaml")
    assert cfg.parallel == {"num_devices": 8}
    kw = cfg.dataset.kwargs
    kw.update(data_dir=str(tree["videos_dir"]), pos_code_path=str(tree["pos_code_path"]),
              num_frames=3, num_updated_frames=2)
    for aug in kw.augments:
        if aug.name == "RandomCropPatch":
            aug.kwargs.size = [8, 8]
    cfg.net.kwargs.update(num_features=[4, 4], num_stages=2, num_updated_frames=2)
    cfg.main.saved_dir = str(tmp_path / "run")
    cfg.logger.kwargs.dummy_input = [8, 1, 8, 8]
    cfg.trainer.kwargs.update(device="cpu", num_epochs=1, aot_cache=str(tmp_path / "aot"))
    out = run(cfg)
    assert out.mesh == {"data": 8}
    logs = out.history["train"] + out.history["valid"]
    assert logs and all(np.isfinite(v) for log in logs for v in log.values())
    assert len(list((tmp_path / "run" / "log").glob("events*"))) == 1
    assert (tmp_path / "run" / "checkpoints" / "model_best.pth").is_file()
    assert not (tmp_path / "aot").exists()


_WORKER = """
import json, sys
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import Cfg
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import run
out = run(Cfg(json.loads(sys.argv[1])))
if out is not None:
    print("HISTORY", json.dumps(out.history))
"""


def _launch(cfgs, env=None):
    """The processes of ``cfgs`` side by side, each with its ``env``."""
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, json.dumps(cfg.to_dict())],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=REPO, env={**os.environ, **(e or {})})
             for cfg, e in zip(cfgs, env or [None] * len(cfgs))]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    return [json.loads(out.split("HISTORY", 1)[1]) for out, _ in outs if "HISTORY" in out]


def test_two_hosts_on_localhost_equal_the_meshless_run(tree, meshless, tmp_path):
    """``multi_host: true`` with a coordinator, 2 processes (hosts) of 1
    rank each: rank = process_id · 1 + 0; the run equals the meshless one
    and defaults to ``checkpoint_backend: orbax_async`` (directories)."""
    history, _ = meshless
    address = f"localhost:{free_port()}"
    cfgs = [_cfg(tree, tmp_path / "run", 1, {
        "num_devices": 2, "multi_host": True, "coordinator_address": address,
        "num_processes": 2, "process_id": pid}) for pid in (0, 1)]
    (got,) = _launch(cfgs)
    _close_logs(got["train"], history["train"][:1])
    ckpt = tmp_path / "run" / "checkpoints" / "model_1.pth"
    assert ckpt.is_dir() and (ckpt / "arrays" / ".metadata").is_file()


def test_a_launcher_group_is_joined(tree, meshless, tmp_path):
    """With ``WORLD_SIZE``/``RANK``/``MASTER_ADDR``/``MASTER_PORT`` set (what
    ``torchrun`` sets), each process joins that group as its rank."""
    history, _ = meshless
    port = str(free_port())
    cfg = _cfg(tree, tmp_path / "run", 1, {"num_devices": 2})
    envs = [{"WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r), "MASTER_ADDR": "localhost",
             "MASTER_PORT": port} for r in (0, 1)]
    outs = _launch([cfg, cfg], envs)
    assert len(outs) == 2  # every process ran its rank in place
    for got in outs:
        _close_logs(got["train"], history["train"][:1])
