"""Writes ``tests/data/jax_orbax_2proc/``: a JAX package orbax checkpoint as a
run over two processes leaves it, and what the port must read of it.

    python tests/torch_orbax_fixture.py [--out tests/data/jax_orbax_2proc]

Run by hand on a machine with JAX and orbax (a CPU is enough).  Two
JAX CPU processes, coordinated through ``jax.distributed`` on a local port,
each run the JAX package's ``main.train_from_config`` for one epoch of a
narrow RefineNet (``NET``) with Adam over a two-device data-parallel mesh
on ``tools/synthetic_tree.py``'s seeded tree (``TREE``).  With more than
one process, ``main`` takes ``checkpoint_backend: orbax_async``, the
default of a pod run: each process writes its part of the OCDBT store
(``arrays/ocdbt.process_N/``) and the lead ``meta.pkl``.  Its
``checkpoints/model_1.pth/`` is copied to the output as ``model_1.pth/``.

Beside it, ``expected.json`` holds the epoch, each array's key path,
shape, dtype and sha256 (of its C-order bytes, as the JAX package's own
``load_checkpoint`` returns it), the tree's and the net's settings, the
train and test configs (``{videos}``, ``{pos_code}``, ``{coordinates}``,
``{saved_dir}``, ``{checkpoint}`` and ``{device}`` to be filled in) and
the JAX predictor's Test log of the checkpoint on that tree.
``tests/test_torch_orbax.py`` and phase 37 of ``chip_smoke.py`` read it.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
OUT = REPO / "tests" / "data" / "jax_orbax_2proc"

from torch_orbax_common import TREE, array_record, fill, leaves, write_tree  # noqa: E402

NET = {"in_channels": 1, "out_channels": 1, "num_features": [8, 8], "upscale_factor": 4,
       "num_stages": 1, "update_memory": True, "num_updated_frames": 2,
       "refine_window_size": 3, "positional_encoding": True}
DATASET = {
    "data_dir": "{videos}", "downscale_factor": 4,
    "transforms": [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                   {"name": "ToTensor"}],
    "num_frames": 3, "num_updated_frames": 2, "pos_code_path": "{pos_code}",
}
TRAIN_CONFIG = {
    "main": {"random_seed": "vsr", "saved_dir": "{saved_dir}", "loaded_path": "auto"},
    "dataset": {"name": "AcdcVSRRefineNetDataset", "kwargs": {
        **DATASET, "augments": [{"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
                                {"name": "RandomCropPatch",
                                 "kwargs": {"size": [8, 8], "ratio": 4}}]}},
    "dataloader": {"name": "Dataloader",
                   "kwargs": {"train_batch_size": 2, "valid_batch_size": 1, "shuffle": True,
                              "num_workers": 2}},
    "net": {"name": "RefineNet", "kwargs": NET},
    "losses": [{"name": "L1Loss", "weight": 1.0}],
    "metrics": [{"name": "PSNR"}, {"name": "SSIM"}],
    "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-3, "weight_decay": 0}},
    "logger": {"name": "AcdcVSRLogger", "kwargs": {"dummy_input": [2, 1, 8, 8]}},
    "monitor": {"name": "Monitor",
                "kwargs": {"mode": "min", "target": "Loss", "saved_freq": 1, "early_stop": 0}},
    "trainer": {"name": "AcdcVSRRefineNetTrainer",
                "kwargs": {"device": "{device}", "num_epochs": 2}},
}
TEST_CONFIG = {
    "main": {"saved_dir": "{saved_dir}", "loaded_path": "{checkpoint}"},
    "dataset": {"name": "AcdcVSRRefineNetDataset", "kwargs": DATASET},
    "dataloader": {"name": "Dataloader", "kwargs": {"batch_size": 1, "shuffle": False}},
    "net": {"name": "RefineNet", "kwargs": NET},
    "losses": [{"name": "L1Loss", "weight": 1.0}],
    "metrics": [{"name": "PSNR"}, {"name": "SSIM"},
                {"name": "CardiacPSNR", "kwargs": {"coordinates_path": "{coordinates}"}},
                {"name": "CardiacSSIM", "kwargs": {"coordinates_path": "{coordinates}"}}],
    "predictor": {"name": "AcdcVSRRefineNetPredictor",
                  "kwargs": {"device": "{device}", "saved_dir": "{saved_dir}",
                             "exported": False}},
}
EPOCHS_WRITTEN = 1


def _rank(rank: int, port: int, tree_json: str, saved_dir: str) -> None:
    """One of the two JAX processes: the JAX package's ``main`` for one epoch."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import main as jax_main
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.config import Cfg

    tree = json.loads(tree_json)
    cfg = fill(TRAIN_CONFIG, saved_dir=saved_dir, device="cpu", **tree)
    cfg["main"]["loaded_path"] = None
    cfg["trainer"]["kwargs"]["num_epochs"] = EPOCHS_WRITTEN
    cfg["parallel"] = {"multi_host": True, "coordinator_address": f"localhost:{port}",
                       "num_processes": 2, "process_id": rank}
    trainer = jax_main.train_from_config(Cfg(cfg))
    print(f"rank {rank}: checkpoint_backend {trainer.checkpoint_backend}, "
          f"history {trainer.history}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tree", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--saved-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        _rank(args.rank, args.port, args.tree, args.saved_dir)
        return

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tree = {k: str(v) for k, v in write_tree(tmp / "acdc").items()}
        tree = {"videos": tree["videos"], "pos_code": tree["pos_code"],
                "coordinates": tree["coordinates"]}
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
        env.pop("JAX_COMPILATION_CACHE_DIR", None)  # asymmetric cache hits stall gloo
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(rank), "--port",
                                   str(port), "--tree", json.dumps(tree), "--saved-dir",
                                   str(tmp / "run")], env=env)
                 for rank in range(2)]
        try:
            while all(p.poll() is None for p in procs):
                time.sleep(1)
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(codes):
            raise SystemExit(f"a JAX process failed: {codes}")

        import jax

        jax.config.update("jax_platforms", "cpu")
        from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import main as jax_main
        from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.config import Cfg
        from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.checkpoint import (
            load_checkpoint,
        )

        written = tmp / "run" / "checkpoints" / f"model_{EPOCHS_WRITTEN}.pth"
        if args.out.exists():
            shutil.rmtree(args.out)
        args.out.mkdir(parents=True)
        ckpt = args.out / written.name
        shutil.copytree(written, ckpt)
        payload = load_checkpoint(ckpt)
        arrays = {f"{part}/{path}": array_record(leaf) for part in ("net", "optimizer", "model_state")
                  for path, leaf in leaves(payload.get(part))}
        test_cfg = fill(TEST_CONFIG, saved_dir=tmp / "test", checkpoint=ckpt, device="cpu", **tree)
        predictor = jax_main.test_from_config(Cfg(test_cfg))
        expected = {
            "made_by": "tests/torch_orbax_fixture.py",
            "checkpoint": written.name, "epoch": payload["epoch"],
            "processes": sorted(p.name for p in (ckpt / "arrays").glob("ocdbt.process_*")),
            "tree": TREE, "net": NET, "train_config": TRAIN_CONFIG, "test_config": TEST_CONFIG,
            "test_log": {k: float(v) for k, v in predictor.log.items()},
            "arrays": arrays,
        }
        (args.out / "expected.json").write_text(json.dumps(expected, indent=1) + "\n")
        size = sum(p.stat().st_size for p in args.out.rglob("*") if p.is_file())
        print(f"wrote {args.out}: {len(arrays)} arrays, {size} bytes; Test log "
              f"{expected['test_log']}")


if __name__ == "__main__":
    main()
