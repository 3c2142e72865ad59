"""Train-from-scratch convergence: a family against Bicubic on the phantom.

The port's twin of the JAX package's ``tools/convergence_tpu.py``.  It
generates (or reuses) a learnable beating-heart phantom tree through the
port's offline pipeline (``tools/gen_synthetic_data``: 4 train and 2 test
patients, 2 slices, 16 frames, ×4), trains the repo's
``configs/train/<family>.yaml`` with only the path fields and
``num_epochs`` substituted, then evaluates on the held-out test split both
the trained net (``configs/test/<family>.yaml`` with the train YAML's net
kwargs overlaid, test-only keys kept) and Bicubic
(``configs/test/bicubic/exp1_x4.yaml``), each with its export on as
shipped (CSV, GIFs, PNGs under the run's ``saved_dir``).  Each PSNR is the
mean per-frame PSNR over all frames of the test patients.

Prints one JSON line: {"train_yaml", "train_wall_sec", "epochs", "size",
"grad_accum_steps", "monitor_best", "train_losses", "valid_losses",
"trained", "bicubic", "delta_psnr_db"}, the JAX tool's keys.

    python -m <torch pkg>.tools.convergence [refine_net/exp1_x4] [--epochs 40] \\
        [--size 144] [--workdir DIR] [--grad-accum N] [--device cpu] \\
        [--net-kwargs JSON] [--lr LR]

``--device`` defaults to the configs' own (``cuda:0``: the card).  A shared
``--workdir`` reuses its phantom tree across runs (the generation is
deterministic).  ``--grad-accum`` sets ``grad_accum_steps`` (the step is
the same); ``--net-kwargs`` (overlaid on the train YAML's net kwargs) and
``--lr`` change the experiment, for a small run on the CPU.
"""
from __future__ import annotations

import argparse
import json
import logging
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CONFIGS = REPO / "configs"
BICUBIC = CONFIGS / "test" / "bicubic" / "exp1_x4.yaml"


def patch_paths_only(cfg, tree: dict, out_dir: Path, loaded_path=None):
    """Substitute only the path-valued fields of a shipped config
    (``data_dir``, ``pos_code_path``, ``coordinates_path``, ``saved_dir``,
    ``loaded_path``); the port's copy of the JAX package's
    ``tools/_verbatim.patch_paths_only``."""
    cfg.main.saved_dir = str(out_dir)
    cfg.dataset.kwargs.data_dir = str(
        tree["imgs_dir"] if "imgs" in cfg.dataset.kwargs.data_dir else tree["videos_dir"]
    )
    if "pos_code_path" in cfg.dataset.kwargs:
        cfg.dataset.kwargs.pos_code_path = str(tree["pos_code_path"])
    for metric in cfg.get("metrics", []):
        if "coordinates_path" in metric.get("kwargs", {}):
            metric.kwargs.coordinates_path = str(tree["coordinates_path"])
    predictor = cfg.get("predictor")
    if predictor and "saved_dir" in predictor.get("kwargs", {}):
        cfg.predictor.kwargs.saved_dir = str(out_dir)
    if loaded_path is not None:
        cfg.main.loaded_path = str(loaded_path)
    return cfg


def phantom_tree(work: Path, size: int) -> dict:
    """Generate (or reuse: the generation is deterministic) the phantom
    tree under ``work``."""
    from . import gen_synthetic_data

    root = work / "phantom"
    pre, crop = root / "preprocessed", root / "cropped"
    if (pre / "position_code.pkl").exists():
        return {
            "raw_dir": root / "raw",
            "videos_dir": pre / "videos",
            "imgs_dir": pre / "imgs",
            "coordinates_path": crop / "coordinates.pkl",
            "pos_code_path": pre / "position_code.pkl",
        }
    return gen_synthetic_data.main(
        root, patients_train=4, patients_test=2,
        size=size, slices=2, frames=16, factors=(4,), seed=0,
    )


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("train_yaml", nargs="?", default="refine_net/exp1_x4",
                    help="train YAML under configs/train, e.g. edsr_net/exp1_x4")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--size", type=int, default=144,
                    help="HR size (a multiple of 12, >= 132 so the 32x32 LR crop fits at x4)")
    ap.add_argument("--workdir", default=None,
                    help="shared across runs: the phantom tree is reused")
    ap.add_argument("--grad-accum", type=int, default=0,
                    help="grad_accum_steps (0: the YAML's undivided batch)")
    ap.add_argument("--device", default=None, help="trainer and predictor device (e.g. cpu)")
    ap.add_argument("--net-kwargs", type=json.loads, default=None,
                    help="JSON overlaid on the train YAML's net kwargs (a smaller net)")
    ap.add_argument("--lr", type=float, default=None, help="the optimizer's learning rate")
    return ap


def run(argv=None, seed=None):
    """The run of :func:`main` without the print: (its JSON line as a
    dict, the trainer).  ``seed`` replaces the train YAML's
    ``main.random_seed`` (the net's initial weights and the data order;
    None keeps the YAML's)."""
    args = _parser().parse_args(argv)
    from ..config import load_config
    from ..main import test_from_config, train_from_config

    work = Path(args.workdir or tempfile.mkdtemp(prefix="evsr_convergence_"))
    tree = phantom_tree(work, args.size)
    family = args.train_yaml.replace("/", "_")

    cfg = patch_paths_only(load_config(CONFIGS / "train" / f"{args.train_yaml}.yaml"), tree,
                           work / f"train_{family}")
    cfg.trainer.kwargs.num_epochs = args.epochs
    if seed is not None:
        cfg.main.random_seed = seed
    if args.grad_accum:
        cfg.trainer.kwargs.grad_accum_steps = args.grad_accum
    if args.device:
        cfg.trainer.kwargs.device = args.device
    if args.net_kwargs:
        cfg.net.kwargs.update(args.net_kwargs)
    if args.lr is not None:
        cfg.optimizer.kwargs.lr = args.lr
    t0 = time.perf_counter()
    trainer = train_from_config(cfg)
    train_wall = time.perf_counter() - t0
    best = trainer.monitor.checkpoints_dir / "model_best.pth"

    def losses(split):
        return [round(e["Loss"], 6) for e in trainer.history[split] if "Loss" in e]

    logs = {}
    for name, yaml_path, loaded in (
        ("bicubic", BICUBIC, None),
        ("trained", CONFIGS / "test" / f"{args.train_yaml}.yaml", best),
    ):
        tcfg = patch_paths_only(load_config(yaml_path), tree, work / f"test_{family}_{name}",
                                loaded_path=loaded)
        if name == "trained":
            # evaluate the net that was trained: the train YAML's net kwargs
            # overlaid, test-only keys kept (duf's test YAML names another
            # dense layer, frvsr's adds is_prediction)
            tcfg.net.name = cfg.net.name
            for k, v in cfg.net.get("kwargs", {}).items():
                tcfg.net.kwargs[k] = v
        if args.device:
            tcfg.predictor.kwargs.device = args.device
        t0 = time.perf_counter()
        log = dict(test_from_config(tcfg).log)
        log["wall_sec"] = round(time.perf_counter() - t0, 1)
        logs[name] = {k: round(v, 4) for k, v in log.items()}

    out = {
        "train_yaml": args.train_yaml,
        "train_wall_sec": round(train_wall, 1),
        "epochs": args.epochs,
        "size": args.size,
        "grad_accum_steps": args.grad_accum or None,
        "monitor_best": float(trainer.monitor.best),
        "train_losses": losses("train"),
        "valid_losses": losses("valid"),
        "trained": logs["trained"],
        "bicubic": logs["bicubic"],
        "delta_psnr_db": round(logs["trained"]["PSNR"] - logs["bicubic"]["PSNR"], 3),
    }
    return out, trainer


def main(argv=None) -> dict:
    out, _ = run(argv)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(message)s", level=logging.INFO,
                        datefmt="%Y-%m-%d %H:%M:%S")
    main()
