"""Writes JAX package orbax checkpoints at published widths, for timing the
port's reader and resuming the flagship from one on the card.

    python tests/torch_orbax_full_width.py OUT

Run by hand on a machine with JAX and orbax (a CPU is enough); ``OUT``
should be a git-ignored directory of the checkout, so that the card's
machine gets it with a copy of the disk.  Each checkpoint is written by the
JAX package's own ``save_checkpoint(..., backend="orbax")``, its weights
from the port's seeded init through ``variables_from_torch_state_dict``,
as ``tests/test_torch_orbax.py``'s full-width test makes them:

* ``OUT/flagship/checkpoints/model_5.pth``: ``configs/train/refine_net/
  exp1_x4.yaml``'s RefineNet (2,890,993 parameters) with that YAML's Adam,
  its moments drawn from a numpy seed (``nu`` >= 0, so that the resumed
  steps stay finite) and its count 7: 34.7 MB of arrays;
* ``OUT/edvr/model_1.pth``: ``configs/train/edvr_net/exp1_x4.yaml``'s
  EDVRNet's parameters (20,630,369: 82.5 MB), without its Adam state;
* ``OUT/acdc``: ``tests/torch_orbax_common.py``'s synthetic tree at the
  flagship's HR 256 (LR 64, so that its 32-px LR crops fit), and
  ``OUT/flagship_train.yaml`` / ``OUT/flagship_test.yaml``: the flagship's
  YAMLs over it, on ``cuda:0``, the first resuming ``model_5`` for one epoch
  (``loaded_path: auto``), the second serving it (``exported: false``).

``python -m <port>.tools.profile_checkpoint`` times the reads.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from torch_orbax_common import TREE  # noqa: E402

FLAGSHIP_EPOCH = 5


def _moments(opt_state, seed: int):
    """``opt_state`` with Adam's ``mu`` drawn from ``seed``, ``nu`` its
    square-like non-negative draw, every count 7 and the learning rate kept."""
    import jax

    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if x.dtype.kind != "f":
            return np.full(x.shape, 7, x.dtype)
        if not x.ndim:
            return x
        draw = (rng.standard_normal(x.shape) * 1e-3).astype(x.dtype)
        return draw * draw if "nu" in jax.tree_util.keystr(path) else draw

    return jax.tree_util.tree_map_with_path(leaf, opt_state)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", type=Path, help="a git-ignored directory of the checkout")
    out = ap.parse_args().out.resolve()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.config import load_config
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.checkpoint import (
        save_checkpoint,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.optim import (
        build_optimizer,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.torch_import import (
        variables_from_torch_state_dict,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
        EDVRNet,
        RefineNet,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.synthetic_tree import (
        write_acdc_tree,
    )

    configs = REPO / "configs"
    train = load_config(configs / "train" / "refine_net" / "exp1_x4.yaml")
    net = RefineNet(**train.net.kwargs, generator=torch.Generator().manual_seed(0))
    params = variables_from_torch_state_dict("RefineNet", net.state_dict())["params"]
    opt_state = _moments(build_optimizer(train.optimizer).init(params), 1)
    monitor = {"mode": "min", "target": "Loss", "saved_freq": 10, "early_stop": float("inf"),
               "best": 0.125, "not_improved_count": 2}
    flagship = out / "flagship" / "checkpoints" / f"model_{FLAGSHIP_EPOCH}.pth"
    save_checkpoint(flagship, params=params, opt_state=opt_state, monitor_state=monitor,
                    epoch=FLAGSHIP_EPOCH, backend="orbax")

    edvr_cfg = load_config(configs / "train" / "edvr_net" / "exp1_x4.yaml")
    edvr = EDVRNet(**edvr_cfg.net.kwargs, generator=torch.Generator().manual_seed(0))
    edvr_params = variables_from_torch_state_dict("EDVRNet", edvr.state_dict())["params"]
    save_checkpoint(out / "edvr" / "model_1.pth", params=edvr_params, epoch=1, backend="orbax")

    splits = {k: tuple(v) for k, v in TREE["splits"].items()}
    tree = write_acdc_tree(out / "acdc", splits, cycle=TREE["cycle"], hr=256,
                           scale=TREE["scale"], seed=TREE["seed"])
    data = {"data_dir": str(tree["videos"]), "pos_code_path": str(tree["pos_code"])}
    train_cfg = json.loads(json.dumps(train))
    train_cfg["main"].update(saved_dir=str(out / "flagship"), loaded_path="auto")
    train_cfg["dataset"]["kwargs"].update(data)
    train_cfg["trainer"]["kwargs"].update(device="cuda:0", num_epochs=FLAGSHIP_EPOCH + 1)
    train_cfg.pop("logger", None)
    test_cfg = json.loads(json.dumps(load_config(configs / "test" / "refine_net" / "exp1_x4.yaml")))
    test_cfg["main"].update(saved_dir=str(out / "flagship_test"), loaded_path=str(flagship))
    test_cfg["dataset"]["kwargs"].update(data)
    for metric in test_cfg["metrics"]:
        if "coordinates_path" in metric.get("kwargs", {}):
            metric["kwargs"]["coordinates_path"] = str(tree["coordinates"])
    test_cfg["predictor"]["kwargs"].update(device="cuda:0", saved_dir=str(out / "flagship_test"),
                                           exported=False)
    (out / "flagship_train.yaml").write_text(json.dumps(train_cfg, indent=1) + "\n")
    (out / "flagship_test.yaml").write_text(json.dumps(test_cfg, indent=1) + "\n")
    for path in (flagship, out / "edvr" / "model_1.pth"):
        size = sum(p.stat().st_size for p in path.rglob("*") if p.is_file())
        print(f"wrote {path}: {size} bytes on disk")


if __name__ == "__main__":
    main()
