"""How long the port takes to read a checkpoint, on the host and onto the card.

    python -m efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.profile_checkpoint \
        CKPT[:NET] [CKPT[:NET] ...] [--repeats 3] [--device cuda:0]

For each checkpoint (a JAX package orbax directory, a JAX pickle or the
port's own ``.pth``) of a ``NET`` (``RefineNet`` unless named),
``--repeats`` times in this one process:

* of an orbax directory, ``runner/orbax_read.read_tree``: the OCDBT store,
  its zarr arrays and their zstd chunks, with the seconds spent inside
  ``libzstd``, the bytes on disk and the bytes of the arrays decoded;
* ``runner/checkpoint.load_checkpoint``: that read again and the
  conversion to the port's ``state_dict`` and optimizer reading;
* the ``net`` copied onto ``--device`` (synchronised).

``libzstd`` is loaded before the first repeat, which is the process's
first read of the files.  Files that a copy has just written are read from
the page cache: the reads are warm.  The card's name and power limit come
first, then one JSON line for each checkpoint.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..main import resolve_device
from ..runner import orbax_read
from ..runner.checkpoint import load_checkpoint
from ..utils import zstd


def _nbytes(tree) -> tuple[int, int]:
    """The arrays of a ``read_tree`` tree: their count and bytes."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        counts = [_nbytes(v) for v in tree]
        return sum(c for c, _ in counts), sum(b for _, b in counts)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return 1, tree.nbytes
    return 0, 0


def _timed_zstd() -> list[float]:
    """Wrap the zstd calls that ``orbax_read`` makes; the list collects
    the seconds of each."""
    spent: list[float] = []

    def wrap(fn):
        def timed(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                spent.append(time.perf_counter() - t0)
        return timed

    orbax_read.zstd = type("zstd", (), {"decompress": staticmethod(wrap(zstd.decompress)),
                                        "decompress_into": staticmethod(wrap(zstd.decompress_into))})
    return spent


def profile(path: Path, net: str, repeats: int, device: torch.device) -> dict:
    """The numbers of one checkpoint (see the module's docstring)."""
    orbax = path.is_dir() and (path / "meta.pkl").is_file()
    files = [p for p in path.rglob("*") if p.is_file()] if path.is_dir() else [path]
    out = {"checkpoint": str(path), "net": net, "orbax": orbax, "bytes_on_disk": sum(p.stat().st_size
                                                                        for p in files),
           "read_tree_s": [], "zstd_s": [], "zstd_calls": 0, "load_checkpoint_s": [],
           "to_device_s": []}
    for _ in range(repeats):
        if orbax:
            spent = _timed_zstd()
            try:
                t0 = time.perf_counter()
                tree = orbax_read.read_tree(path / "arrays")
                out["read_tree_s"].append(time.perf_counter() - t0)
            finally:
                orbax_read.zstd = zstd
            out["zstd_s"].append(sum(spent))
            out["zstd_calls"] = len(spent)
            out["arrays"], out["bytes_decoded"] = _nbytes(tree)
        t0 = time.perf_counter()
        ckpt = load_checkpoint(path, net)
        out["load_checkpoint_s"].append(time.perf_counter() - t0)
        out["epoch"] = ckpt.get("epoch")
        out["net_bytes"] = sum(v.nbytes for v in ckpt["net"].values())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        on_device = {k: v.to(device) for k, v in ckpt["net"].items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["to_device_s"].append(time.perf_counter() - t0)
        del on_device
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoints", nargs="+", help="CKPT or CKPT:NET")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip()
        print(card, flush=True)
        torch.zeros(1, device=device)  # the context, outside the timed copies
    print(f"libzstd {zstd.version()}", flush=True)
    for spec in args.checkpoints:
        path, _, net = spec.partition(":")
        print(json.dumps(profile(Path(path), net or "RefineNet", args.repeats, device)),
              flush=True)


if __name__ == "__main__":
    main()
