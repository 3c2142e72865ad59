"""Full-volume multi-patient inference over the data ranks.

The port's counterpart of the JAX package's ``tools/batch_infer.py``, with
its CLI: the split's whole-sequence items are grouped by their LR NIfTI
header shape (:func:`group_by_shape`, nothing decoded), each group is
walked in chunks of one sequence per data rank (a spatial group of ranks
under ``--spatial-parallel``), and every rank runs the flagship RefineNet
forward on its sequence and scores its frames (PSNR and SSIM of the
denormalized frames) on the device.  Only the two score
vectors come back to the host, one item behind the launches
(``utils/dispatch.DoubleBuffer``).  Rank 0 gathers every rank's rows and
writes one CSV row a frame, in the JAX tool's order, and prints the
summary with frames/s.

On one device (the default, or ``--num-devices 1``) that is one sequence a
forward; ``--num-devices N`` spawns N ranks (``parallel/distributed.py``),
and under ``torchrun`` the process joins the launcher's group.
``--spatial-parallel S`` shards each sequence's height over S ranks
(``parallel/halo.py``; data-parallel width num_devices / S): each rank
feeds its LR rows, and the SR rows are gathered whole before they are
scored.  A height S does not divide is computed whole on each rank of the
group (warned once); ``--pad-h`` edge-extends it to the next multiple and
crops the SR output back instead.  ``--tile`` / ``--tile-overlap`` run the
net on fixed LR windows (``ops/tiling.py``) and exclude both;
``--aot-cache`` is accepted and logged.

    python -m <torch pkg>.tools.batch_infer CKPT DATA_DIR POS_CODE.pkl OUT.csv \\
        [--factor 4] [--split test] [--num-devices N] [--spatial-parallel S [--pad-h]] \\
        [--net-kwargs JSON] [--tile T --tile-overlap N] [--device cuda:0|cpu]

The device is the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import csv
import json
import logging
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import data as _data  # noqa: F401  (registry)
from ..config import DATASETS
from ..metrics import PSNR, SSIM
from ..models import RefineNet
from ..parallel import gather_rows, pad_height_to_multiple, spatial_step, take_rows
from ..runner.checkpoint import load_net_state_dict
from ..runner.common import accept_aot_cache
from ..utils.dispatch import DoubleBuffer, Fetch, upload
from ..utils.stats import denormalize

LOG = logging.getLogger(__name__)

NET_KWARGS = dict(
    in_channels=1,
    out_channels=1,
    num_features=[64, 64, 64],
    upscale_factor=4,
    num_stages=3,
    update_memory=True,
    num_updated_frames=6,
    refine_window_size=5,
    positional_encoding=True,
)


def group_by_shape(dataset):
    """{shape key: [indices]}: the items grouped by their LR NIfTI header
    shape (348 bytes read, nothing decoded), falling back to the decoded
    item's shape; the two key spaces are tagged apart (the JAX tool's)."""
    from ..utils import nifti

    groups = defaultdict(list)
    for idx in range(len(dataset)):
        lr_path = dataset.data[idx][0]
        try:
            key = ("header", *nifti.read_header(lr_path)["shape"])
        except Exception:
            key = ("item", *dataset[idx]["lr_imgs"].shape)  # decode fallback
        groups[key].append(idx)
    return groups


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Batched full-volume inference.")
    parser.add_argument("checkpoint", type=Path)
    parser.add_argument("data_dir", type=Path)
    parser.add_argument("pos_code_path", type=Path)
    parser.add_argument("out_csv", type=Path)
    parser.add_argument("--factor", type=int, default=4)
    parser.add_argument("--split", default="test")
    parser.add_argument("--num-devices", type=int, default=None)
    parser.add_argument("--spatial-parallel", type=int, default=1,
                        help="shard each volume's height axis over this many ranks (halo "
                             "exchange); data-parallel width becomes num_devices / this")
    parser.add_argument("--net-kwargs", type=json.loads, default=None)
    parser.add_argument("--pad-h", action="store_true",
                        help="edge-extend LR heights to the next multiple of spatial_parallel "
                             "so indivisible volumes still shard (SR output cropped back)")
    parser.add_argument("--aot-cache", default=None, metavar="DIR",
                        help="accepted and logged: the port compiles nothing per shape")
    parser.add_argument("--tile", type=int, default=None, metavar="T",
                        help="run the net forward on fixed TxT LR windows (ops/tiling.py)")
    parser.add_argument("--tile-overlap", type=int, default=None, metavar="N",
                        help="halo width in LR pixels (>= the net's receptive-field radius)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (each rank on its own card) or cpu")
    return parser


def main(argv=None):
    parser = _parser()
    args = parser.parse_args(argv)
    if args.tile is not None:
        if args.tile_overlap is None:
            parser.error("--tile requires --tile-overlap")
        if args.tile_overlap < 0 or args.tile <= 2 * args.tile_overlap:
            parser.error(f"--tile ({args.tile}) must exceed 2*--tile-overlap "
                         f"({2 * args.tile_overlap}) and the overlap must be >= 0")
        if args.spatial_parallel > 1 or args.pad_h:
            parser.error("--tile excludes --spatial-parallel/--pad-h (pick one spatial strategy)")
    from ..main import resolve_device
    from ..parallel import check_axes, check_devices
    from ..parallel.distributed import cluster_env_present, spawn

    device = resolve_device(args.device)
    n = args.num_devices or 1
    check_axes(n, args.spatial_parallel)
    if not dist.is_initialized():
        # a group already made checks its own (gloo ranks may share a card)
        check_devices(n, device)
    if n > 1 and not dist.is_initialized() and not cluster_env_present():
        summary = spawn(_infer, (args,), world=n, device=device)
    else:
        summary = _infer(args)
    if summary is not None:
        print(json.dumps(summary))
    return summary


def _infer(args) -> dict | None:
    """One rank's share of the split; rank 0 writes the CSV and returns the
    summary (the other ranks None)."""
    from ..parallel import distributed_initialize, make_mesh
    from ..parallel.distributed import local_device

    device = torch.device(args.device)
    mesh = None
    if dist.is_initialized() or distributed_initialize(device=device):
        mesh = make_mesh(args.num_devices, spatial_parallel=args.spatial_parallel, device=device)
    device = local_device(device)
    accept_aot_cache(args.aot_cache)
    n_dev = mesh.data if mesh is not None else 1
    rank = mesh.data_index if mesh is not None else 0
    lead = mesh is None or mesh.is_lead

    net_kwargs = args.net_kwargs or dict(NET_KWARGS, upscale_factor=args.factor)
    dataset = DATASETS.get("AcdcVSRRefineNetDataset")(
        data_dir=args.data_dir,
        type=args.split,
        downscale_factor=args.factor,
        transforms=[
            {"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
            {"name": "ToTensor"},
        ],
        pos_code_path=str(args.pos_code_path),
        num_frames=7,
        num_updated_frames=net_kwargs["num_updated_frames"],
    )
    net = RefineNet(**net_kwargs)
    net.load_state_dict(load_net_state_dict(args.checkpoint, "RefineNet"), strict=True)
    net.to(device).eval()
    psnr, ssim = PSNR(size_average=False), SSIM(size_average=False)

    def forward(lr, pos):
        return net(lr, pos)[-1]

    @torch.inference_mode()
    def scores(item) -> Fetch:
        lr = item["lr_imgs"][None]
        if args.pad_h and args.spatial_parallel > 1:
            lr = pad_height_to_multiple(lr, args.spatial_parallel)
        rows, axis = spatial_step(net, lr.shape, mesh)
        lr = upload(take_rows(lr, rows) if rows is not None else lr, device)
        pos = upload(item["pos_code"][None], device)
        hr = upload(item["hr_imgs"][None], device)
        if args.tile is None:
            # the SR rows gathered whole, cropped to the true height (pad_h)
            out = gather_rows(forward(lr, pos), axis)[..., :hr.shape[-3], :, :]
        else:
            from ..ops.tiling import tiled_apply

            out = tiled_apply(forward, (lr, pos), (args.tile, args.tile), args.tile_overlap)
        flat = lambda x: denormalize(x, "acdc").reshape((-1,) + x.shape[2:])  # noqa: E731
        return Fetch(psnr=psnr(flat(out), flat(hr)), ssim=ssim(flat(out), flat(hr)))

    rows: dict[int, list] = {}

    def emit(pending):
        """Fetch one launched sequence's scores (blocks on its event) and
        keep its rows."""
        idx, fetch = pending
        got = fetch.wait()
        name = dataset.data[idx][0].parts[-1].split(".")[0]
        rows[idx] = [[f"{name}_frame{t + 1:0>2d}", t, float(p), float(s)]
                     for t, (p, s) in enumerate(zip(got["psnr"], got["ssim"]))]

    groups = sorted(group_by_shape(dataset).items())
    pipe = DoubleBuffer(emit)
    t0 = time.perf_counter()
    for _, indices in groups:
        for start in range(0, len(indices), n_dev):
            chunk = indices[start:start + n_dev]
            if rank < len(chunk):
                fetch = scores(dataset[chunk[rank]])
                if mesh is None or mesh.spatial_index == 0:  # a group's rows, once
                    pipe.push((chunk[rank], fetch))
    pipe.drain()
    if mesh is not None:
        everyone = [None] * mesh.size if lead else None
        dist.gather_object(rows, everyone, dst=0, group=mesh.host_group)
        if lead:
            rows = {k: v for part in everyone for k, v in part.items()}
    elapsed = max(time.perf_counter() - t0, 1e-9)
    if not lead:
        return None
    table = [["name", "frame", "PSNR", "SSIM"]]
    for _, indices in groups:
        for idx in indices:
            table.extend(rows[idx])
    frames = len(table) - 1
    args.out_csv.parent.mkdir(parents=True, exist_ok=True)
    with open(args.out_csv, "w", newline="") as f:
        csv.writer(f).writerows(table)
    return {
        "devices": n_dev,
        "sequences": len(dataset),
        "frames": frames,
        "frames_per_sec": frames / elapsed,
        "mean_psnr": float(np.mean([r[2] for r in table[1:]])) if frames else None,
    }


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(message)s", level=logging.INFO)
    main()
