"""Where one full-width training step of the flagship spends its time on the card.

    python -m efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.profile_train \
        [--compute-dtype bfloat16] [--remat]

Builds the training path of ``configs/train/refine_net/exp1_x4.yaml`` at
full width (features [64, 64, 64], 3 stages, U = 6, window 5, phase code on;
batch 16 of 32×32 LR patches, 7 core + 2×6 warm-up frames; Adam at 1e-4;
fp32 with TF32 off) from a synthetic train split (2 patients × 2 slices × a
30-frame cycle at HR 256×256, written to a temporary directory), the port's
dataset with the config's augments, its prefetching loader (8 threads) and
its ``VSRRefineNetTrainer`` with seeded random weights, and prints:

* per step, after two warm-up steps: the wait for the next batch (host
  clock), then H2D copy + forward + loss, backward, optimizer update and
  metrics (CUDA events between them), and the step's wall time (host clock,
  synchronised);
* the loader alone: seconds per batch, with no model running;
* per top-level block of the forward (in-block, forward / backward
  ConvLSTM, refine block, out-block), the time between CUDA events recorded
  on entry and exit, summed over a step;
* over two steps of the trainer's own loop (loader and ``_train_step``, no
  extra synchronisation): the device's busy share and the top kernels by
  device time, from ``torch.profiler``, and the gate kernels' launches;
* the peak device memory of a step.

``--compute-dtype bfloat16`` and ``--remat`` run the step as the trainer's
``compute_dtype`` and the net's ``remat`` knobs do
(``configs/train/refine_net/exp1_x4_tpu.yaml``).  The last line is one JSON
object with these numbers.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

from ..data import Dataloader, VSRRefineNetDataset
from ..losses import L1Loss
from ..metrics import PSNR, SSIM
from ..models.refine_net import RefineNet
from ..ops import lstm_gates
from ..runner.optim import Optimizer
from ..runner.trainers import VSRRefineNetTrainer
from .profile_eval import BLOCKS, NAMED, NET_KWARGS, TOP, _block_timers
from .synthetic_tree import write_acdc_tree

BATCH, PATCH, CORE, U, SCALE = 16, 32, 7, 6, 4
WARMUP, TIMED, PROFILED = 2, 3, 2  # steps; the 120 items give 7 full batches
PHASES = ("forward", "backward", "optimizer", "metrics")


def _dataset(tree) -> VSRRefineNetDataset:
    """exp1_x4.yaml's train dataset on the synthetic tree."""
    return VSRRefineNetDataset(
        data_dir=tree["videos"], type="train", downscale_factor=SCALE,
        transforms=[{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                    {"name": "ToTensor"}],
        augments=[{"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
                  {"name": "RandomCropPatch", "kwargs": {"size": [PATCH, PATCH], "ratio": SCALE}}],
        num_frames=CORE, num_updated_frames=U, pos_code_path=str(tree["pos_code"]),
    )


def _timed_step(trainer, batch) -> dict:
    """``VSRRefineNetTrainer._train_step`` with CUDA events between its parts."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(PHASES) + 1)]
    ev[0].record()
    total, _, outputs, target, _ = trainer._forward(batch, True)
    ev[1].record()
    trainer.opt.zero_grad(set_to_none=True)
    total.backward()
    ev[2].record()
    trainer.optimizer.step(trainer.opt)
    ev[3].record()
    with torch.no_grad():
        trainer._compute_metrics(outputs, target)
    ev[4].record()
    torch.cuda.synchronize()
    return {name: ev[i].elapsed_time(ev[i + 1]) for i, name in enumerate(PHASES)}


def _parse_args():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--compute-dtype", default=None, help="e.g. bfloat16; default fp32")
    parser.add_argument("--remat", action="store_true", help="checkpoint the ConvLSTM core steps")
    return parser.parse_args()


def main() -> None:
    args = _parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)

    with tempfile.TemporaryDirectory(prefix="profile_train_") as tmp:
        tree = write_acdc_tree(Path(tmp), {"train": (2, 2)}, cycle=30, hr=256, scale=SCALE)
        loader = Dataloader(_dataset(tree), batch_size=BATCH, shuffle=True, num_workers=8)
        loader.set_epoch(1)
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in loader)  # also decodes every volume into the cache
        loader_s = (time.perf_counter() - t0) / n_batches
        t0 = time.perf_counter()
        batches = list(loader)
        loader_warm_s = (time.perf_counter() - t0) / len(batches)

        net = RefineNet(**NET_KWARGS, remat=args.remat, generator=torch.Generator().manual_seed(0))
        trainer = VSRRefineNetTrainer(
            device=dev, train_dataloader=loader, valid_dataloader=loader, net=net,
            loss_fns=[L1Loss()], loss_weights=[1.0], metric_fns=[PSNR(), SSIM()],
            optimizer=Optimizer("Adam", lr=1e-4, weight_decay=0), num_epochs=1,
            compute_dtype=args.compute_dtype,
        )
        net.train()

        steps = []
        it = iter(loader)
        for i in range(WARMUP + TIMED):
            t0 = time.perf_counter()
            batch = next(it)
            data_ms = (time.perf_counter() - t0) * 1e3
            if i == WARMUP + TIMED - 1:
                torch.cuda.reset_peak_memory_stats(dev)
            parts = _timed_step(trainer, batch)
            wall_ms = (time.perf_counter() - t0) * 1e3
            steps.append({"data": data_ms, **parts, "wall": wall_ms})
        peak = torch.cuda.max_memory_allocated(dev)
        del it

        events, handles = _block_timers(trainer.net)
        _timed_step(trainer, batches[0])
        for h in handles:
            h.remove()
        blocks_ms = {name: sum(a.elapsed_time(b) for a, b in events[name]) for name in BLOCKS}

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        fwd0, bwd0 = lstm_gates.LAUNCHES, lstm_gates.BWD_LAUNCHES
        it = iter(loader)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED):
                trainer._train_step(next(it))
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        del it
        launches = {"lstm_gates": (lstm_gates.LAUNCHES - fwd0) / PROFILED,
                    "lstm_gates_bwd": (lstm_gates.BWD_LAUNCHES - bwd0) / PROFILED}

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3  # us → ms
        by_name[e.name][1] += 1
    device_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    named = {part: sum(n for name, (_, n) in by_name.items() if part in name) for part in NAMED}

    timed = steps[WARMUP:]
    mean = {k: sum(s[k] for s in timed) / len(timed) for k in timed[0]}
    print(f"loader alone: {loader_s * 1e3:.1f} ms per batch cold, {loader_warm_s * 1e3:.1f} ms warm "
          f"({n_batches} batches of {BATCH})")
    for i, s in enumerate(steps):
        print(f"step {i}{' (warm-up)' if i < WARMUP else ''}: "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in s.items()), flush=True)
    print("mean of the timed steps: " + ", ".join(f"{k} {v:.1f} ms" for k, v in mean.items()))
    for name in BLOCKS:
        print(f"  forward {name:22s} {blocks_ms[name]:9.2f} ms (CUDA events, entry to exit)")
    print(f"profiled {PROFILED} steps of the trainer's loop: wall {prof_wall:.1f} ms, kernels "
          f"{device_ms:.1f} ms ({len(kernels)} launches), device busy {device_ms / prof_wall:.1%}; "
          f"gate launches per step {launches}")
    for name, (ms, n) in top:
        print(f"  {ms:9.2f} ms {n:6d}x  {name[:110]}")
    print(f"launches by name: {named}")
    print(f"peak device memory of a step: {peak / 2**30:.2f} GiB")
    print(json.dumps({
        "card": card, "batch": [BATCH, CORE + 2 * U, PATCH, PATCH, 1],
        "compute_dtype": args.compute_dtype or "float32", "remat": args.remat,
        "steps_ms": steps, "mean_ms": mean, "loader_ms_per_batch": [loader_s * 1e3, loader_warm_s * 1e3],
        "forward_blocks_ms": blocks_ms, "profiled_steps": PROFILED, "profiled_wall_ms": prof_wall,
        "kernel_ms": device_ms, "kernel_launches": len(kernels), "gate_launches_per_step": launches,
        "peak_gib": peak / 2**30,
        "top_kernels": [{"name": n, "ms": ms, "count": c} for n, (ms, c) in top],
        "launches_by_name": named,
    }), flush=True)


if __name__ == "__main__":
    main()
