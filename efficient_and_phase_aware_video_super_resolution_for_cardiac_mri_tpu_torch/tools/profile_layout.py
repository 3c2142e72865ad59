"""The ConvLSTM recurrence in NCHW against channels-last, on the card.

    python -m efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.profile_layout \
        [--compute-dtype bfloat16] [--rounds 2]

``models/refine_net.recurrence_format`` picks the memory layout of the
recurrence (frames, carries, gate-conv weights) by compute dtype.  This tool
measures what that choice costs: it runs the flagship RefineNet ×4
(``configs/test/refine_net/exp1_x4.yaml`` widths, seeded random weights, TF32
off) with the recurrence forced into each layout in turn, in the order
NCHW, channels-last, channels-last, NCHW (repeated ``--rounds`` times), and
prints for each run

* a warm eval clip (1, 42, 64, 64, 1) under ``torch.inference_mode()``;
* a warm training step of ``configs/train/refine_net/exp1_x4.yaml``'s shape
  (batch 16, 19 frames of 32×32 LR patches) through the trainer's own
  ``_train_step`` (forward, stage-discounted L1, backward, Adam);

each as the device time of its kernels from a ``torch.profiler`` trace (the
host's wall drifts from call to call, the device time does not), their
number, and the launches of cuDNN's NCHW↔NHWC transposes among them.  The
last line is one JSON object with every run.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..losses import L1Loss
from ..models import refine_net
from ..models.refine_net import RefineNet
from ..runner.optim import Optimizer
from ..runner.trainers import VSRRefineNetTrainer
from ..utils.casting import forward_in, resolve_dtype
from .profile_eval import CLIP, NET_KWARGS

TRAIN_BATCH = (16, 7 + 2 * 6, 32, 32, 1)  # batch 16, 7 core + 2×6 warm-up frames, LR 32×32
LAYOUTS = {"nchw": torch.contiguous_format, "channels_last": torch.channels_last}
TRANSPOSES = ("nchwToNhwc", "nhwcToNchw")


def _traced(fn) -> tuple[float, int, int]:
    """(device ms, kernels, cuDNN layout transposes) of one warm call."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler traced no device activity")
    return (sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(kernels),
            sum(any(t in e.name for t in TRANSPOSES) for e in kernels))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--compute-dtype", default=None, help="e.g. bfloat16; default fp32")
    parser.add_argument("--rounds", type=int, default=2, help="rounds of NCHW, CL, CL, NCHW")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_layout needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    dtype = resolve_dtype(args.compute_dtype)

    rng = np.random.default_rng(0)
    lr = torch.from_numpy(rng.standard_normal(CLIP).astype(np.float32)).to(dev)
    pos = torch.from_numpy(rng.uniform(-1, 1, (1, CLIP[1], 1)).astype(np.float32)).to(dev)
    batch = {
        "lr_imgs": rng.standard_normal(TRAIN_BATCH).astype(np.float32),
        "hr_imgs": rng.standard_normal((TRAIN_BATCH[0], 7, 128, 128, 1)).astype(np.float32),
        "pos_code": rng.uniform(-1, 1, (TRAIN_BATCH[0], TRAIN_BATCH[1], 1)).astype(np.float32),
    }
    net = RefineNet(**NET_KWARGS, generator=torch.Generator().manual_seed(0))
    trainer = VSRRefineNetTrainer(device=dev, net=net, loss_fns=[L1Loss()], num_epochs=1,
                                  optimizer=Optimizer("Adam", lr=1e-4, weight_decay=0),
                                  compute_dtype=args.compute_dtype)

    def eval_clip():
        with torch.inference_mode():
            forward_in(net.eval(), dtype, lr, pos)

    def train_step():
        net.train()
        trainer._train_step(batch)

    chosen = refine_net.recurrence_format
    runs = []
    try:
        for _ in range(args.rounds):
            for name in ("nchw", "channels_last", "channels_last", "nchw"):
                refine_net.recurrence_format = lambda _dtype, fmt=LAYOUTS[name]: fmt
                run = {"layout": name}
                for what, fn in (("eval_clip", eval_clip), ("train_step", train_step)):
                    ms, n, transposes = _traced(fn)
                    run[what] = {"kernel_ms": ms, "kernels": n, "transposes": transposes}
                runs.append(run)
                print(f"{name:14s} eval clip {run['eval_clip']['kernel_ms']:8.2f} ms "
                      f"({run['eval_clip']['kernels']} kernels, {run['eval_clip']['transposes']} "
                      f"transposes); train step {run['train_step']['kernel_ms']:8.2f} ms "
                      f"({run['train_step']['kernels']} kernels, "
                      f"{run['train_step']['transposes']} transposes)", flush=True)
    finally:
        refine_net.recurrence_format = chosen
    print(json.dumps({"card": card, "compute_dtype": str(dtype or torch.float32),
                      "chosen": {str(d): str(chosen(d)) for d in (torch.float32, torch.bfloat16)},
                      "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
