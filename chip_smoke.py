#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's two main paths, the flagship RefineNet ×4 eval
(``configs/test/refine_net/exp1_x4.yaml``: features [64, 64, 64], 3 stages,
6 warm-up frames each side, window 5, phase code on) and its training
(``configs/train/refine_net/exp1_x4.yaml``: the same net, batch 16, LR
patches 32×32, 7 core frames + 2×6 warm-up, Adam at 1e-4), at full width
on the card, and holds every hand-written kernel of those paths against its
plain PyTorch version.  Phases, one or more lines each; any failure exits
non-zero and no result is printed:

1. device: ``nvidia-smi`` name and power limit, the torch device name;
   TF32 off for convolutions and matrix products.
2. build: every kernel of the path from ``csrc/`` with ``nvcc`` (sm_90a).
3. kernel vs plain: the ConvLSTM gate tail with the gate conv's bias at
   the main path's shape, in fp32 and bf16, in the layout the recurrence
   hands it (``recurrence_format``: fp32 NCHW, bf16 channels-last) and in
   the other; on rows of an unaligned count (16-byte path) and one element
   off an aligned allocation (scalar path); its gradient, d_bias included.
4. eval main path: a synthetic ACDC tree (test: 1 patient, 2 slices;
   train: 2 patients × 2 slices; valid: 1 patient × 1 slice; a 30-frame
   cycle, HR 256×256, LR 64×64) written with the port's NIfTI writer, a
   RefineNet with seeded random weights saved as ``{'net': state_dict}``,
   then ``main.test_from_config`` on ``cuda:0``; the kernel's launch count
   must be exactly 756 per clip and every metric finite.
5. whole forward: one clip through the net with the kernel and with the
   plain gate tail, and a small clip on the card against the CPU.
6. times: the kernel's, the plain version's and the PyTorch yardstick's
   (``aten::_thnn_fused_lstm_cell``) time per launch in the main path's
   layout with the bias (CUDA graphs of 100 launches over buffers larger
   than L2), beside the bound and a ``copy_`` of as many bytes.
7. training main path: ``main.train_from_config`` on ``cuda:0`` for 2
   epochs of 8 steps (120 items at batch 16), one valid clip an epoch; the
   forward kernel launches exactly 342 per step + 756 per valid clip, the
   backward kernel 126 per step; every logged value finite; the monitor's
   checkpoints written and ``model_best.pth`` reloaded through the port's
   loader.
8. training step: one batch of the training shape, forward + the
   stage-discounted L1 + backward through the kernels and through the plain
   gate tail (autograd of the plain version): the loss and every gradient.
9. forward and backward kernel vs plain at the training shape in fp32 and
   bf16 with the bias, in the main path's layout, the backward also on
   unaligned rows and on the scalar path; both kernels' times at the
   training shape as in phase 6, the backward's yardstick
   ``aten::_thnn_fused_lstm_cell_backward_impl``.
10. bf16 serving: phase 4's run with the predictor knobs of
    ``configs/test/refine_net/exp1_x4_tpu.yaml`` (``compute_dtype:
    bfloat16``, ``t_bucket: 8``, ``aot_cache``): exactly 792 bf16 gate
    launches a clip (the 30-frame cycle extended to 32, plus 2×6 warm-up),
    every metric finite, PSNR/SSIM within ~5x the measured gap of phase 4's
    fp32 run; clip latency and frames/s; the device's busy share in the
    predictor's step on a warm clip, with the launches of ATen's adds and
    cuDNN's NCHW↔NHWC transposes in its trace.
11. bf16 + remat training: phase 7's run with the knobs of
    ``configs/train/refine_net/exp1_x4_tpu.yaml`` (``remat``,
    ``compute_dtype: bfloat16``, ``int_feed``, ``aot_cache``, ``parallel:
    {num_devices: 1}``): exactly 468 bf16 forward launches a step (342 +
    the 126 core steps recomputed in the backward) + 756 a valid clip and
    126 bf16 backward launches a step; no "int_feed disabled" warning;
    every logged value finite; masters and Adam state fp32; ms a step,
    frames/s and peak memory beside phase 7's.  Then, as phase 8 in fp32,
    one bf16 + remat step through the kernels against the plain gate tail;
    one step with ``grad_accum_steps: 2`` against the same step with 1;
    the device's busy share in the trainer's step, with the same counts.
12. tiled serving: ``configs/test/refine_net/exp1_x4_dsb15_tile_tpu.yaml``'s
    knobs (``Dsb15VSRRefineNetDataset``, ``tile: 64``, ``tile_overlap: 12``,
    bf16) on a tree of LR 96×80 and 80×96 frames: the bf16 launch count of
    the window and seam-probe plan, the seam statistics, and tiled against
    untiled output on one clip in gray levels.

Phases 6 and 9 also time the kernels on bf16 operands, beside a bound at
2-byte elements.  The second-to-last line is the ``{"kernels": [...]}``
record; the last is ``{"ok": true, "device": {...}}``.  Needs only torch
and numpy: no PyYAML, no imageio, nothing of JAX.
"""
from __future__ import annotations

import json
import logging
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch"

# exp1_x4.yaml's serving shapes (the JAX package's bench protocol)
CYCLE, HR, SCALE, SLICES = 30, 256, 4, 2
NET_KWARGS = {  # configs/test/refine_net/exp1_x4.yaml:26-40
    "in_channels": 1, "out_channels": 1, "num_features": [64, 64, 64], "upscale_factor": 4,
    "num_stages": 3, "update_memory": True, "num_updated_frames": 6,
    "refine_window_size": 5, "positional_encoding": True,
}
U = NET_KWARGS["num_updated_frames"]
T_CLIP = CYCLE + 2 * U  # 42 frames a clip
LAYER_STEPS = len(NET_KWARGS["num_features"]) * 2 * NET_KWARGS["num_stages"]  # per frame
LAUNCHES_PER_CLIP = LAYER_STEPS * T_CLIP  # 756

# configs/train/refine_net/exp1_x4.yaml: batch 16, LR patches 32×32, 7 core frames
TRAIN_BATCH, PATCH, CORE = 16, 32, 7
T_TRAIN = CORE + 2 * U  # 19 frames an item
FWD_PER_STEP = LAYER_STEPS * T_TRAIN  # 342: every frame runs the gate tail
BWD_PER_STEP = LAYER_STEPS * CORE  # 126: the warm-up frames carry no gradient
TREE_SPLITS = {"test": (1, SLICES), "train": (2, 2), "valid": (1, 1)}  # (patients, slices)
EPOCHS = 2
STEPS_PER_EPOCH = math.ceil(2 * 2 * CYCLE / TRAIN_BATCH)  # 120 items → 8 steps
VALID_CLIPS = 1

# the _tpu configurations' knobs (configs/{test,train}/refine_net/exp1_x4_tpu.yaml)
T_BUCKET = 8
BUCKET_CLIP = -(-CYCLE // T_BUCKET) * T_BUCKET + 2 * U  # 32 core + 12 warm-up frames
BUCKET_LAUNCHES_PER_CLIP = LAYER_STEPS * BUCKET_CLIP  # 792
REMAT_FWD_PER_STEP = FWD_PER_STEP + BWD_PER_STEP  # 468: the core steps rerun in the backward
# configs/test/refine_net/exp1_x4_dsb15_tile_tpu.yaml on frames of two sizes
# (DSB15's frames differ by patient), each larger than the tile
TILE, TILE_OVERLAP = 64, 12
TILE_HR = [(384, 320), (320, 384)]  # LR 96×80 and 80×96; slice s takes TILE_HR[(s-1) % 2]
TILE_SLICES = 3  # the third repeats the first size: no seam probes for it
# bf16 + t_bucket serving against phase 4's fp32 run on the same clips: ~5x the
# gap measured on an H100 (PSNR -2.0e-4 dB, CardiacPSNR -1.9e-4 dB, SSIM
# +1.9e-5, CardiacSSIM +1.4e-5; the same in every run, the data and weights
# being seeded).  The SSIM of seeded random weights is ~0.02, so the JAX
# package's own bound (|dPSNR| < 0.5, |dSSIM| < 0.05) would pass a wrong path.
BF16_DPSNR, BF16_DSSIM = 1e-3, 1e-4
# one bf16 step as 2 microbatches of 8 against 1 of 16: the loss relative to
# itself, each gradient relative to its largest element (bf16 rounds each
# conv output to 8 bits, and the microbatches round differently)
TOL_ACCUM_LOSS, TOL_ACCUM_GRAD = 1e-2, 5e-2
# one bf16 + remat step through the kernels against the same step through the
# plain gate tail in bf16 (which rounds after every op; the kernel computes in
# fp32 and rounds once): the loss relative to itself, each gradient relative
# to its largest element; ~3x the gaps measured on an H100 (loss 5.97e-5,
# gradients 1.79e-2 at most, 6.9e-3 the median)
TOL_BF16_STEP_LOSS, TOL_BF16_STEP_GRAD = 2e-4, 5e-2

TOL_FP32 = 2e-6  # expf/tanhf against ATen's: an ulp or two
TOL_BF16 = 1e-2  # one rounding to bf16 of values below 4, against the fp32 plain version
TOL_BF16_REL = 1e-2  # the backward's values reach ~5: error / max(1, |value|)
TOL_GRAD = 2e-6  # the backward kernel against autograd of the plain version
# d_bias: the same reduction over N, H, W of the kernel's and of autograd's
# d_gates (4096 rows, each within TOL_GRAD), relative to its largest element
TOL_DBIAS_REL = 1e-5
TOL_FORWARD = 1e-4  # 42 recurrent steps × 3 stages in fp32
# one training step, kernels vs plain tail: the loss and each parameter's
# gradient, relative to that parameter's largest gradient (fp32 recurrences
# of 19 steps, 3 stages and their backward, each side rounding differently)
TOL_TRAIN_STEP = 1e-4

# Memory rate and fp32 (non-tensor-core) peak by part, from NVIDIA's H100
# data sheets (PCIe, NVL, SXM).
CARDS = [("PCIe", 2.0e12, 51e12), ("NVL", 3.9e12, 60e12), ("", 3.35e12, 67e12)]
GATE_OPS_PER_ELEMENT = 19  # 3 sigmoids (3 each) + 2 tanh (3 each) + 4 for c' and h'
# 3 sigmoids + 2 tanh (15), c' (3), dct (5), dgi, dgf, dgo, dgg (4 each), dc (1)
GATE_BWD_OPS_PER_ELEMENT = 40
# kernels counted by name in the traced warm clip and step (phases 10, 11):
# ATen's broadcast add (once the gate convs' bias add) and cuDNN's layout
# transposes around a conv whose operands are not in its NHWC layout
TRACE_COUNTS = {"aten_add": "CUDAFunctor_add", "nchw_to_nhwc": "nchwToNhwc",
                "nhwc_to_nchw": "nhwcToNchw"}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_graph_ms(fns) -> float:
    """Device time per call of ``fns`` (one call each, in order) replayed as
    one CUDA graph, so host launch cost is not in the time."""
    import torch

    for fn in fns[:4]:  # warm-up outside the capture
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def device_busy(fn, reps: int = 3) -> tuple[float, float, int, dict]:
    """(median host wall ms of ``fn()`` to the device's drain over ``reps``
    warm calls without a profiler; device ms of the kernels of one more call
    from a ``torch.profiler`` trace; their number; the launches of the
    kernels named in ``TRACE_COUNTS`` in that trace).  The kernels run on one
    stream, so their sum is the busy time; host tracing slows the host, not
    the kernels, so the wall is taken untraced."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler traced no device activity")
    counts = {key: sum(part in e.name for e in kernels) for key, part in TRACE_COUNTS.items()}
    return (sorted(walls)[reps // 2], sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            len(kernels), counts)


def gate_operands(shape_c, fmt, dtype, dev, gen):
    """Gate-conv output (no bias), c and the conv's bias for c of
    ``shape_c`` (N, F, H, W), in memory layout ``fmt``, as the recurrence
    hands them to the gate tail."""
    import torch

    N, F_, H, W = shape_c
    g = (torch.randn(N, 4 * F_, H, W, device=dev, generator=gen) * 2).to(dtype)
    c = (torch.randn(shape_c, device=dev, generator=gen) * 0.5).to(dtype)
    b = (torch.randn(4 * F_, device=dev, generator=gen) * 0.5).to(dtype)
    return g.contiguous(memory_format=fmt), c.contiguous(memory_format=fmt), b


def fmt_name(fmt) -> str:
    import torch

    return "channels-last" if fmt == torch.channels_last else "NCHW"


def library_time(calls, what: str):
    """(ms, None) for the PyTorch yardstick ``calls``, or (None, the error)
    where it refuses the operands."""
    try:
        return time_graph_ms(calls), None
    except Exception as exc:  # noqa: BLE001 - the yardstick is optional per dtype
        reason = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
        log("times", f"{what} refused: {reason}")
        return None, reason


def rel_diffs(grads_a: dict, grads_b: dict) -> dict:
    """Per parameter, the largest difference of two gradients relative to
    the largest element of the second."""
    return {n: ((grads_a[n] - g).abs().max() / g.abs().max()).item() for n, g in grads_b.items()}


def reset_launches(lstm_gates) -> None:
    lstm_gates.LAUNCHES = lstm_gates.BWD_LAUNCHES = 0
    lstm_gates.BF16_LAUNCHES = lstm_gates.BF16_BWD_LAUNCHES = 0


def launches(lstm_gates) -> tuple[int, int, int, int]:
    """(forward, backward, bf16 forward, bf16 backward) launches since the reset."""
    return (lstm_gates.LAUNCHES, lstm_gates.BWD_LAUNCHES, lstm_gates.BF16_LAUNCHES,
            lstm_gates.BF16_BWD_LAUNCHES)


class _Records(logging.Handler):
    """Keeps the log records of a run, to read its warnings."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def bound_ms(nbytes: int, ops: int, mem_rate: float, fp32_peak: float) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or operations
    over the fp32 rate, whichever is larger, and which one it is."""
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, ops / fp32_peak * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _cycled(sets, n: int = 100) -> list:
    return (sets * (n // len(sets) + 1))[:n]


def _n_sets(set_bytes: int) -> int:
    """Operand sets to cycle through so that every launch reads cold
    inputs: more than twice the 50 MB L2 in all."""
    return max(4, math.ceil(120e6 / set_bytes))


def time_gate_forward(lstm_gates, shape_c, fmt, dtype, dev, gen, rates) -> dict:
    """The forward kernel, its plain version and the PyTorch yardstick per
    launch on (gates, c, bias) of c's ``shape_c`` in layout ``fmt``, over
    operand sets larger than L2, beside the bound.  The yardstick,
    ``aten::_thnn_fused_lstm_cell`` (gate order i, f, g, o), computes the
    same tail with the bias add fused in on (M, 4F) rows; it also reads a
    hidden-gates operand and a hidden bias (zeros here) and writes a 4F
    workspace: 13F elements a row against the kernel's 7F."""
    import torch

    N, F_, H, W = shape_c
    M, el = N * H * W, torch.empty((), dtype=dtype).element_size()
    nbytes = (M * 7 * F_ + 4 * F_) * el  # read gates, c, bias; write h', c'
    sets = [gate_operands(shape_c, fmt, dtype, dev, gen) for _ in range(_n_sets(nbytes))]
    cyc = _cycled(sets)
    out = {"layout": fmt_name(fmt), "bytes": nbytes, "sets": len(sets)}
    out["ms"] = time_graph_ms([lambda a=a: lstm_gates.fused_lstm_gates(a[0], a[1], dim=1, bias=a[2])
                               for a in cyc])
    out["plain_ms"] = time_graph_ms(
        [lambda a=a: lstm_gates.lstm_gates_reference(a[0], a[1], dim=1, bias=a[2]) for a in cyc])
    del sets, cyc
    lib_sets = []
    for _ in range(_n_sets(M * 13 * F_ * el)):
        ig = torch.randn(M, 4 * F_, device=dev, generator=gen).to(dtype)
        cx = torch.randn(M, F_, device=dev, generator=gen).to(dtype)
        ib = torch.randn(4 * F_, device=dev, generator=gen).to(dtype)
        lib_sets.append((ig, torch.zeros_like(ig), cx, ib, torch.zeros_like(ib)))
    out["library_ms"], out["library_error"] = library_time(
        [lambda a=a: torch.ops.aten._thnn_fused_lstm_cell(*a) for a in _cycled(lib_sets)],
        f"aten::_thnn_fused_lstm_cell on {dtype} ({M}, {4 * F_})")
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, GATE_OPS_PER_ELEMENT * M * F_, *rates)
    # what one launch that only moves as many bytes costs at this size: a
    # copy_ of nbytes / 2 into another buffer, timed the same way
    n = nbytes // (2 * el)
    copies = [(torch.empty(n, device=dev, dtype=dtype), torch.randn(n, device=dev, generator=gen)
               .to(dtype)) for _ in range(_n_sets(nbytes))]
    out["copy_ms"] = time_graph_ms([lambda a=a: a[0].copy_(a[1]) for a in _cycled(copies)])
    return out


def time_gate_backward(lstm_gates, shape_c, fmt, dtype, dev, gen, rates) -> dict:
    """As :func:`time_gate_forward` for the backward kernel, beside
    ``aten::_thnn_fused_lstm_cell_backward_impl`` (reads dh', dc', c, c'
    and the forward's 4F workspace; writes d_gates, d_c and d_bias)."""
    import torch

    N, F_, H, W = shape_c
    M, el = N * H * W, torch.empty((), dtype=dtype).element_size()
    nbytes = (M * 12 * F_ + 4 * F_) * el  # read gates, c, dh, dc', bias; write dgates, dc
    sets = []
    for _ in range(_n_sets(nbytes)):
        g, c, b = gate_operands(shape_c, fmt, dtype, dev, gen)
        dh, dc = (torch.randn(shape_c, device=dev, generator=gen).to(dtype).contiguous(
            memory_format=fmt) for _ in range(2))
        sets.append((g, c, dh, dc, b))
    cyc = _cycled(sets)
    out = {"layout": fmt_name(fmt), "bytes": nbytes, "sets": len(sets)}
    out["ms"] = time_graph_ms([lambda a=a: lstm_gates._launch_bwd(*a[:4], 1, a[4]) for a in cyc])
    out["plain_ms"] = time_graph_ms(
        [lambda a=a: lstm_gates.lstm_gates_backward_reference(*a[:4], dim=1, bias=a[4])
         for a in cyc])
    del sets, cyc
    lib_sets, lib_error = [], None
    try:
        for _ in range(_n_sets(M * 12 * F_ * el)):
            ig = torch.randn(M, 4 * F_, device=dev, generator=gen).to(dtype)
            cx = torch.randn(M, F_, device=dev, generator=gen).to(dtype)
            ib = torch.randn(4 * F_, device=dev, generator=gen).to(dtype)
            _, cy, ws = torch.ops.aten._thnn_fused_lstm_cell(
                ig, torch.zeros_like(ig), cx, ib, torch.zeros_like(ib))
            dhy, dcy = (torch.randn(M, F_, device=dev, generator=gen).to(dtype) for _ in range(2))
            lib_sets.append((dhy, dcy, cx, cy, ws))
    except Exception as exc:  # noqa: BLE001 - the forward refused the dtype
        lib_error = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
        log("times", f"aten::_thnn_fused_lstm_cell on {dtype} refused: {lib_error}")
    if lib_error is None:
        out["library_ms"], out["library_error"] = library_time(
            [lambda a=a: torch.ops.aten._thnn_fused_lstm_cell_backward_impl(*a, True)
             for a in _cycled(lib_sets)],
            f"aten::_thnn_fused_lstm_cell_backward_impl on {dtype} ({M}, {4 * F_})")
    else:
        out["library_ms"], out["library_error"] = None, lib_error
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, GATE_BWD_OPS_PER_ELEMENT * M * F_, *rates)
    return out


def times_line(name: str, shape, dtype, t: dict) -> str:
    lib = (f"{t['library_ms'] * 1e3:.2f} us" if t["library_ms"] is not None
           else f"refused ({t['library_error']})")
    copy = (f"; a copy_ of as many bytes {t['copy_ms'] * 1e3:.2f} us" if "copy_ms" in t else "")
    return (f"{name} {dtype} {t['layout']} c {tuple(shape)} with bias: kernel {t['ms'] * 1e3:.2f} us, "
            f"plain {t['plain_ms'] * 1e3:.2f} us, library {lib}, bound {t['bound_ms'] * 1e3:.2f} us "
            f"({t['bound_by']}: {t['bytes']} bytes), {t['bound_ms'] / t['ms']:.0%} of the bound; "
            f"{t['sets']} operand sets{copy}")


def eval_config(tree: dict, ckpt: Path, saved_dir: Path) -> dict:
    """configs/test/refine_net/exp1_x4.yaml with paths into the synthetic
    tree, on cuda:0, without the GIF/PNG export."""
    coords = str(tree["coordinates"])
    return {
        "main": {"saved_dir": str(saved_dir), "loaded_path": str(ckpt)},
        "dataset": {
            "name": "AcdcVSRRefineNetDataset",
            "kwargs": {
                "data_dir": str(tree["videos"]), "downscale_factor": SCALE,
                "transforms": [
                    {"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                    {"name": "ToTensor"},
                ],
                "num_frames": 7, "num_updated_frames": U, "pos_code_path": str(tree["pos_code"]),
            },
        },
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"batch_size": 1, "shuffle": False, "num_workers": 8}},
        "net": {"name": "RefineNet", "kwargs": NET_KWARGS},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [
            {"name": "PSNR"}, {"name": "SSIM"},
            {"name": "CardiacPSNR", "kwargs": {"coordinates_path": coords}},
            {"name": "CardiacSSIM", "kwargs": {"coordinates_path": coords}},
        ],
        "predictor": {"name": "AcdcVSRRefineNetPredictor",
                      "kwargs": {"device": "cuda:0", "saved_dir": str(saved_dir), "exported": False}},
    }


def train_config(tree: dict, saved_dir: Path) -> dict:
    """configs/train/refine_net/exp1_x4.yaml with paths into the synthetic
    tree, on cuda:0, for EPOCHS epochs with a checkpoint every epoch, and
    without the ``logger:`` section (tensorboardX is not installed on the
    machine with the card)."""
    return {
        "main": {"random_seed": "vsr", "saved_dir": str(saved_dir), "loaded_path": None},
        "dataset": {
            "name": "AcdcVSRRefineNetDataset",
            "kwargs": {
                "data_dir": str(tree["videos"]), "downscale_factor": SCALE,
                "transforms": [
                    {"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                    {"name": "ToTensor"},
                ],
                "augments": [
                    {"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
                    {"name": "RandomCropPatch", "kwargs": {"size": [PATCH, PATCH], "ratio": SCALE}},
                ],
                "num_frames": CORE, "num_updated_frames": U, "pos_code_path": str(tree["pos_code"]),
            },
        },
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"train_batch_size": TRAIN_BATCH, "valid_batch_size": 1,
                                  "shuffle": True, "num_workers": 8}},
        "net": {"name": "RefineNet", "kwargs": NET_KWARGS},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [{"name": "PSNR"}, {"name": "SSIM"}],
        "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-4, "weight_decay": 0}},
        "monitor": {"name": "Monitor",
                    "kwargs": {"mode": "min", "target": "Loss", "saved_freq": 1, "early_stop": 0}},
        "trainer": {"name": "AcdcVSRRefineNetTrainer",
                    "kwargs": {"device": "cuda:0", "num_epochs": EPOCHS}},
    }


def main() -> int:
    if not (REPO / PKG / "csrc" / "lstm_gates.cu").is_file():
        print(f"chip_smoke.py: the {PKG} package is not beside this script", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(REPO))
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import main as port_main
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import Cfg
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models.refine_net import (
        RefineNet,
        recurrence_format,
        set_gate_tail,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import lstm_gates, tiling
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import common
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.checkpoint import (
        load_checkpoint,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.synthetic_tree import (
        write_acdc_tree,
    )

    # ---------------------------------------------------------------- 1 device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card_line = smi.splitlines()[0]
    print(card_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    log("device", f"torch: {kind}, {torch.cuda.device_count()} device(s), torch {torch.__version__}, "
                  f"CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, mem_rate, fp32_peak = next(c for c in CARDS if c[0] in kind)
    log("device", f"bound rates for this part: {mem_rate / 1e12} TB/s, {fp32_peak / 1e12} fp32 TFLOP/s")
    dev = torch.device("cuda:0")

    # ----------------------------------------------------------------- 2 build
    built = lstm_gates.build()
    log("build", f"lstm_gates.cu -> {built.path.name} in {built.seconds:.2f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())

    # ------------------------------------------------------- 3 kernel vs plain
    # the gate conv's raw output, c and its bias, in the layout the recurrence
    # hands the tail (recurrence_format) and in NCHW, against the fp32 plain
    # version on the same (upcast) inputs
    gen = torch.Generator(device=dev).manual_seed(0)
    F_ = NET_KWARGS["num_features"][0]
    h_lr = HR // SCALE
    shape_c = (1, F_, h_lr, h_lr)  # M = 4096 rows
    shape_g = (1, 4 * F_, h_lr, h_lr)
    errors = {}

    def check_fwd(g, c, b, dim, dtype, tol, what):
        width = lstm_gates.vector_width(g, c, dim=dim)
        h_k, c_k = lstm_gates.fused_lstm_gates(g, c, dim=dim, bias=b)
        h_p, c_p = lstm_gates.lstm_gates_reference(g.float(), c.float(), dim=dim, bias=b.float())
        torch.cuda.synchronize()
        err = max((h_k.float() - h_p).abs().max().item(), (c_k.float() - c_p).abs().max().item())
        log("kernel", f"{what} {dtype} with bias ({'16-byte vectors of ' + str(width) if width > 1 else 'scalar'}"
                      f" path): max abs err {err:.3e} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"gate kernel disagrees with its plain version: {what} {dtype}: {err}")
        return err

    for dtype, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
        fmt = recurrence_format(dtype)
        for layout in dict.fromkeys((fmt, torch.channels_last, torch.contiguous_format)):
            g, c, b = gate_operands(shape_c, layout, dtype, dev, gen)
            err = check_fwd(g, c, b, 1, dtype, tol, f"{fmt_name(layout)} {shape_g}")
            if layout == fmt:
                errors[str(dtype)] = err
    M = 3 * 11 * 7
    g = torch.randn(M, 4 * F_, device=dev, generator=gen) * 2
    c = torch.randn(M, F_, device=dev, generator=gen)
    b = torch.randn(4 * F_, device=dev, generator=gen) * 0.5
    check_fwd(g, c, b, -1, torch.float32, TOL_FP32, f"rows ({M}, {4 * F_})")
    for dtype, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
        # one element past an aligned allocation: the scalar path
        g1 = torch.randn(M * 4 * F_ + 1, device=dev, generator=gen).to(dtype)[1:].view(M, 4 * F_)
        c1 = torch.randn(M * F_ + 1, device=dev, generator=gen).to(dtype)[1:].view(M, F_)
        check_fwd(g1, c1, b.to(dtype), -1, dtype, tol, f"rows ({M}, {4 * F_}) offset by one element")
    g, c, b = gate_operands(shape_c, recurrence_format(torch.float32), torch.float32, dev, gen)
    dh, dc = (torch.randn(shape_c, device=dev, generator=gen) for _ in range(2))
    grads = []
    for fn in (lstm_gates.fused_lstm_gates, lstm_gates.lstm_gates_reference):
        leaves = [t.clone().requires_grad_() for t in (g, c, b)]
        torch.autograd.backward(fn(leaves[0], leaves[1], dim=1, bias=leaves[2]), (dh, dc))
        grads.append([t.grad for t in leaves])
    err = max((a - p).abs().max().item() for a, p in zip(grads[0][:2], grads[1][:2]))
    db_rel = ((grads[0][2] - grads[1][2]).abs().max() / grads[1][2].abs().max()).item()
    log("kernel", f"gradient through the autograd.Function (backward kernel) vs plain autograd, "
                  f"{fmt_name(recurrence_format(torch.float32))} with bias: d_gates, d_c max abs err "
                  f"{err:.3e} (tol {TOL_GRAD}); d_bias {db_rel:.3e} of its largest element (tol "
                  f"{TOL_DBIAS_REL})")
    if not (err <= TOL_GRAD and db_rel <= TOL_DBIAS_REL):
        raise AssertionError(f"gate kernel gradient disagrees: {err}, d_bias {db_rel}")

    # ---------------------------------------------------------- 4 eval main path
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = Path(tmp_dir.name)
    t0 = time.perf_counter()
    tree = write_acdc_tree(tmp / "acdc", TREE_SPLITS, cycle=CYCLE, hr=HR, scale=SCALE)
    log("main", f"synthetic tree {TREE_SPLITS} written in {time.perf_counter() - t0:.1f} s")
    net = RefineNet(**NET_KWARGS, generator=torch.Generator().manual_seed(0))
    ckpt = tmp / "model.pth"
    torch.save({"net": net.state_dict()}, ckpt)
    log("main", f"{CYCLE}-frame cycles, HR {HR}x{HR}, LR {h_lr}x{h_lr}; RefineNet "
                f"{sum(p.numel() for p in net.parameters()):,} params")
    # warm the CUDA context and cuDNN's algorithm choice on one clip first
    net.to(dev).eval()
    rng = np.random.default_rng(1)
    clip = torch.from_numpy(rng.standard_normal((1, T_CLIP, h_lr, h_lr, 1)).astype(np.float32)).to(dev)
    pos = torch.from_numpy(rng.uniform(-1, 1, (1, T_CLIP, 1)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        net(clip, pos)
    torch.cuda.synchronize()

    cfg = Cfg(eval_config(tree, ckpt, tmp / "test"))
    reset_launches(lstm_gates)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    predictor = port_main.test_from_config(cfg)
    wall = time.perf_counter() - t0
    eval_launches = launches(lstm_gates)
    n_eval = eval_launches[0]
    log("main", f"Test log: {predictor.log}")
    log("main", f"lstm_gates launches: {n_eval} (expected {LAUNCHES_PER_CLIP} x {SLICES} clips)")
    if eval_launches != (LAUNCHES_PER_CLIP * SLICES, 0, 0, 0):
        raise AssertionError(f"the eval path launched (forward, backward, bf16 forward, bf16 "
                             f"backward) {eval_launches}")
    if predictor.throughput["frames"] != CYCLE * SLICES:
        raise AssertionError(f"scored {predictor.throughput['frames']} frames")
    if not all(math.isfinite(v) for v in predictor.log.values()):
        raise AssertionError(f"non-finite metric in {predictor.log}")
    clip_s = predictor.item_seconds
    fp32_log = predictor.log
    log("main", f"frames/s {predictor.throughput['frames_per_sec']:.2f} over "
                f"{predictor.throughput['frames']} frames; per-clip latency "
                f"{', '.join(f'{s * 1e3:.1f}' for s in clip_s)} ms; test_from_config wall "
                f"{wall:.2f} s; peak device memory "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(json.dumps({"main_path": {"frames_per_sec": predictor.throughput["frames_per_sec"],
                                    "clip_ms": [s * 1e3 for s in clip_s], "wall_s": wall,
                                    "card": card_line}}), flush=True)

    # ---------------------------------------------------------- 5 whole forward
    with torch.inference_mode():
        out_kernel = net(clip, pos)
        fused_k = out_kernel[-1]
        set_gate_tail(net, lstm_gates.lstm_gates_reference)
        fused_p = net(clip, pos)[-1]
        set_gate_tail(net, lstm_gates.fused_lstm_gates)
    torch.cuda.synchronize()
    if tuple(fused_k.shape) != (1, CYCLE, HR, HR, 1) or len(out_kernel) != 9:
        raise AssertionError(f"unexpected output shape {tuple(fused_k.shape)}")
    if not torch.isfinite(fused_k).all():
        raise AssertionError("non-finite values in the fused output")
    err = (fused_k - fused_p).abs().max().item()
    log("forward", f"clip (1, {T_CLIP}, {h_lr}, {h_lr}, 1): final fused output, kernel vs plain gate "
                   f"tail: max abs diff {err:.3e} (tol {TOL_FORWARD}); |output| max "
                   f"{fused_k.abs().max().item():.3f}")
    if not err <= TOL_FORWARD:
        raise AssertionError(f"whole forward through the kernel disagrees: {err}")
    small = clip[:, :, :16, :16].contiguous()
    with torch.inference_mode():
        on_card = net(small, pos)[-1].cpu()
        on_cpu = net.to("cpu")(small.cpu(), pos.cpu())[-1]
    err = (on_card - on_cpu).abs().max().item()
    log("forward", f"clip (1, {T_CLIP}, 16, 16, 1): card vs CPU max abs diff {err:.3e} "
                   f"(tol {TOL_FORWARD})")
    if not err <= TOL_FORWARD:
        raise AssertionError(f"the card's forward disagrees with the CPU's: {err}")

    # ----------------------------------------------------------------- 6 times
    # per launch in the recurrence's layout with the bias, CUDA graphs of 100
    # launches over operand sets larger than L2
    rates = (mem_rate, fp32_peak)
    fwd_eval = {}
    for dtype, per_clip, clip_name in ((torch.float32, LAUNCHES_PER_CLIP, "clip"),
                                       (torch.bfloat16, BUCKET_LAUNCHES_PER_CLIP, "t_bucket clip")):
        t = time_gate_forward(lstm_gates, shape_c, recurrence_format(dtype), dtype, dev, gen, rates)
        fwd_eval[dtype] = t
        log("times", times_line("lstm_gates", shape_c, dtype, t) + f"; per {clip_name} {per_clip} "
                     f"launches = {t['ms'] * per_clip:.2f} ms")

    # ------------------------------------------------------ 7 train main path
    cfg = Cfg(train_config(tree, tmp / "train"))
    reset_launches(lstm_gates)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = port_main.train_from_config(cfg)
    train_wall = time.perf_counter() - t0
    train_fwd, train_bwd, train_fwd16, train_bwd16 = launches(lstm_gates)
    train_peak = torch.cuda.max_memory_allocated(dev)
    steps = EPOCHS * STEPS_PER_EPOCH
    for epoch, (t_log, v_log) in enumerate(zip(trainer.history["train"], trainer.history["valid"]), 1):
        log("train", f"epoch {epoch}: Train log {t_log}; Valid log {v_log}")
    want_fwd = FWD_PER_STEP * steps + LAUNCHES_PER_CLIP * VALID_CLIPS * EPOCHS
    want_bwd = BWD_PER_STEP * steps
    log("train", f"lstm_gates launches {train_fwd} (expected {FWD_PER_STEP} x {steps} steps + "
                 f"{LAUNCHES_PER_CLIP} x {VALID_CLIPS * EPOCHS} valid clips = {want_fwd}); "
                 f"lstm_gates_bwd launches {train_bwd} (expected {BWD_PER_STEP} x {steps} = {want_bwd})")
    if (train_fwd, train_bwd, train_fwd16, train_bwd16) != (want_fwd, want_bwd, 0, 0):
        raise AssertionError(f"the training path launched the gate kernels {train_fwd} / {train_bwd} times")
    if len(trainer.history["train"]) != EPOCHS or not all(
            math.isfinite(v) for h in trainer.history["train"] + trainer.history["valid"]
            for v in h.values()):
        raise AssertionError(f"training logs incomplete or non-finite: {trainer.history}")
    ckpts = tmp / "train" / "checkpoints"
    best = load_checkpoint(ckpts / "model_best.pth")
    reloaded = RefineNet(**NET_KWARGS)
    reloaded.load_state_dict(best["net"], strict=True)
    same_epoch = load_checkpoint(ckpts / f"model_{best['epoch']}.pth")["net"]
    final = load_checkpoint(ckpts / f"model_{EPOCHS}.pth")["net"]
    reloaded_sd = reloaded.state_dict()
    for name, value in trainer.net.state_dict().items():
        if not (torch.equal(reloaded_sd[name], same_epoch[name])
                and torch.equal(final[name], value.cpu())):
            raise AssertionError(f"checkpointed {name} differs from the trainer's")
    tp = trainer.throughput  # of the last epoch: every step warm
    step_ms = 1e3 / tp["train_steps_per_sec"]
    log("train", f"model_best.pth (epoch {best['epoch']}) and model_{EPOCHS}.pth reload equal to "
                 f"the trainer's weights")
    print(f"training: {tp['train_steps_per_sec']:.4f} steps/s, {tp['frames_per_sec']:.2f} frames/s, "
          f"{step_ms:.1f} ms per step after the first (epoch {EPOCHS}: {STEPS_PER_EPOCH} warm steps, "
          f"the last of {2 * 2 * CYCLE - (STEPS_PER_EPOCH - 1) * TRAIN_BATCH} items), peak device "
          f"memory {train_peak / 2**30:.2f} GiB, train_from_config wall {train_wall:.1f} s", flush=True)
    print(json.dumps({"train_path": {"steps_per_sec": tp["train_steps_per_sec"],
                                     "frames_per_sec": tp["frames_per_sec"], "step_ms": step_ms,
                                     "peak_gib": train_peak / 2**30, "wall_s": train_wall,
                                     "card": card_line}}), flush=True)

    # ------------------------------------------------ 8 training step vs plain
    rng = np.random.default_rng(2)
    batch = {
        "lr_imgs": rng.standard_normal((TRAIN_BATCH, T_TRAIN, PATCH, PATCH, 1)).astype(np.float32),
        "hr_imgs": rng.standard_normal(
            (TRAIN_BATCH, CORE, PATCH * SCALE, PATCH * SCALE, 1)).astype(np.float32),
        "pos_code": rng.uniform(-1, 1, (TRAIN_BATCH, T_TRAIN, 1)).astype(np.float32),
    }

    def step_grads(trainer):
        trainer.net.zero_grad(set_to_none=True)
        total, *_ = trainer._forward(batch, True)
        total.backward()
        return total.item(), {n: p.grad.clone() for n, p in trainer.net.named_parameters()
                              if p.grad is not None}

    bwd_before = lstm_gates.BWD_LAUNCHES
    loss_k, grads_k = step_grads(trainer)
    if lstm_gates.BWD_LAUNCHES - bwd_before != BWD_PER_STEP:
        raise AssertionError("the kernel step did not run the backward kernel 126 times")
    set_gate_tail(trainer.net, lstm_gates.lstm_gates_reference)
    loss_p, grads_p = step_grads(trainer)
    set_gate_tail(trainer.net, lstm_gates.fused_lstm_gates)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = rel_diffs(grads_k, grads_p)
    worst = max(grad_rel, key=grad_rel.get)
    log("step", f"batch ({TRAIN_BATCH}, {T_TRAIN}, {PATCH}, {PATCH}, 1): loss {loss_k:.6f} vs "
                f"{loss_p:.6f} (rel {loss_rel:.2e}); {len(grads_p)} gradients, largest relative "
                f"difference {grad_rel[worst]:.2e} at {worst} (tol {TOL_TRAIN_STEP})")
    if grads_k.keys() != grads_p.keys() or not max(loss_rel, grad_rel[worst]) <= TOL_TRAIN_STEP:
        raise AssertionError("a training step through the kernels disagrees with the plain tail")
    del trainer, grads_k, grads_p

    # ---------------------------------------------- 9 backward kernel vs plain
    shape_tc = (TRAIN_BATCH, F_, PATCH, PATCH)  # M = 16 384 rows
    shape_tg = (TRAIN_BATCH, 4 * F_, PATCH, PATCH)
    bwd_errors, fwd_train_errors = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        fmt = recurrence_format(dtype)
        g, c, b = gate_operands(shape_tc, fmt, dtype, dev, gen)
        dh, dc = (torch.randn(shape_tc, device=dev, generator=gen).to(dtype).contiguous(
            memory_format=fmt) for _ in range(2))
        tol = TOL_FP32 if dtype == torch.float32 else TOL_BF16
        fwd_train_errors[str(dtype)] = check_fwd(g, c, b, 1, dtype, tol,
                                                 f"{fmt_name(fmt)} {shape_tg}")
        width = lstm_gates.vector_width(g, c, dh, dc, dim=1)
        dg_k, dc_k = lstm_gates._launch_bwd(g, c, dh, dc, 1, b)
        dg_p, dc_p = lstm_gates.lstm_gates_backward_reference(
            g.float(), c.float(), dh.float(), dc.float(), dim=1, bias=b.float())
        torch.cuda.synchronize()
        err = max((dg_k.float() - dg_p).abs().max().item(), (dc_k.float() - dc_p).abs().max().item())
        rel = max(((k.float() - p).abs() / p.abs().clamp_min(1)).max().item()
                  for k, p in ((dg_k, dg_p), (dc_k, dc_p)))
        bwd_errors[str(dtype)] = err
        tol_ok = err <= TOL_FP32 if dtype == torch.float32 else rel <= TOL_BF16_REL
        log("bwd", f"{fmt_name(fmt)} {shape_tg} {dtype} with bias (vectors of {width}): max abs err "
                   f"{err:.3e}, err / max(1, |value|) {rel:.3e} (tol {TOL_FP32} abs in fp32, "
                   f"{TOL_BF16_REL} relative in bf16)")
        if not tol_ok:
            raise AssertionError(f"backward kernel disagrees with its plain version in {dtype}")
    g = torch.randn(M, 4 * F_, device=dev, generator=gen) * 2
    c, dh, dc = (torch.randn(M, F_, device=dev, generator=gen) for _ in range(3))
    b = torch.randn(4 * F_, device=dev, generator=gen) * 0.5
    for what, args in (("", (g, c, dh, dc)),  # and one element past aligned allocations:
                       (" offset by one element", tuple(
                           torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
                           for t in (g, c, dh, dc)))):
        width = lstm_gates.vector_width(*args)
        dg_k, dc_k = lstm_gates._launch_bwd(*args, -1, b)
        dg_p, dc_p = lstm_gates.lstm_gates_backward_reference(*args, bias=b)
        err = max((dg_k - dg_p).abs().max().item(), (dc_k - dc_p).abs().max().item())
        log("bwd", f"rows ({M}, {4 * F_}){what} float32 with bias (vectors of {width}): max abs "
                   f"err {err:.3e} (tol {TOL_FP32})")
        if not err <= TOL_FP32:
            raise AssertionError(f"backward kernel disagrees on rows ({M}, {4 * F_}){what}: {err}")

    fwd_train, bwd_train = {}, {}
    for dtype, fwd_per_step, step_name in ((torch.float32, FWD_PER_STEP, "step"),
                                           (torch.bfloat16, REMAT_FWD_PER_STEP, "bf16 + remat step")):
        fmt = recurrence_format(dtype)
        fwd_train[dtype] = t = time_gate_forward(lstm_gates, shape_tc, fmt, dtype, dev, gen, rates)
        log("times", times_line("lstm_gates", shape_tc, dtype, t))
        bwd_train[dtype] = tb = time_gate_backward(lstm_gates, shape_tc, fmt, dtype, dev, gen, rates)
        log("times", times_line("lstm_gates_bwd", shape_tc, dtype, tb) + f"; per {step_name} "
                     f"{fwd_per_step} + {BWD_PER_STEP} launches = "
                     f"{t['ms'] * fwd_per_step + tb['ms'] * BWD_PER_STEP:.2f} ms")

    # ------------------------------------------------------- 10 bf16 serving
    cfg = eval_config(tree, ckpt, tmp / "test_bf16")
    cfg["predictor"]["kwargs"].update(compute_dtype="bfloat16", t_bucket=T_BUCKET,
                                      aot_cache=str(tmp / "aot_cache"))
    reset_launches(lstm_gates)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pred16 = port_main.test_from_config(Cfg(cfg))
    wall16 = time.perf_counter() - t0
    eval16_launches = launches(lstm_gates)
    n_eval16 = eval16_launches[2]
    eval16_peak = torch.cuda.max_memory_allocated(dev)
    log("bf16 eval", f"Test log: {pred16.log}")
    log("bf16 eval", f"fp32 Test log (phase 4): {fp32_log}")
    want = BUCKET_LAUNCHES_PER_CLIP * SLICES
    log("bf16 eval", f"bf16 lstm_gates launches {n_eval16} (expected {BUCKET_LAUNCHES_PER_CLIP} x "
                     f"{SLICES} clips = {want}); all launches {eval16_launches}")
    if eval16_launches != (want, 0, want, 0):
        raise AssertionError(f"the bf16 eval path launched (forward, backward, bf16 forward, bf16 "
                             f"backward) {eval16_launches}")
    if pred16.throughput["frames"] != CYCLE * SLICES:
        raise AssertionError(f"scored {pred16.throughput['frames']} frames, not the true {CYCLE * SLICES}")
    if not all(math.isfinite(v) for v in pred16.log.values()):
        raise AssertionError(f"non-finite metric in {pred16.log}")
    gaps = {k: pred16.log[k] - fp32_log[k] for k in ("PSNR", "SSIM", "CardiacPSNR", "CardiacSSIM")}
    log("bf16 eval", f"bf16 - fp32: {gaps} (bound |dPSNR| < {BF16_DPSNR}, |dSSIM| < {BF16_DSSIM})")
    if not all(abs(v) < (BF16_DPSNR if "PSNR" in k else BF16_DSSIM) for k, v in gaps.items()):
        raise AssertionError(f"bf16 serving left the bf16 bound of the fp32 run: {gaps}")
    clip16_s = pred16.item_seconds
    log("bf16 eval", f"frames/s {pred16.throughput['frames_per_sec']:.2f} over "
                     f"{pred16.throughput['frames']} frames; per-clip latency "
                     f"{', '.join(f'{x * 1e3:.1f}' for x in clip16_s)} ms (fp32, phase 4: "
                     f"{', '.join(f'{x * 1e3:.1f}' for x in clip_s)} ms); test_from_config wall "
                     f"{wall16:.2f} s; peak device memory {eval16_peak / 2**30:.2f} GiB")
    # the device's busy share in the predictor's own step on a warm clip
    item16 = next(iter(pred16.test_dataloader))
    patient16 = pred16._item_meta(int(item16["index"][0]))[0]
    item16, _ = pred16._bucket_batch(item16)
    masks16 = pred16._metric_masks(patient16, np.shape(pred16._targets(item16))[-3:-1])
    eval16_busy = device_busy(lambda: pred16._step(item16, masks16))
    log("bf16 eval", f"predictor step on a warm {BUCKET_CLIP}-frame clip: wall {eval16_busy[0]:.2f} ms "
                     f"(median of 3, untraced), kernels {eval16_busy[1]:.2f} ms ({eval16_busy[2]} on "
                     f"the device, traced), device busy {eval16_busy[1] / eval16_busy[0]:.1%}; "
                     f"launches by name in the trace: {eval16_busy[3]}")
    print(json.dumps({"eval_bf16": {"frames_per_sec": pred16.throughput["frames_per_sec"],
                                    "clip_ms": [x * 1e3 for x in clip16_s], "wall_s": wall16,
                                    "peak_gib": eval16_peak / 2**30, "log": pred16.log,
                                    "fp32_log": fp32_log, "step_wall_ms": eval16_busy[0],
                                    "step_kernel_ms": eval16_busy[1],
                                    "step_kernels": eval16_busy[2],
                                    "step_kernels_by_name": eval16_busy[3], "card": card_line}}),
          flush=True)

    # ----------------------------------------------- 11 bf16 + remat training
    cfg = train_config(tree, tmp / "train_bf16")
    cfg["net"] = {"name": "RefineNet", "kwargs": {**NET_KWARGS, "remat": True}}
    cfg["trainer"]["kwargs"].update(compute_dtype="bfloat16", int_feed=True,
                                    aot_cache=str(tmp / "aot_cache"))
    cfg["parallel"] = {"num_devices": 1}
    records = _Records()
    logging.getLogger().addHandler(records)
    reset_launches(lstm_gates)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer16 = port_main.train_from_config(Cfg(cfg))
    train16_wall = time.perf_counter() - t0
    logging.getLogger().removeHandler(records)
    train16_launches = launches(lstm_gates)
    train16_peak = torch.cuda.max_memory_allocated(dev)
    for epoch, (t_log, v_log) in enumerate(zip(trainer16.history["train"],
                                               trainer16.history["valid"]), 1):
        log("bf16 train", f"epoch {epoch}: Train log {t_log}; Valid log {v_log}")
    want_fwd16 = REMAT_FWD_PER_STEP * steps + LAUNCHES_PER_CLIP * VALID_CLIPS * EPOCHS
    want_bwd16 = BWD_PER_STEP * steps
    log("bf16 train", f"bf16 lstm_gates launches {train16_launches[2]} (expected "
                      f"{REMAT_FWD_PER_STEP} x {steps} steps + {LAUNCHES_PER_CLIP} x "
                      f"{VALID_CLIPS * EPOCHS} valid clips = {want_fwd16}); bf16 lstm_gates_bwd "
                      f"launches {train16_launches[3]} (expected {BWD_PER_STEP} x {steps} = "
                      f"{want_bwd16}); all launches {train16_launches}")
    if train16_launches != (want_fwd16, want_bwd16, want_fwd16, want_bwd16):
        raise AssertionError(f"the bf16 + remat training path launched (forward, backward, bf16 "
                             f"forward, bf16 backward) {train16_launches}")
    warned = [r.getMessage() for r in records.records]
    log("bf16 train", f"warnings during the run: {warned}")
    if trainer16._feed_norm is None or any("int_feed disabled" in m for m in warned):
        raise AssertionError("int_feed did not engage")
    if len(trainer16.history["train"]) != EPOCHS or not all(
            math.isfinite(v) for h in trainer16.history["train"] + trainer16.history["valid"]
            for v in h.values()):
        raise AssertionError(f"bf16 training logs incomplete or non-finite: {trainer16.history}")
    state_dtypes = {p.dtype for p in trainer16.net.parameters()} | {
        v.dtype for st in trainer16.opt.state.values() for v in st.values()
        if torch.is_tensor(v) and v.is_floating_point()}
    log("bf16 train", f"dtypes of the master parameters and Adam's state: {sorted(map(str, state_dtypes))}")
    if state_dtypes != {torch.float32}:
        raise AssertionError(f"the masters or Adam's state left fp32: {state_dtypes}")
    tp16 = trainer16.throughput
    step16_ms = 1e3 / tp16["train_steps_per_sec"]
    print(f"bf16 + remat training: {tp16['train_steps_per_sec']:.4f} steps/s, "
          f"{tp16['frames_per_sec']:.2f} frames/s, {step16_ms:.1f} ms per step after the first "
          f"(fp32, phase 7: {step_ms:.1f} ms, {tp['frames_per_sec']:.2f} frames/s), peak device "
          f"memory {train16_peak / 2**30:.2f} GiB (fp32: {train_peak / 2**30:.2f} GiB), "
          f"train_from_config wall {train16_wall:.1f} s", flush=True)
    print(json.dumps({"train_bf16_remat": {
        "steps_per_sec": tp16["train_steps_per_sec"], "frames_per_sec": tp16["frames_per_sec"],
        "step_ms": step16_ms, "peak_gib": train16_peak / 2**30, "wall_s": train16_wall,
        "card": card_line}}), flush=True)

    # one bf16 + remat step through the kernels against the plain gate tail
    before = launches(lstm_gates)
    loss_k, grads_k = step_grads(trainer16)
    step16_launches = tuple(a - b for a, b in zip(launches(lstm_gates), before))
    if step16_launches[2:] != (REMAT_FWD_PER_STEP, BWD_PER_STEP):
        raise AssertionError(f"the bf16 + remat step launched {step16_launches}")
    set_gate_tail(trainer16.net, lstm_gates.lstm_gates_reference)
    loss_p, grads_p = step_grads(trainer16)
    set_gate_tail(trainer16.net, lstm_gates.fused_lstm_gates)
    step16_loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = rel_diffs(grads_k, grads_p)
    worst = max(grad_rel, key=grad_rel.get)
    step16_grad_rel = grad_rel[worst]
    log("bf16 train", f"bf16 + remat step, kernels vs plain tail on batch ({TRAIN_BATCH}, {T_TRAIN}, "
                      f"{PATCH}, {PATCH}, 1): {step16_launches[2]} + {step16_launches[3]} bf16 launches; "
                      f"loss {loss_k:.6f} vs {loss_p:.6f} (rel {step16_loss_rel:.2e}, tol "
                      f"{TOL_BF16_STEP_LOSS}); {len(grads_p)} gradients, largest relative difference "
                      f"{step16_grad_rel:.2e} at {worst} (tol {TOL_BF16_STEP_GRAD}); median "
                      f"{sorted(grad_rel.values())[len(grad_rel) // 2]:.2e}")
    if (grads_k.keys() != grads_p.keys() or step16_loss_rel > TOL_BF16_STEP_LOSS
            or step16_grad_rel > TOL_BF16_STEP_GRAD):
        raise AssertionError("a bf16 + remat step through the kernels disagrees with the plain tail")
    del grads_k, grads_p

    # one step as 2 microbatches against 1, the optimizer held still
    def accum_step(accum: int):
        trainer16.grad_accum_steps = accum
        total, _, _, display = trainer16._train_step(batch)
        return total.item(), {n: p.grad.clone() for n, p in trainer16.net.named_parameters()
                              if p.grad is not None}, tuple(display.shape)

    trainer16.optimizer.step = lambda opt: None
    (loss1, grads1, disp1), (loss2, grads2, disp2) = accum_step(1), accum_step(2)
    del trainer16.optimizer.step
    loss_rel = abs(loss2 - loss1) / abs(loss1)
    grad_rel = rel_diffs(grads2, grads1)
    worst = max(grad_rel, key=grad_rel.get)
    log("bf16 train", f"grad_accum_steps 2 vs 1 on batch ({TRAIN_BATCH}, {T_TRAIN}, {PATCH}, "
                      f"{PATCH}, 1): loss {loss2:.6f} vs {loss1:.6f} (rel {loss_rel:.2e}, tol "
                      f"{TOL_ACCUM_LOSS}); largest gradient difference relative to its maximum "
                      f"{grad_rel[worst]:.2e} at {worst} (tol {TOL_ACCUM_GRAD}); display {disp2}")
    if (grads1.keys() != grads2.keys() or disp1 != disp2 or loss_rel > TOL_ACCUM_LOSS
            or grad_rel[worst] > TOL_ACCUM_GRAD):
        raise AssertionError("grad_accum_steps 2 disagrees with the undivided step")
    del grads1, grads2
    # the device's busy share in the trainer's own step (optimizer included)
    trainer16.grad_accum_steps = 1
    train16_busy = device_busy(lambda: trainer16._train_step(batch))
    log("bf16 train", f"trainer step on batch ({TRAIN_BATCH}, {T_TRAIN}, {PATCH}, {PATCH}, 1): wall "
                      f"{train16_busy[0]:.2f} ms (median of 3, untraced), kernels "
                      f"{train16_busy[1]:.2f} ms ({train16_busy[2]} on the device, traced), device "
                      f"busy {train16_busy[1] / train16_busy[0]:.1%}; launches by name in the trace: "
                      f"{train16_busy[3]}")
    print(json.dumps({"train_bf16_remat_step": {
        "kernels_vs_plain_loss_rel": step16_loss_rel, "kernels_vs_plain_grad_rel": step16_grad_rel,
        "step_wall_ms": train16_busy[0], "step_kernel_ms": train16_busy[1],
        "step_kernels": train16_busy[2], "step_kernels_by_name": train16_busy[3],
        "card": card_line}}), flush=True)
    del trainer16

    # --------------------------------------------------------- 12 tiled serving
    tile_tree = write_acdc_tree(tmp / "dsb15", {"test": (1, TILE_SLICES)}, cycle=CYCLE,
                                hr=TILE_HR, scale=SCALE, seed=1)
    cfg = eval_config(tile_tree, ckpt, tmp / "tiled")
    cfg["dataset"]["name"] = "Dsb15VSRRefineNetDataset"
    cfg["predictor"]["kwargs"].update(tile=TILE, tile_overlap=TILE_OVERLAP, compute_dtype="bfloat16",
                                      aot_cache=str(tmp / "aot_cache"))
    want_tiled, shapes_seen, plans = 0, set(), []
    for s in range(TILE_SLICES):  # seam_stats "first": probes for the first clip of each (H, W)
        h, w = (v // SCALE for v in TILE_HR[s % len(TILE_HR)])
        plan_h, plan_w = (tiling.plan_1d(n, TILE, TILE_OVERLAP) for n in (h, w))
        probes = ([] if (h, w) in shapes_seen else
                  tiling.seam_probe_plan(plan_h, plan_w, (TILE, TILE), TILE_OVERLAP, h, w))
        shapes_seen.add((h, w))
        plans.append(f"LR {h}x{w}: {len(plan_h)}x{len(plan_w)} windows + {len(probes)} probes")
        want_tiled += (len(plan_h) * len(plan_w) + len(probes)) * LAUNCHES_PER_CLIP
    reset_launches(lstm_gates)
    t0 = time.perf_counter()
    pred_t = port_main.test_from_config(Cfg(cfg))
    wall_t = time.perf_counter() - t0
    tiled_launches = launches(lstm_gates)
    n_tiled = tiled_launches[2]
    log("tiled", f"plan per clip: {'; '.join(plans)}")
    log("tiled", f"bf16 lstm_gates launches {n_tiled} (expected {want_tiled}: the windows and "
                 f"probes x {LAUNCHES_PER_CLIP}); all launches {tiled_launches}")
    if tiled_launches != (want_tiled, 0, want_tiled, 0):
        raise AssertionError(f"the tiled path launched (forward, backward, bf16 forward, bf16 "
                             f"backward) {tiled_launches}")
    log("tiled", f"Test log: {pred_t.log}")
    log("tiled", f"seam stats (run max, gray levels): {pred_t.seam_summary}")
    if (pred_t.throughput["frames"] != CYCLE * TILE_SLICES or pred_t.seam_summary.get("items") != 2
            or not all(math.isfinite(v) for v in [*pred_t.log.values(),
                                                   pred_t.seam_summary["max_rms"],
                                                   pred_t.seam_summary["max_abs"]])):
        raise AssertionError(f"tiled serving: {pred_t.throughput}, {pred_t.seam_summary}, {pred_t.log}")
    log("tiled", f"frames/s {pred_t.throughput['frames_per_sec']:.2f}; per-clip latency "
                 f"{', '.join(f'{x * 1e3:.1f}' for x in pred_t.item_seconds)} ms; "
                 f"test_from_config wall {wall_t:.2f} s")
    item = pred_t.test_dataloader.dataset[0]
    lr_t = torch.from_numpy(item["lr_imgs"][None]).to(dev)
    pos_t = torch.from_numpy(item["pos_code"][None]).to(dev)
    with torch.inference_mode():
        whole = common.denorm_uint8(pred_t._forward(lr_t, pos_t), pred_t.mean, pred_t.std)
        tiled = common.denorm_uint8(
            tiling.tiled_apply(pred_t._forward, [lr_t, pos_t], (TILE, TILE), TILE_OVERLAP),
            pred_t.mean, pred_t.std)
        diff = (tiled - whole).abs()
        tile_gap = {"max": diff.max().item(), "mean": diff.mean().item(),
                    "share_over_1": (diff > 1).float().mean().item()}
    log("tiled", f"clip 1 (LR {tuple(lr_t.shape[2:4])}), tiled vs untiled output in gray levels: "
                 f"max {tile_gap['max']:.0f}, mean {tile_gap['mean']:.4f}, share of pixels more "
                 f"than 1 apart {tile_gap['share_over_1']:.4%}")
    if tuple(whole.shape) != (1, CYCLE, *TILE_HR[0], 1) or not math.isfinite(tile_gap["mean"]):
        raise AssertionError(f"tiled output {tuple(tiled.shape)} vs untiled {tuple(whole.shape)}")
    print(json.dumps({"eval_tiled": {"frames_per_sec": pred_t.throughput["frames_per_sec"],
                                     "clip_ms": [x * 1e3 for x in pred_t.item_seconds],
                                     "seam": pred_t.seam_summary, "tiled_vs_untiled": tile_gap,
                                     "log": pred_t.log, "card": card_line}}), flush=True)
    tmp_dir.cleanup()

    replaces = "efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu/ops/pallas/lstm_gates.py"
    fwd_paths = {"eval": n_eval, "train": train_fwd, "eval_bf16": n_eval16,
                 "train_bf16_remat": train16_launches[2], "eval_tiled": n_tiled}
    bwd_paths = {"eval": 0, "train": train_bwd, "eval_bf16": 0,
                 "train_bf16_remat": train16_launches[3], "eval_tiled": 0}
    f32, b16 = torch.float32, torch.bfloat16
    record = {"kernels": [{
        "name": "lstm_gates",
        "route": "cuda",
        "source": f"{PKG}/csrc/lstm_gates.cu",
        "replaces": f"{replaces}:31",
        "launches": sum(fwd_paths.values()),
        "launches_by_path": fwd_paths,
        "max_abs_err": errors[str(f32)],
        "max_abs_err_bf16": errors[str(b16)],
        "ms": fwd_eval[f32]["ms"],
        "plain_ms": fwd_eval[f32]["plain_ms"],
        "bound_ms": fwd_eval[f32]["bound_ms"],
        "bound_by": fwd_eval[f32]["bound_by"],
        "library_ms": fwd_eval[f32]["library_ms"],
        "library": "aten::_thnn_fused_lstm_cell",
        "library_error": fwd_eval[f32]["library_error"],
        "copy_ms": fwd_eval[f32]["copy_ms"],
        "copy_ms_bf16": fwd_eval[b16]["copy_ms"],
        "shape": list(shape_g),
        "dtype": "float32",
        "layout": fwd_eval[f32]["layout"],
        "layout_bf16": fwd_eval[b16]["layout"],
        "max_abs_err_train_shape": fwd_train_errors[str(f32)],
        "max_abs_err_bf16_train_shape": fwd_train_errors[str(b16)],
        "ms_train_shape": fwd_train[f32]["ms"],
        "plain_ms_train_shape": fwd_train[f32]["plain_ms"],
        "bound_ms_train_shape": fwd_train[f32]["bound_ms"],
        "library_ms_train_shape": fwd_train[f32]["library_ms"],
        "ms_bf16": fwd_eval[b16]["ms"],
        "plain_ms_bf16": fwd_eval[b16]["plain_ms"],
        "bound_ms_bf16": fwd_eval[b16]["bound_ms"],
        "library_ms_bf16": fwd_eval[b16]["library_ms"],
        "library_error_bf16": fwd_eval[b16]["library_error"],
        "ms_bf16_train_shape": fwd_train[b16]["ms"],
        "plain_ms_bf16_train_shape": fwd_train[b16]["plain_ms"],
        "bound_ms_bf16_train_shape": fwd_train[b16]["bound_ms"],
        "library_ms_bf16_train_shape": fwd_train[b16]["library_ms"],
    }, {
        "name": "lstm_gates_bwd",
        "route": "cuda",
        "source": f"{PKG}/csrc/lstm_gates.cu",
        "replaces": f"{replaces}:103",
        "launches": sum(bwd_paths.values()),
        "launches_by_path": bwd_paths,
        "max_abs_err": bwd_errors[str(f32)],
        "max_abs_err_bf16": bwd_errors[str(b16)],
        "ms": bwd_train[f32]["ms"],
        "plain_ms": bwd_train[f32]["plain_ms"],
        "bound_ms": bwd_train[f32]["bound_ms"],
        "bound_by": bwd_train[f32]["bound_by"],
        "library_ms": bwd_train[f32]["library_ms"],
        "library": "aten::_thnn_fused_lstm_cell_backward_impl",
        "library_error": bwd_train[f32]["library_error"],
        "shape": list(shape_tg),
        "dtype": "float32",
        "layout": bwd_train[f32]["layout"],
        "layout_bf16": bwd_train[b16]["layout"],
        "ms_bf16": bwd_train[b16]["ms"],
        "plain_ms_bf16": bwd_train[b16]["plain_ms"],
        "bound_ms_bf16": bwd_train[b16]["bound_ms"],
        "library_ms_bf16": bwd_train[b16]["library_ms"],
        "library_error_bf16": bwd_train[b16]["library_error"],
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
