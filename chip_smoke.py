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
3. kernel vs plain: the ConvLSTM gate tail at the main path's shape, in
   fp32 and bf16, at an unaligned channels-last shape, and its gradient.
4. eval main path: a synthetic ACDC tree (test: 1 patient, 2 slices;
   train: 2 patients × 2 slices; valid: 1 patient × 1 slice; a 30-frame
   cycle, HR 256×256, LR 64×64) written with the port's NIfTI writer, a
   RefineNet with seeded random weights saved as ``{'net': state_dict}``,
   then ``main.test_from_config`` on ``cuda:0``; the kernel's launch count
   must be exactly 756 per clip and every metric finite.
5. whole forward: one clip through the net with the kernel and with the
   plain gate tail, and a small clip on the card against the CPU.
6. times: the kernel's and the plain version's time per launch (CUDA
   graphs of 100 launches over buffers larger than L2), beside the bound.
7. training main path: ``main.train_from_config`` on ``cuda:0`` for 2
   epochs of 8 steps (120 items at batch 16), one valid clip an epoch; the
   forward kernel launches exactly 342 per step + 756 per valid clip, the
   backward kernel 126 per step; every logged value finite; the monitor's
   checkpoints written and ``model_best.pth`` reloaded through the port's
   loader.
8. training step: one batch of the training shape, forward + the
   stage-discounted L1 + backward through the kernels and through the plain
   gate tail (autograd of the plain version): the loss and every gradient.
9. backward kernel vs plain at the training shape in fp32 and bf16 and at
   an unaligned channels-last shape; its time beside its bound and beside
   the forward's time at the training shape.

The second-to-last line is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``.  Needs only torch and numpy: no PyYAML,
no imageio, nothing of JAX.
"""
from __future__ import annotations

import json
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

TOL_FP32 = 2e-6  # expf/tanhf against ATen's: an ulp or two
TOL_BF16 = 1e-2  # one rounding to bf16 of values below 4, against the fp32 plain version
TOL_BF16_REL = 1e-2  # the backward's values reach ~5: error / max(1, |value|)
TOL_GRAD = 2e-6  # the backward kernel against autograd of the plain version
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


def bound_ms(nbytes: int, ops: int, mem_rate: float, fp32_peak: float) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or operations
    over the fp32 rate, whichever is larger, and which one it is."""
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, ops / fp32_peak * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


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
        set_gate_tail,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import lstm_gates
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
    gen = torch.Generator(device=dev).manual_seed(0)
    F_ = NET_KWARGS["num_features"][0]
    h_lr = HR // SCALE
    shape_g, shape_c = (1, 4 * F_, h_lr, h_lr), (1, F_, h_lr, h_lr)  # NCHW, M = 4096 rows
    errors = {}
    for dtype, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
        g = (torch.randn(shape_g, device=dev, generator=gen) * 2).to(dtype)
        c = (torch.randn(shape_c, device=dev, generator=gen) * 0.5).to(dtype)
        h_k, c_k = lstm_gates.fused_lstm_gates(g, c, dim=1)
        h_p, c_p = lstm_gates.lstm_gates_reference(g.float(), c.float(), dim=1)
        torch.cuda.synchronize()
        err = max((h_k.float() - h_p).abs().max().item(), (c_k.float() - c_p).abs().max().item())
        errors[str(dtype)] = err
        log("kernel", f"NCHW {shape_g} {dtype}: max abs err {err:.3e} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"gate kernel disagrees with its plain version in {dtype}: {err}")
    M = 3 * 11 * 7
    g = torch.randn(M, 4 * F_, device=dev, generator=gen) * 2
    c = torch.randn(M, F_, device=dev, generator=gen)
    h_k, c_k = lstm_gates.fused_lstm_gates(g, c)
    h_p, c_p = lstm_gates.lstm_gates_reference(g, c)
    err = max((h_k - h_p).abs().max().item(), (c_k - c_p).abs().max().item())
    log("kernel", f"channels-last ({M}, {4 * F_}) float32: max abs err {err:.3e} (tol {TOL_FP32})")
    if not err <= TOL_FP32:
        raise AssertionError(f"gate kernel disagrees on the unaligned channels-last shape: {err}")
    g1, c1 = (torch.randn(s, device=dev, generator=gen) for s in (shape_g, shape_c))
    dh, dc = (torch.randn(shape_c, device=dev, generator=gen) for _ in range(2))
    grads = []
    for fn in (lstm_gates.fused_lstm_gates, lstm_gates.lstm_gates_reference):
        gg, cc = g1.clone().requires_grad_(), c1.clone().requires_grad_()
        torch.autograd.backward(fn(gg, cc, dim=1), (dh, dc))
        grads.append((gg.grad, cc.grad))
    err = max((a - b).abs().max().item() for a, b in zip(*grads))
    log("kernel", f"gradient through the autograd.Function (backward kernel) vs plain autograd: "
                  f"max abs err {err:.3e} (tol {TOL_GRAD})")
    if not err <= TOL_GRAD:
        raise AssertionError(f"gate kernel gradient disagrees: {err}")

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
    lstm_gates.LAUNCHES = lstm_gates.BWD_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    predictor = port_main.test_from_config(cfg)
    wall = time.perf_counter() - t0
    launches = lstm_gates.LAUNCHES
    log("main", f"Test log: {predictor.log}")
    log("main", f"lstm_gates launches: {launches} (expected {LAUNCHES_PER_CLIP} x {SLICES} clips)")
    if launches != LAUNCHES_PER_CLIP * SLICES or lstm_gates.BWD_LAUNCHES:
        raise AssertionError(f"the eval path launched the gate kernel {launches} times and its "
                             f"backward {lstm_gates.BWD_LAUNCHES} times")
    if predictor.throughput["frames"] != CYCLE * SLICES:
        raise AssertionError(f"scored {predictor.throughput['frames']} frames")
    if not all(math.isfinite(v) for v in predictor.log.values()):
        raise AssertionError(f"non-finite metric in {predictor.log}")
    clip_s = predictor.item_seconds
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
    n_sets = 16  # 16 × 7.3 MB in fp32 > the 50 MB L2: each launch reads cold inputs
    sets = [((torch.randn(shape_g, device=dev, generator=gen) * 2),
             torch.randn(shape_c, device=dev, generator=gen)) for _ in range(n_sets)]
    kernel_calls = [lambda g=g, c=c: lstm_gates.fused_lstm_gates(g, c, dim=1)
                    for g, c in sets * (100 // n_sets + 1)][:100]
    plain_calls = [lambda g=g, c=c: lstm_gates.lstm_gates_reference(g, c, dim=1)
                   for g, c in sets * (100 // n_sets + 1)][:100]
    kernel_ms = time_graph_ms(kernel_calls)
    plain_ms = time_graph_ms(plain_calls)
    g0, c0 = sets[0]
    nbytes = (g0.numel() + 3 * c0.numel()) * g0.element_size()  # read gates, c; write h', c'
    ops = GATE_OPS_PER_ELEMENT * c0.numel()
    fwd_bound_ms, fwd_bound_by = bound_ms(nbytes, ops, mem_rate, fp32_peak)
    log("times", f"lstm_gates fp32 NCHW {shape_g}: kernel {kernel_ms * 1e3:.2f} us, plain "
                 f"{plain_ms * 1e3:.2f} us, bound {fwd_bound_ms * 1e3:.2f} us ({nbytes} bytes at "
                 f"{mem_rate / 1e12} TB/s; {ops} ops at {fp32_peak / 1e12} TFLOP/s); per clip "
                 f"{LAUNCHES_PER_CLIP} launches = {kernel_ms * LAUNCHES_PER_CLIP:.2f} ms")
    del sets, kernel_calls, plain_calls

    # ------------------------------------------------------ 7 train main path
    cfg = Cfg(train_config(tree, tmp / "train"))
    lstm_gates.LAUNCHES = lstm_gates.BWD_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = port_main.train_from_config(cfg)
    train_wall = time.perf_counter() - t0
    train_fwd, train_bwd = lstm_gates.LAUNCHES, lstm_gates.BWD_LAUNCHES
    train_peak = torch.cuda.max_memory_allocated(dev)
    steps = EPOCHS * STEPS_PER_EPOCH
    for epoch, (t_log, v_log) in enumerate(zip(trainer.history["train"], trainer.history["valid"]), 1):
        log("train", f"epoch {epoch}: Train log {t_log}; Valid log {v_log}")
    want_fwd = FWD_PER_STEP * steps + LAUNCHES_PER_CLIP * VALID_CLIPS * EPOCHS
    want_bwd = BWD_PER_STEP * steps
    log("train", f"lstm_gates launches {train_fwd} (expected {FWD_PER_STEP} x {steps} steps + "
                 f"{LAUNCHES_PER_CLIP} x {VALID_CLIPS * EPOCHS} valid clips = {want_fwd}); "
                 f"lstm_gates_bwd launches {train_bwd} (expected {BWD_PER_STEP} x {steps} = {want_bwd})")
    if (train_fwd, train_bwd) != (want_fwd, want_bwd):
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

    def step_grads():
        trainer.net.zero_grad(set_to_none=True)
        total, *_ = trainer._forward(batch, True)
        total.backward()
        return total.item(), {n: p.grad.clone() for n, p in trainer.net.named_parameters()
                              if p.grad is not None}

    bwd_before = lstm_gates.BWD_LAUNCHES
    loss_k, grads_k = step_grads()
    if lstm_gates.BWD_LAUNCHES - bwd_before != BWD_PER_STEP:
        raise AssertionError("the kernel step did not run the backward kernel 126 times")
    set_gate_tail(trainer.net, lstm_gates.lstm_gates_reference)
    loss_p, grads_p = step_grads()
    set_gate_tail(trainer.net, lstm_gates.fused_lstm_gates)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = {n: ((grads_k[n] - g).abs().max() / g.abs().max()).item() for n, g in grads_p.items()}
    worst = max(grad_rel, key=grad_rel.get)
    log("step", f"batch ({TRAIN_BATCH}, {T_TRAIN}, {PATCH}, {PATCH}, 1): loss {loss_k:.6f} vs "
                f"{loss_p:.6f} (rel {loss_rel:.2e}); {len(grads_p)} gradients, largest relative "
                f"difference {grad_rel[worst]:.2e} at {worst} (tol {TOL_TRAIN_STEP})")
    if grads_k.keys() != grads_p.keys() or not max(loss_rel, grad_rel[worst]) <= TOL_TRAIN_STEP:
        raise AssertionError("a training step through the kernels disagrees with the plain tail")
    del trainer, grads_k, grads_p

    # ---------------------------------------------- 9 backward kernel vs plain
    shape_tg = (TRAIN_BATCH, 4 * F_, PATCH, PATCH)  # NCHW, M = 16 384 rows
    shape_tc = (TRAIN_BATCH, F_, PATCH, PATCH)
    bwd_errors = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = (torch.randn(shape_tg, device=dev, generator=gen) * 2).to(dtype)
        c, dh, dc = ((torch.randn(shape_tc, device=dev, generator=gen) * s).to(dtype)
                     for s in (0.5, 1.0, 1.0))
        dg_k, dc_k = lstm_gates._launch_bwd(g, c, dh, dc, 1)
        dg_p, dc_p = lstm_gates.lstm_gates_backward_reference(g.float(), c.float(), dh.float(),
                                                              dc.float(), dim=1)
        torch.cuda.synchronize()
        err = max((dg_k.float() - dg_p).abs().max().item(), (dc_k.float() - dc_p).abs().max().item())
        rel = max(((k.float() - p).abs() / p.abs().clamp_min(1)).max().item()
                  for k, p in ((dg_k, dg_p), (dc_k, dc_p)))
        bwd_errors[str(dtype)] = err
        tol_ok = err <= TOL_FP32 if dtype == torch.float32 else rel <= TOL_BF16_REL
        log("bwd", f"NCHW {shape_tg} {dtype}: max abs err {err:.3e}, err / max(1, |value|) "
                   f"{rel:.3e} (tol {TOL_FP32} abs in fp32, {TOL_BF16_REL} relative in bf16)")
        if not tol_ok:
            raise AssertionError(f"backward kernel disagrees with its plain version in {dtype}")
    g = torch.randn(M, 4 * F_, device=dev, generator=gen) * 2
    c, dh, dc = (torch.randn(M, F_, device=dev, generator=gen) for _ in range(3))
    dg_k, dc_k = lstm_gates._launch_bwd(g, c, dh, dc, -1)
    dg_p, dc_p = lstm_gates.lstm_gates_backward_reference(g, c, dh, dc)
    err = max((dg_k - dg_p).abs().max().item(), (dc_k - dc_p).abs().max().item())
    log("bwd", f"channels-last ({M}, {4 * F_}) float32: max abs err {err:.3e} (tol {TOL_FP32})")
    if not err <= TOL_FP32:
        raise AssertionError(f"backward kernel disagrees on the unaligned channels-last shape: {err}")

    n_sets = 8  # 8 × 29.4 MB of inputs > the 50 MB L2
    sets = [tuple(torch.randn(s, device=dev, generator=gen) for s in (shape_tg, shape_tc,
                                                                      shape_tc, shape_tc))
            for _ in range(n_sets)]
    cycle_sets = (sets * (100 // n_sets + 1))[:100]
    bwd_kernel_ms = time_graph_ms([lambda a=a: lstm_gates._launch_bwd(*a, 1) for a in cycle_sets])
    bwd_plain_ms = time_graph_ms(
        [lambda a=a: lstm_gates.lstm_gates_backward_reference(*a, dim=1) for a in cycle_sets])
    fwd_train_ms = time_graph_ms([lambda a=a: lstm_gates.fused_lstm_gates(a[0], a[1], dim=1)
                                  for a in cycle_sets])
    fwd_train_plain_ms = time_graph_ms(
        [lambda a=a: lstm_gates.lstm_gates_reference(a[0], a[1], dim=1) for a in cycle_sets])
    g0, c0 = sets[0][:2]
    bwd_bytes = (2 * g0.numel() + 4 * c0.numel()) * g0.element_size()  # read 7F, write 5F
    bwd_bound_ms, bwd_bound_by = bound_ms(bwd_bytes, GATE_BWD_OPS_PER_ELEMENT * c0.numel(),
                                          mem_rate, fp32_peak)
    fwd_train_bound_ms, _ = bound_ms((g0.numel() + 3 * c0.numel()) * g0.element_size(),
                                     GATE_OPS_PER_ELEMENT * c0.numel(), mem_rate, fp32_peak)
    log("times", f"lstm_gates_bwd fp32 NCHW {shape_tg}: kernel {bwd_kernel_ms * 1e3:.2f} us, plain "
                 f"{bwd_plain_ms * 1e3:.2f} us, bound {bwd_bound_ms * 1e3:.2f} us ({bwd_bytes} bytes); "
                 f"forward at the same shape: kernel {fwd_train_ms * 1e3:.2f} us, plain "
                 f"{fwd_train_plain_ms * 1e3:.2f} us, bound {fwd_train_bound_ms * 1e3:.2f} us; per step "
                 f"{FWD_PER_STEP} + {BWD_PER_STEP} launches = "
                 f"{fwd_train_ms * FWD_PER_STEP + bwd_kernel_ms * BWD_PER_STEP:.2f} ms")
    tmp_dir.cleanup()

    replaces = "efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu/ops/pallas/lstm_gates.py"
    record = {"kernels": [{
        "name": "lstm_gates",
        "route": "cuda",
        "source": f"{PKG}/csrc/lstm_gates.cu",
        "replaces": f"{replaces}:31",
        "launches": launches + train_fwd,
        "launches_by_path": {"eval": launches, "train": train_fwd},
        "max_abs_err": errors[str(torch.float32)],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": fwd_bound_ms,
        "bound_by": fwd_bound_by,
        "library_ms": None,
        "shape": list(shape_g),
        "dtype": "float32",
        "ms_train_shape": fwd_train_ms,
        "plain_ms_train_shape": fwd_train_plain_ms,
        "bound_ms_train_shape": fwd_train_bound_ms,
    }, {
        "name": "lstm_gates_bwd",
        "route": "cuda",
        "source": f"{PKG}/csrc/lstm_gates.cu",
        "replaces": f"{replaces}:103",
        "launches": train_bwd,
        "launches_by_path": {"eval": 0, "train": train_bwd},
        "max_abs_err": bwd_errors[str(torch.float32)],
        "ms": bwd_kernel_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "library_ms": None,
        "shape": list(shape_tg),
        "dtype": "float32",
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
