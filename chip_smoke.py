#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path, the flagship RefineNet ×4 eval
(``configs/test/refine_net/exp1_x4.yaml``: features [64, 64, 64], 3 stages,
6 warm-up frames each side, window 5, phase code on), at full width on the
card, and holds every hand-written kernel of that path against its plain
PyTorch version.  Phases, one or more lines each; any failure exits
non-zero and no result is printed:

1. device: ``nvidia-smi`` name and power limit, the torch device name;
   TF32 off for convolutions and matrix products.
2. build: every kernel of the path from ``csrc/`` with ``nvcc`` (sm_90a).
3. kernel vs plain: the ConvLSTM gate tail at the main path's shape, in
   fp32 and bf16, at an unaligned channels-last shape, and its gradient.
4. main path: a synthetic ACDC tree (1 test patient, 2 slices, a 30-frame
   cycle, HR 256×256, LR 64×64) written with the port's NIfTI writer, a
   RefineNet with seeded random weights saved as ``{'net': state_dict}``,
   then ``main.test_from_config`` on ``cuda:0``; the kernel's launch count
   must be exactly 756 per clip and every metric finite.
5. whole forward: one clip through the net with the kernel and with the
   plain gate tail, and a small clip on the card against the CPU.
6. times: the kernel's and the plain version's time per launch (CUDA
   graphs of 100 launches over buffers larger than L2), beside the bound.

The second-to-last line is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``.  Needs only torch and numpy: no PyYAML,
no imageio, nothing of JAX.
"""
from __future__ import annotations

import json
import math
import pickle
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
LAUNCHES_PER_CLIP = len(NET_KWARGS["num_features"]) * 2 * T_CLIP * NET_KWARGS["num_stages"]  # 756

TOL_FP32 = 2e-6  # expf/tanhf against ATen's: an ulp or two
TOL_BF16 = 1e-2  # one rounding to bf16 of values below 4, against the fp32 plain version
TOL_GRAD = 1e-6  # both backwards recompute the same plain version
TOL_FORWARD = 1e-4  # 42 recurrent steps × 3 stages in fp32

# Memory rate and fp32 (non-tensor-core) peak by part, from NVIDIA's H100
# data sheets (PCIe, NVL, SXM).
CARDS = [("PCIe", 2.0e12, 51e12), ("NVL", 3.9e12, 60e12), ("", 3.35e12, 67e12)]
GATE_OPS_PER_ELEMENT = 19  # 3 sigmoids (3 each) + 2 tanh (3 each) + 4 for c' and h'


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


def write_acdc_tree(root: Path, nifti, seed: int = 0) -> dict:
    """The layout of ``tests/fixtures.py:make_acdc_tree`` (videos tree only):
    one test patient, ``SLICES`` slices, a ``CYCLE``-frame cycle."""
    import numpy as np

    rng = np.random.default_rng(seed)
    patient = "patient001"
    base = rng.uniform(40, 200, size=(HR, HR, 1, 1)).astype(np.float32)
    wave = 40 * np.sin(np.linspace(0, 2 * np.pi, CYCLE, endpoint=False)).astype(np.float32)
    for s in range(1, SLICES + 1):
        hr = np.clip(base + wave + rng.normal(0, 10, size=(HR, HR, 1, CYCLE)), 0, 255)
        hr = hr.round().astype(np.float32)
        name = f"{patient}_2d+1d_sequence{s:0>2d}.nii.gz"
        nifti.save(hr, root / "videos" / "test" / "HR" / patient / name)
        nifti.save(hr[::SCALE, ::SCALE], root / "videos" / "test" / "LR" / f"X{SCALE}" / patient / name)
    end = int(CYCLE * 0.4)
    code = np.concatenate([np.cos(np.linspace(0, np.pi, end, endpoint=False)),
                           np.cos(np.linspace(np.pi, 2 * np.pi, CYCLE - end, endpoint=False))])
    with open(root / "position_code.pkl", "wb") as f:
        pickle.dump({patient: code.astype(np.float32)}, f)
    with open(root / "coordinates.pkl", "wb") as f:
        pickle.dump({patient: (HR // 4, 3 * HR // 4, HR // 4, 3 * HR // 4)}, f)
    return {"videos": root / "videos", "pos_code": root / "position_code.pkl",
            "coordinates": root / "coordinates.pkl"}


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
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils import nifti

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
    log("kernel", f"gradient through the autograd.Function vs plain autograd: max abs err "
                  f"{err:.3e} (tol {TOL_GRAD})")
    if not err <= TOL_GRAD:
        raise AssertionError(f"gate kernel gradient disagrees: {err}")

    # --------------------------------------------------------------- 4 main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        tree = write_acdc_tree(tmp / "acdc", nifti)
        net = RefineNet(**NET_KWARGS, generator=torch.Generator().manual_seed(0))
        ckpt = tmp / "model.pth"
        torch.save({"net": net.state_dict()}, ckpt)
        log("main", f"synthetic tree: 1 patient, {SLICES} slices, {CYCLE} frames, HR {HR}x{HR}, "
                    f"LR {h_lr}x{h_lr}; RefineNet {sum(p.numel() for p in net.parameters()):,} params")
        # warm the CUDA context and cuDNN's algorithm choice on one clip first
        net.to(dev).eval()
        rng = np.random.default_rng(1)
        clip = torch.from_numpy(rng.standard_normal((1, T_CLIP, h_lr, h_lr, 1)).astype(np.float32)).to(dev)
        pos = torch.from_numpy(rng.uniform(-1, 1, (1, T_CLIP, 1)).astype(np.float32)).to(dev)
        with torch.inference_mode():
            net(clip, pos)
        torch.cuda.synchronize()

        cfg = Cfg(eval_config(tree, ckpt, tmp / "test"))
        lstm_gates.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        predictor = port_main.test_from_config(cfg)
        wall = time.perf_counter() - t0
        launches = lstm_gates.LAUNCHES
        log("main", f"Test log: {predictor.log}")
        log("main", f"lstm_gates launches: {launches} (expected {LAUNCHES_PER_CLIP} x {SLICES} clips)")
        if launches != LAUNCHES_PER_CLIP * SLICES:
            raise AssertionError(f"main path launched the gate kernel {launches} times")
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
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, ops / fp32_peak * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log("times", f"lstm_gates fp32 NCHW {shape_g}: kernel {kernel_ms * 1e3:.2f} us, plain "
                 f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us ({nbytes} bytes at "
                 f"{mem_rate / 1e12} TB/s; {ops} ops at {fp32_peak / 1e12} TFLOP/s: "
                 f"{ops_ms * 1e3:.3f} us); per clip {LAUNCHES_PER_CLIP} launches = "
                 f"{kernel_ms * LAUNCHES_PER_CLIP:.2f} ms")

    record = {"kernels": [{
        "name": "lstm_gates",
        "route": "cuda",
        "source": f"{PKG}/csrc/lstm_gates.cu",
        "replaces": "efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu/ops/pallas/lstm_gates.py:31",
        "launches": launches,
        "max_abs_err": errors[str(torch.float32)],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": list(shape_g),
        "dtype": "float32",
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
