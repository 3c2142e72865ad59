"""Where the multi-frame and plain video nets spend their time on the card.

    python -m efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.profile_misr \
        [--nets DUFNet RBPNet TOFlowNet TOFlowNet_tpu RBPNet_tpu DRFNet FRVSRNet FRVSRNet_tpu \
                EDVRNet EDVRNet_tpu] \
        [--modes eval train] [--eval-batch N]

Runs each net at its ``configs/{test,train}/<net>/exp1_x4.yaml`` width with
seeded random weights, in fp32 with TF32 off, on the shapes of the serving
and training paths: ``eval`` is one window of 7 LR 64×64 frames (a whole
30-frame clip for the video nets, DRF and FRVSR) under
``torch.inference_mode()`` (the net in eval mode; ``--eval-batch N`` windows
or clips at once, as ``tools/serve.py`` batches a slice's 30 windows);
``train`` is one step
of the trainer (the config's batch of 32×32 LR patches, 7 frames, FRVSR's
10: forward, the config's loss, backward, Adam; the net in training mode).
``TOFlowNet_tpu`` is ``configs/test/toflow_net/exp1_x4_tpu.yaml``
(``max_flow: 4``, bf16 compute), ``RBPNet_tpu``
``configs/train/rbp_net/exp1_x4_tpu.yaml`` (bf16, the batch as two
microbatches) and ``FRVSRNet_tpu`` ``configs/test/frvsr_net/exp1_x4_tpu.yaml``
(``max_flow: 4``, bf16 compute); ``EDVRNet`` is
``configs/{test,train}/edvr_net/exp1_x4.yaml`` (5 frames, Charbonnier) and
``EDVRNet_tpu`` ``configs/train/edvr_net/exp1_x4_tpu.yaml`` (bf16,
``dcn_max_offset: 2``, two microbatches).  Each EDVR call is profiled
twice: with its offset convs at their zero init (every offset 0) and with
their parameters drawn from N(0, 0.1) (offsets of about a pixel, as
``chip_smoke.py`` draws them).  For each it prints:

* the wall time of a call (host clock around a synchronised call, median
  of several), with ``torch.backends.cudnn.benchmark`` off (the port's
  setting) and on, in turns (off, on, on, off);
* from ``torch.profiler`` with benchmark off: the device's busy share, the
  number of kernels, the top kernels by device time, and the top ATen ops
  by the device time of their own kernels (the op that launched them);
* the deformable conv's kernels (``csrc/deform_conv.cu``): each one's
  launches, device ms, µs a launch and share of the device time;
* the operations of the call counted as ``chip_smoke.py`` counts them
  (convs, 3D convs, transposed convs, every resize product, DUF's filter
  product, the deformable convs' GEMMs; a training step as three
  forwards) and their rate.

The last line is one JSON object with these numbers.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import time
from collections import defaultdict

import torch
import torch.nn.functional as F

from ..models import DRFNet, DUFNet, EDVRNet, FRVSRNet, RBPNet, TOFlowNet
from ..ops import deform_conv, resize
from ..utils.casting import forward_in

T, SCALE, REPEATS, TOP = 7, 4, 5, 14
CLIP = 30  # the video nets serve a whole cycle
DUF = {"in_channels": 1, "out_channels": 1, "num_frames": T, "size_filter": 5,
       "upscale_factor": SCALE, "backbone": "_DenseLayer16"}
RBPN = {"in_channels": 1, "out_channels": 1, "base_filter": 256, "feat": 64, "num_stages": 3,
        "num_resblocks": 5, "num_frames": T, "upscale_factor": SCALE}
TOFLOW = {"in_channels": 1, "out_channels": 1, "num_frames": T, "upscale_factor": SCALE}
DRF = {"in_channels": 1, "out_channels": 1, "num_features": 32, "num_groups": 6,
       "upscale_factor": SCALE}
FRVSR = {"in_channels": 1, "out_channels": 1, "num_resblocks": 10, "upscale_factor": SCALE}
EDVR = {"in_channels": 1, "out_channels": 1, "nf": 128, "nframes": 5, "groups": 8,
        "front_RBs": 5, "back_RBs": 40}
#: name → (class, kwargs, compute dtype, train batch, microbatches, loss,
#: frames (eval, train))
NETS = {
    "DUFNet": (DUFNet, DUF, None, 12, 1, "huber", (T, T)),
    "RBPNet": (RBPNet, RBPN, None, 16, 1, "l1", (T, T)),
    "TOFlowNet": (TOFlowNet, TOFLOW, None, 16, 1, "l1", (T, T)),
    "TOFlowNet_tpu": (TOFlowNet, {**TOFLOW, "max_flow": 4}, torch.bfloat16, 16, 1, "l1", (T, T)),
    "RBPNet_tpu": (RBPNet, RBPN, torch.bfloat16, 16, 2, "l1", (T, T)),
    "DRFNet": (DRFNet, DRF, None, 16, 1, "l1", (CLIP, 7)),
    "FRVSRNet": (FRVSRNet, FRVSR, None, 16, 1, "flow+mse", (CLIP, 10)),
    "FRVSRNet_tpu": (FRVSRNet, {**FRVSR, "max_flow": 4}, torch.bfloat16, 16, 1, "flow+mse",
                     (CLIP, 10)),
    "EDVRNet": (EDVRNet, EDVR, None, 16, 1, "charbonnier", (5, 5)),
    "EDVRNet_tpu": (EDVRNet, {**EDVR, "dcn_max_offset": 2}, torch.bfloat16, 16, 2,
                    "charbonnier", (5, 5)),
}
LR_HW = {"eval": 64, "train": 32}
#: the std of EDVR's offset-conv parameters in its two profiled calls
EDVR_OFFSET_STDS = (0.0, 0.1)


def _ops(net, x) -> int:
    """Operations (a multiply-add is 2) of one forward, as chip_smoke.py
    counts them."""
    total = 0

    def hook(mod, args, out):
        nonlocal total
        k = math.prod(mod.weight.shape[1:])
        total += 2 * k * (args[0].numel() if isinstance(mod, torch.nn.ConvTranspose2d)
                          else out.numel())

    plain_resize, plain_contract = resize._resize, deform_conv._contract

    def counted_resize(y, out_hw, align_corners, kind, axis=None):  # rows, then columns
        nonlocal total
        hh, ww = y.shape[-3], y.shape[-2]
        total += 2 * (y.numel() // (hh * ww)) * (out_hw[0] * hh * ww + out_hw[0] * out_hw[1] * ww)
        return plain_resize(y, out_hw, align_corners, kind, axis)

    def counted_contract(col, weight, bias, g):  # the DCN's (Cout, C·K) @ col GEMM
        nonlocal total
        total += 2 * weight.numel() * g.B * g.Ho * g.Wo
        return plain_contract(col, weight, bias, g)

    convs = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Conv3d)
    handles = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, convs)]
    resize._resize, deform_conv._contract = counted_resize, counted_contract
    try:
        with torch.inference_mode():
            net(x)
    finally:
        resize._resize, deform_conv._contract = plain_resize, plain_contract
        for h in handles:
            h.remove()
    B, _, h, w, C = x.shape
    if isinstance(net, DUFNet):  # sf² taps × r² subpixels a pixel
        total += 2 * B * C * net.size_filter ** 2 * SCALE ** 2 * h * w
    return total


def _call(name: str, mode: str, dev, offset_std: float, eval_batch: int = 1):
    """The call to time: a forward (eval) or a whole training step."""
    cls, kwargs, dtype, batch, micro, loss_name, frames = NETS[name]
    net = cls(**kwargs, generator=torch.Generator().manual_seed(0))
    if offset_std:
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for pname, p in net.named_parameters():
                if "conv_offset_mask" in pname:
                    p.normal_(0.0, offset_std, generator=gen)
    net = net.to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    B = eval_batch if mode == "eval" else batch
    t = frames[0] if mode == "eval" else frames[1]
    x = torch.randn(B, t, LR_HW[mode], LR_HW[mode], 1, device=dev, generator=gen)
    ops = _ops(net.eval(), x)
    if mode == "eval":
        def call():
            with torch.inference_mode():
                return forward_in(net, dtype, x)
        return call, ops, net, dtype

    net.train()
    video = cls in (DRFNet, FRVSRNet)  # a frame out for every frame in
    hr = LR_HW[mode] * SCALE
    target = torch.randn(B, *((t,) if video else ()), hr, hr, 1, device=dev, generator=gen)
    opt = torch.optim.Adam(net.parameters(), lr=1e-4)

    def loss_fn(out, tgt, lr):
        if loss_name == "huber":
            return F.huber_loss(out, tgt, delta=0.01)
        if loss_name == "flow+mse":  # FlowLoss on the warped LR frames, MSE on the SR
            return F.mse_loss(out[1], lr) + F.mse_loss(out[0], tgt)
        if loss_name == "charbonnier":
            return torch.sqrt((out - tgt) ** 2 + 1e-6).mean()
        return (out - tgt).abs().mean()

    def call():
        opt.zero_grad(set_to_none=True)
        m = B // micro
        for i in range(micro):
            xs = x[i * m:(i + 1) * m]
            loss_fn(forward_in(net, dtype, xs), target[i * m:(i + 1) * m], xs).backward()
        opt.step()
    return call, 3 * ops, net, dtype


def _wall_ms(call) -> float:
    walls = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def profile(name: str, mode: str, dev, offset_std: float = 0.0, eval_batch: int = 1) -> dict:
    call, ops, net, dtype = _call(name, mode, dev, offset_std, eval_batch)
    walls = {}
    for benchmark in (False, True, True, False):
        torch.backends.cudnn.benchmark = benchmark
        for _ in range(2):  # warm-up (and cuDNN's search when benchmark is on)
            call()
        torch.cuda.synchronize()
        walls.setdefault(benchmark, []).append(_wall_ms(call))
    torch.backends.cudnn.benchmark = False
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    kernel_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    dcn = deform_conv.trace_share(by_name)
    ops_avg = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:TOP]
    top_ops = [{"op": e.key, "ms": e.self_device_time_total / 1e3, "count": e.count}
               for e in ops_avg if e.self_device_time_total > 0]
    off, on = statistics.median(walls[False]), statistics.median(walls[True])
    params = sum(p.numel() for p in net.parameters())
    frames = NETS[name][6][0 if mode == "eval" else 1]
    shape = (eval_batch if mode == "eval" else NETS[name][3], frames, LR_HW[mode], LR_HW[mode], 1)
    offsets = f", offset convs ~ N(0, {offset_std})" if NETS[name][0] is EDVRNet else ""
    print(f"{name} {mode} {shape} {dtype or torch.float32} ({params:,} params{offsets}): wall "
          f"{off:.3f} ms "
          f"with cudnn.benchmark off {[round(v, 3) for v in walls[False]]}, {on:.3f} ms on "
          f"{[round(v, 3) for v in walls[True]]}; {ops:.4g} operations, "
          f"{ops / off / 1e9:.2f} TFLOP/s off, {ops / on / 1e9:.2f} on", flush=True)
    print(f"  profiled (benchmark off): wall {prof_wall:.3f} ms, {len(kernels)} kernels "
          f"{kernel_ms:.3f} ms, device busy {kernel_ms / prof_wall:.1%}")
    for kname, (ms, n) in top:
        print(f"  {ms:9.3f} ms {n:5d}x  {kname[:120]}")
    if dcn:
        dcn_ms = sum(t for t, _ in dcn.values())
        print(f"  the deformable conv's kernels: {dcn_ms:.3f} ms, {dcn_ms / kernel_ms:.1%} of the "
              f"device time")
        for key, (ms, n) in dcn.items():
            print(f"  {ms:9.3f} ms {n:5d}x  {ms / n * 1e3:8.1f} us a launch  "
                  f"{ms / kernel_ms:6.1%}  {key}")
    print("  top ATen ops by the device time of their own kernels:")
    for o in top_ops:
        print(f"  {o['ms']:9.3f} ms {o['count']:5d}x  {o['op']}")
    return {"net": name, "mode": mode, "shape": list(shape),
            "compute_dtype": str(dtype or torch.float32), "params": params, "operations": ops,
            "wall_ms_benchmark_off": walls[False], "wall_ms_benchmark_on": walls[True],
            "profiled_wall_ms": prof_wall, "kernel_ms": kernel_ms, "kernels": len(kernels),
            "top_kernels": [{"name": k, "ms": ms, "count": n} for k, (ms, n) in top],
            "top_ops": top_ops, "offset_std": offset_std,
            "dcn_kernels": {k: {"ms": ms, "launches": n} for k, (ms, n) in dcn.items()}}


def _parse_args():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nets", nargs="+", default=["DUFNet", "RBPNet", "TOFlowNet"],
                        choices=list(NETS))
    parser.add_argument("--modes", nargs="+", default=list(LR_HW), choices=list(LR_HW))
    parser.add_argument("--eval-batch", type=int, default=1,
                        help="windows (clips) a forward in eval mode")
    return parser.parse_args()


def main() -> None:
    args = _parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_misr needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    results = [profile(name, mode, dev, std, args.eval_batch)
               for name in args.nets for mode in args.modes
               for std in (EDVR_OFFSET_STDS if NETS[name][0] is EDVRNet else (0.0,))]
    print(json.dumps({"card": card, "results": results}), flush=True)


if __name__ == "__main__":
    main()
