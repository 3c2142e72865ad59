"""Where the single-image nets spend their time on the card.

    python -m efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.profile_sisr \
        [--nets EDSRNet SRFBNet Bicubic] [--modes eval train] [--compute-dtype bfloat16]

Runs each net at its ``configs/{test,train}/<net>/exp1_x4.yaml`` width with
seeded random weights, in fp32 with TF32 off, on the shapes of the serving
and training paths: ``eval`` is one LR 64×64 frame under
``torch.inference_mode()``; ``train`` is one step of the trainer (batch 16
of 32×32 LR patches: forward, the L1 loss (its mean over the steps for
SRFB), backward, Adam).  ``--compute-dtype bfloat16`` runs the forward and
backward as the runners' ``compute_dtype`` knob does (bf16 copies of the
fp32 weights and inputs).  For each it prints:

* the wall time of a call (host clock around a synchronised call, median
  of several), with ``torch.backends.cudnn.benchmark`` off (the port's
  setting) and on, in turns (off, on, on, off);
* the same with benchmark off in the two memory layouts, in turns (NCHW,
  channels-last, channels-last, NCHW): a pre-hook on the first conv hands
  it its input in that layout, which every later op keeps; the nets choose
  ``models/common.conv_format(dtype)``;
* from ``torch.profiler`` with benchmark off, in the net's own layout:
  the device's busy share, the top kernels by device time, cuDNN's
  NCHW↔NHWC transposes, and the top ATen ops by the device time of their
  own kernels;
* the operations of the call counted from the conv shapes (as
  ``chip_smoke.py`` counts them) and their rate.

The last line is one JSON object with these numbers.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict

import torch

from ..models import Bicubic, EDSRNet, SRFBNet
from ..models.common import conv_format
from ..utils.casting import forward_in, resolve_dtype

NETS = {  # configs/{test,train}/<net>/exp1_x4.yaml
    "EDSRNet": (EDSRNet, {"in_channels": 1, "out_channels": 1, "num_resblocks": 32,
                          "num_features": 256, "upscale_factor": 4, "res_scale": 0.1}),
    "SRFBNet": (SRFBNet, {"in_channels": 1, "out_channels": 1, "num_steps": 4,
                          "num_features": 32, "num_groups": 6, "upscale_factor": 4}),
    "Bicubic": (Bicubic, {"upscale_factor": 4}),
}
SHAPES = {"eval": (1, 64, 64, 1), "train": (16, 32, 32, 1)}  # LR (B, h, w, C)
SCALE, REPEATS, TOP = 4, 7, 12
TRANSPOSES = ("nchwToNhwc", "nhwcToNchw")
LAYOUTS = {"nchw": torch.contiguous_format, "channels_last": torch.channels_last}


def _conv_ops(net, x) -> int:
    """Operations (a multiply-add is 2) of every conv and transposed conv in
    one forward, from their shapes."""
    total = 0

    def hook(mod, args, out):
        nonlocal total
        k = mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
        total += 2 * k * (args[0].numel() if isinstance(mod, torch.nn.ConvTranspose2d)
                          else out.numel())

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    with torch.inference_mode():
        net(x)
    for h in handles:
        h.remove()
    return total


def _call(name: str, mode: str, dev, dtype):
    """The call to time: a forward (eval) or a whole training step."""
    cls, kwargs = NETS[name]
    net = cls(**kwargs, generator=torch.Generator().manual_seed(0)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(SHAPES[mode], device=dev, generator=gen)
    ops = _conv_ops(net, x)
    if mode == "eval":
        net.eval()

        def call():
            with torch.inference_mode():
                return forward_in(net, dtype, x)
        return call, ops, net

    B, h, w, C = SHAPES[mode]
    target = torch.randn(B, h * SCALE, w * SCALE, C, device=dev, generator=gen)
    opt = torch.optim.Adam(net.parameters(), lr=1e-4)

    def call():
        opt.zero_grad(set_to_none=True)
        out = forward_in(net, dtype, x)
        outs = out if isinstance(out, list) else [out]
        loss = torch.stack([(o - target).abs().mean() for o in outs]).mean()
        loss.backward()
        opt.step()
        return loss
    # forward + backward ≈ 3 forwards (data and weight gradients one each)
    return call, 3 * ops, net


def _first_conv(net):
    return next((m for m in net.modules() if isinstance(m, torch.nn.Conv2d)), None)


def _force(fmt):
    def hook(module, args):
        return (args[0].clone(memory_format=fmt),)
    return hook


def _wall_ms(call) -> float:
    walls = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def profile(name: str, mode: str, dev, dtype=None) -> dict:
    call, ops, net = _call(name, mode, dev, dtype)
    walls = {}
    for benchmark in (False, True, True, False):
        torch.backends.cudnn.benchmark = benchmark
        for _ in range(3):  # warm-up (and cuDNN's search when benchmark is on)
            call()
        torch.cuda.synchronize()
        walls.setdefault(benchmark, []).append(_wall_ms(call))
    torch.backends.cudnn.benchmark = False
    layouts = {}
    first = _first_conv(net)
    for layout in (("nchw", "channels_last", "channels_last", "nchw") if first is not None else ()):
        handle = first.register_forward_pre_hook(_force(LAYOUTS[layout]))
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        layouts.setdefault(layout, []).append(_wall_ms(call))
        handle.remove()
    chosen = next(k for k, v in LAYOUTS.items() if v == conv_format(dtype or torch.float32))
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
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
    transposes = {t: sum(n for k, (_, n) in by_name.items() if t in k) for t in TRANSPOSES}
    ops_avg = sorted(prof.key_averages(group_by_input_shape=True),
                     key=lambda e: -e.self_device_time_total)[:TOP]
    top_ops = [{"op": e.key, "shapes": str(e.input_shapes)[:120],
                "ms": e.self_device_time_total / 1e3, "count": e.count}
               for e in ops_avg if e.self_device_time_total > 0]
    off, on = statistics.median(walls[False]), statistics.median(walls[True])
    params = sum(p.numel() for p in net.parameters())
    print(f"{name} {mode} {SHAPES[mode]} {dtype or torch.float32} ({params:,} params): wall "
          f"{off:.3f} ms with "
          f"cudnn.benchmark off {[round(v, 3) for v in walls[False]]}, {on:.3f} ms on "
          f"{[round(v, 3) for v in walls[True]]}; {ops:.4g} operations, "
          f"{ops / off / 1e9:.2f} TFLOP/s off, {ops / on / 1e9:.2f} on", flush=True)
    if layouts:
        print(f"  layout (benchmark off): NCHW {layouts['nchw']} ms, channels-last "
              f"{layouts['channels_last']} ms; the net's own: {chosen}")
    print(f"  profiled (benchmark off): wall {prof_wall:.3f} ms, {len(kernels)} kernels "
          f"{kernel_ms:.3f} ms, device busy {kernel_ms / prof_wall:.1%}; transposes {transposes}")
    for kname, (ms, n) in top:
        print(f"  {ms:9.3f} ms {n:5d}x  {kname[:120]}")
    print("  top ATen ops by the device time of their own kernels:")
    for o in top_ops:
        print(f"  {o['ms']:9.3f} ms {o['count']:5d}x  {o['op']} {o['shapes'][:90]}")
    return {"net": name, "mode": mode, "shape": list(SHAPES[mode]),
            "compute_dtype": str(dtype or torch.float32), "params": params,
            "operations": ops, "wall_ms_benchmark_off": walls[False],
            "wall_ms_benchmark_on": walls[True], "wall_ms_by_layout": layouts,
            "layout": chosen,
            "profiled_wall_ms": prof_wall,
            "kernel_ms": kernel_ms, "kernels": len(kernels), "transposes": transposes,
            "top_kernels": [{"name": k, "ms": ms, "count": n} for k, (ms, n) in top],
            "top_ops": top_ops}


def _parse_args():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nets", nargs="+", default=list(NETS), choices=list(NETS))
    parser.add_argument("--modes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    parser.add_argument("--compute-dtype", default=None, help="e.g. bfloat16; default fp32")
    return parser.parse_args()


def main() -> None:
    args = _parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_sisr needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    dtype = resolve_dtype(args.compute_dtype)
    results = [profile(name, mode, dev, dtype) for name in args.nets for mode in args.modes
               if not (name == "Bicubic" and mode == "train")]  # Bicubic has no weights
    print(json.dumps({"card": card, "results": results}), flush=True)


if __name__ == "__main__":
    main()
