"""Where the flagship eval forward spends its time on the card.

    python -m efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.profile_eval

Runs the flagship RefineNet ×4 (``configs/test/refine_net/exp1_x4.yaml``
widths, seeded random weights) on one serving clip, (1, 42, 64, 64, 1),
under ``torch.inference_mode()`` in fp32 with TF32 off, and prints:

* the forward's wall time per clip (host clock around a synchronised run);
* per top-level block (in-block, forward / backward ConvLSTM, refine block,
  out-block), the time between CUDA events recorded on entry and exit;
* the device's busy share and the top kernels by device time, from
  ``torch.profiler``;
* the gate wrapper's host time per call, on the serving path (no autograd)
  and on the autograd path, at the main path's shape.

The last line is one JSON object with these numbers.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from ..models.refine_net import RefineNet
from ..ops import lstm_gates

NET_KWARGS = {  # configs/test/refine_net/exp1_x4.yaml:26-40
    "in_channels": 1, "out_channels": 1, "num_features": [64, 64, 64], "upscale_factor": 4,
    "num_stages": 3, "update_memory": True, "num_updated_frames": 6,
    "refine_window_size": 5, "positional_encoding": True,
}
CLIP = (1, 30 + 2 * 6, 64, 64, 1)  # one serving clip: 30 core + 2×6 warm-up frames, LR 64×64
REPEATS, TOP = 5, 15
BLOCKS = ("in_block", "forward_lstm_block", "backward_lstm_block", "refine_block", "out_block")


def _block_timers(net):
    """CUDA events around every call of each top-level block."""
    events = defaultdict(list)

    def pre(name):
        def hook(module, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name].append([ev, None])
        return hook

    def post(name):
        def hook(module, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1][1] = ev
        return hook

    handles = []
    for name in BLOCKS:
        block = getattr(net, name)
        handles += [block.register_forward_pre_hook(pre(name)),
                    block.register_forward_hook(post(name))]
    return events, handles


def _host_us_per_gate_call(dev, requires_grad: bool, calls: int = 756) -> float:
    """Host time to enqueue one clip's worth of gate-tail calls."""
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn(1, 256, 64, 64, device=dev, generator=gen).requires_grad_(requires_grad)
    c = torch.randn(1, 64, 64, 64, device=dev, generator=gen)
    for _ in range(10):
        lstm_gates.fused_lstm_gates(g, c, dim=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        lstm_gates.fused_lstm_gates(g, c, dim=1)
    host_us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return host_us


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_eval needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)

    net = RefineNet(**NET_KWARGS, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    rng = np.random.default_rng(0)
    lr = torch.from_numpy(rng.standard_normal(CLIP).astype(np.float32)).to(dev)
    pos = torch.from_numpy(rng.uniform(-1, 1, (1, CLIP[1], 1)).astype(np.float32)).to(dev)

    with torch.inference_mode():
        for _ in range(2):
            net(lr, pos)
        torch.cuda.synchronize()
        walls = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            net(lr, pos)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)

        events, handles = _block_timers(net)
        net(lr, pos)
        torch.cuda.synchronize()
        for h in handles:
            h.remove()
        blocks_ms = {name: sum(a.elapsed_time(b) for a, b in events[name]) for name in BLOCKS}

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        launches = lstm_gates.LAUNCHES
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            net(lr, pos)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        launches = lstm_gates.LAUNCHES - launches

    host_us = {"serving": _host_us_per_gate_call(dev, False),
               "autograd": _host_us_per_gate_call(dev, True)}

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3  # us → ms
        by_name[e.name][1] += 1
    device_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]

    print(f"forward wall per clip {CLIP}: "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms", flush=True)
    for name in BLOCKS:
        print(f"  {name:22s} {blocks_ms[name]:9.2f} ms (CUDA events, entry to exit)")
    print(f"profiled forward: wall {prof_wall:.1f} ms, kernels {device_ms:.1f} ms "
          f"({len(kernels)} launches), device busy {device_ms / prof_wall:.1%}; "
          f"lstm_gates launches {launches}")
    for name, (ms, n) in top:
        print(f"  {ms:9.2f} ms {n:6d}x  {name[:110]}")
    print(f"gate wrapper host time per call: serving {host_us['serving']:.2f} us, "
          f"autograd {host_us['autograd']:.2f} us")
    print(json.dumps({
        "card": card, "clip": list(CLIP),
        "wall_ms": walls, "blocks_ms": blocks_ms, "profiled_wall_ms": prof_wall,
        "kernel_ms": device_ms, "kernel_launches": len(kernels), "lstm_gates_launches": launches,
        "gate_wrapper_host_us": host_us,
        "top_kernels": [{"name": n, "ms": ms, "count": c} for n, (ms, c) in top],
    }), flush=True)


if __name__ == "__main__":
    main()
