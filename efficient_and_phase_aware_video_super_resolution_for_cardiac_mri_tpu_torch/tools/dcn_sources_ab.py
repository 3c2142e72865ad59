"""The deformable conv's kernels built from other sources, against this tree's, on the card.

    git show <commit>:efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch/csrc/deform_conv.cu > old.cu
    python -m efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.dcn_sources_ab \
        [--sources old.cu ...] [--saved-x-cl]

Builds each source given (by nvcc, with the package's flags, into
``build/``) beside the package's own ``csrc/deform_conv.cu`` and times,
per launch, im2col on an NCHW x (its transpose included) and on a
channels-last x, and col2im, for each build in turns (this tree, the
others, the others backwards, this tree), and col2im_coord: every
source's entry points must take the tree's arguments (the geometry's row
origin ``pad_h`` is its last field, so a source from before it, with one
``pad``, reads the fields it knows at these meshless geometries).  The
operands and the timer are ``chip_smoke.py`` phase 19's (EDVR's L1 DCN call
at the serving window and the training batch, 8 deformable groups, offsets
up to ±3.5 px, fp32 and bf16, CUDA graphs over operand sets larger than
L2).  With ``--saved-x-cl``, also an fp32 EDVR forward and backward at
``chip_smoke.py`` phase 21's batch, in turns: as the port runs it (the
backward's col2im_coord transposes x again) and with the channels-last x
that im2col built saved for the backward: the device time of its kernels,
its transposes and its peak memory.  The last line is one JSON object.
Needs a CUDA card and a checkout (it imports ``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .. import losses
from ..ops import _build, deform_conv

TREE = "tree"


def _chip_smoke():
    path = _build.PACKAGE_DIR.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _build_other(source: Path) -> _build.Built:
    """``source`` built into ``build/`` and its three entry points bound."""
    text = source.read_bytes()
    digest = hashlib.sha256(text + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"{source.stem}-ab-{digest}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(source)],
                   capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, operands in {"deform_im2col": [ptr, i32, ptr, ptr, ptr, ptr],
                           "deform_col2im": [ptr] * 5,
                           "deform_col2im_coord": [ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr]}.items():
        for sfx in ("f32", "bf16"):
            f = getattr(lib, f"{name}_{sfx}")
            f.argtypes = [*operands, ptr, ptr]
            f.restype = ctypes.c_int
    return _build.Built(lib, out, 0.0, "")


def kernels(cs, sources: list[Path]) -> dict:
    dev = torch.device("cuda")
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        tree = pool.submit(deform_conv.build)
        builds = dict(zip((s.name for s in sources), pool.map(_build_other, sources)))
        builds = {TREE: tree.result(), **builds}
    names = list(builds)
    real = deform_conv.build
    times = {}
    try:
        for shape_name, shape in cs.DCN_SHAPES.items():
            for dtype in (torch.float32, torch.bfloat16):
                gen = torch.Generator(device=dev).manual_seed(10)
                x, off, mask, gc, g = cs.dcn_operands(deform_conv, shape, dtype, dev, gen)
                el = x.element_size()
                n = cs._n_sets(el * (x.numel() + mask.numel() + 2 * gc.numel()) + 4 * off.numel())
                sets = [cs.dcn_operands(deform_conv, shape, dtype, dev, gen)[:4]
                        for _ in range(n)]
                cl = [(a[0].contiguous(memory_format=torch.channels_last), *a[1:]) for a in sets]
                calls = {"im2col_us": (sets, lambda a: deform_conv.deform_im2col(*a[:3], g)),
                         "im2col_channels_last_us": (
                             cl, lambda a: deform_conv.deform_im2col(*a[:3], g)),
                         "col2im_us": (sets, lambda a: deform_conv.deform_col2im(
                             a[3], a[1], a[2], g)),
                         "col2im_coord_us": (sets, lambda a: deform_conv.deform_col2im_coord(
                             a[3], *a[:3], g))}
                key = f"{shape_name} {dtype}"
                times[key] = {name: {} for name in names}
                for name in names + names[::-1]:
                    deform_conv.build = lambda name=name: builds[name]
                    for k, (operands, fn) in calls.items():
                        ms = cs.time_graph_ms([lambda a=a, fn=fn: fn(a)
                                               for a in cs._cycled(operands)])
                        times[key][name].setdefault(k, []).append(ms * 1e3)
                for name in names:
                    print(f"{key} {tuple(shape)} {name}: " + "; ".join(
                        f"{k} " + " ".join(f"{t:.2f}" for t in v)
                        for k, v in times[key][name].items()), flush=True)
                del sets, cl
    finally:
        deform_conv.build = real
    return times


def saved_x_cl(cs) -> dict:
    """An fp32 EDVR forward and backward, x saved or x_cl saved, in turns."""
    dev = torch.device("cuda")
    net = cs.seeded_edvr(cs.EDVR_NET).to(dev).train()
    gen = torch.Generator(device=dev).manual_seed(3)
    lr = torch.rand(cs.TRAIN_BATCH, cs.EDVR_T, cs.PATCH, cs.PATCH, 1, device=dev, generator=gen)
    with torch.no_grad():
        hr = torch.rand(net(lr).shape, device=dev, generator=gen)
    loss_fn = losses.CharbonnierLoss(epsilon=1e-6)

    def train_pass():
        net.zero_grad(set_to_none=True)
        loss_fn(net(lr), hr).backward()

    port_forward, channels_last = deform_conv._DeformConv.forward, deform_conv._channels_last

    def forward_saving_x_cl(ctx, x, offset, mask, weight, bias, g):
        built = []

        def keep(x_, dtype):
            built.append(channels_last(x_, dtype))
            return built[-1]
        deform_conv._channels_last = keep
        try:
            col = deform_conv.deform_im2col(x, offset, mask, g)
        finally:
            deform_conv._channels_last = channels_last
        ctx.save_for_backward(built[0][1].permute(0, 3, 1, 2), offset, mask, weight, col)
        ctx.g, ctx.has_bias = g, bias is not None
        return deform_conv._contract(col, weight, bias, g)

    out = {}
    try:
        for variant in ("x", "x_cl", "x_cl", "x"):
            deform_conv._DeformConv.forward = staticmethod(
                port_forward if variant == "x" else forward_saving_x_cl)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            train_pass()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - held
            busy = cs.device_busy(train_pass, reps=5)
            transposes = [v for k, v in busy[4].items() if "transpose_kernel" in k]
            r = out.setdefault(variant, {"kernel_ms": [], "transpose_ms": [], "transposes": [],
                                         "peak_above_held_gib": []})
            r["kernel_ms"].append(busy[1])
            r["transpose_ms"].append(sum(t for t, _ in transposes))
            r["transposes"].append(sum(n for _, n in transposes))
            r["peak_above_held_gib"].append(peak / 2**30)
            print(f"EDVR fp32 forward + backward, {variant} saved: kernels {busy[1]:.3f} ms, "
                  f"{r['transposes'][-1]} transposes {r['transpose_ms'][-1]:.4f} ms, peak "
                  f"{peak / 2**30:.4f} GiB above the {held / 2**30:.4f} held", flush=True)
    finally:
        deform_conv._DeformConv.forward = staticmethod(port_forward)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sources", nargs="*", type=Path, default=[])
    parser.add_argument("--saved-x-cl", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("dcn_sources_ab needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    cs = _chip_smoke()
    result = {"card": card, "kernels": kernels(cs, [s.resolve() for s in args.sources])}
    if args.saved_x_cl:
        result["saved_x_cl"] = saved_x_cl(cs)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
