"""Serving entry: the port's daemon (``tools/serve.py``) working through a
backlog of new patients.

Set-up draws the weights on the device and saves them as the checkpoint
the daemon loads, writes the traffic's inbox of LR sequences, and starts
the daemon with ``--watch`` over it, in this process's main thread (its
stop path is the SIGTERM handler it installs there).  No ``--pos-code`` is
given, so the daemon generates each slice's phase code as it does for a
new patient; the cell's ``out_dtype`` is the daemon's ``--out-dtype``.

The window opens when the cell's ``warmup_sequences``-th SR file is renamed
into the output tree (the kernel build, cuDNN's first calls and the first
phase codes are behind it) and closes at the last file renamed before
``--seconds`` have passed; a monitor thread then sends SIGTERM, and the
daemon finishes the volumes in flight and returns.  Rates are taken over
whole files: frames of the files renamed in (open, close] over
(close − open).

A sequence's latency is the daemon's own per-file time: from the start of
its ``Server.dispatch`` (the daemon's ``t0`` is taken just before it) to its
SR file renamed into place.
"""
from __future__ import annotations

import gc
import json
import logging
import os
import signal
import statistics
import threading
import time

import numpy as np
import torch

from ..bench import compare, nifti, phantom, work
from ..bench.context import program
from ..bench.trace import device_events, reduce
from ..reference.phase_code import phase_code


#: the faults the serving path can have, planted by ``_plant``
FAULTS = ("output", "state")


class _ErrorCount(logging.Handler):
    def __init__(self):
        super().__init__(logging.ERROR)
        self.times = []

    def emit(self, record):
        self.times.append(time.perf_counter())


def reference_sr(cfg: dict, params: dict, lrs: list, device, tf32: bool = False,
                 block: int = 2) -> np.ndarray:
    """The reference's served frames of the (H, W, T) LR sequences ``lrs``:
    the phase code found on the LR frames, circular warm-up margins,
    normalisation, the final fused branch, denormalised to rounded gray
    levels → (B, T, rH, rW) float32; ``block`` sequences a forward."""
    if len(lrs) > block:
        return np.concatenate([reference_sr(cfg, params, lrs[i:i + block], device, tf32, block)
                               for i in range(0, len(lrs), block)])
    mean, std = cfg["serve"]["stats"]
    U = cfg["net"]["kwargs"]["num_updated_frames"]
    xs, codes = [], []
    for lr in lrs:
        T = lr.shape[-1]
        idx = np.concatenate([np.arange(-U, 0) % T, np.arange(T), np.arange(T, T + U) % T])
        frames = np.transpose(lr, (2, 0, 1))
        xs.append(((frames - mean) / std).astype(np.float32)[idx])
        codes.append(phase_code(lr)[idx])
    x = torch.from_numpy(np.stack(xs)[..., None]).to(device)
    pos = torch.from_numpy(np.stack(codes)[..., None]).to(device)
    net = work.reference_net(cfg, {k: v.to(device) for k, v in params.items()})
    with work.numerics(tf32), torch.no_grad():
        out = net.forward(x, pos)[-1][..., 0]
        sr = torch.clamp(torch.round(out * std + mean), 0, 255)
    return sr.cpu().numpy()


def _p90_ms(seconds: list) -> float:
    if len(seconds) < 2:
        return 1e3 * seconds[0]
    return 1e3 * statistics.quantiles(seconds, n=10, method="inclusive")[-1]


def _plant(ctx, serve_mod):
    """Faults under the timed path (tests and the limit probe): ``output``
    adds 2 gray levels to one frame of every served clip where it is
    produced; ``state`` makes every ConvLSTM step return its state
    unchanged."""
    undo = []
    if "output" in ctx.faults:
        Server = serve_mod.Server
        orig = Server._forward

        def forward(self, state, *inputs):
            out = orig(self, state, *inputs)
            out[:, 0] = out[:, 0].clamp(max=253) + 2
            return out

        Server._forward = forward
        undo.append(lambda: setattr(Server, "_forward", orig))
    if "state" in ctx.faults:
        cell_cls = program("models.refine_net").ConvLSTMCell
        orig_cell = cell_cls.forward
        cell_cls.forward = lambda self, x, h, c, w, b: (h, c)
        undo.append(lambda: setattr(cell_cls, "forward", orig_cell))
    return undo


def run(ctx) -> dict:
    serve_mod = program("tools.serve")
    device = program("main").resolve_device(ctx.device)  # fp32, TF32 off on the card
    cfg, traffic, cell = ctx.config, ctx.traffic, ctx.workload
    on_card = device.type == "cuda"

    marks = [("start", time.perf_counter())]
    net = work.build_net(cfg["net"], device)
    shapes = work.shapes_of(net)
    del net
    params = work.seeded_weights(cfg, shapes, ctx.seed, device)
    host_params = {k: v.cpu() for k, v in params.items()}
    ckpt = ctx.work / "weights.pth"
    torch.save({"net": host_params}, ckpt)
    del params
    inbox, outbox = ctx.work / "inbox", ctx.work / "outbox"
    tree = phantom.write_tree(traffic, ctx.seed, inbox, device)
    marks.append(("weights and inbox", time.perf_counter()))
    src_index = {str(inbox / p / n): i for i, (p, n) in enumerate(tree["names"])}
    yaml_path = ctx.work / "serve.yaml"  # YAML reads JSON
    yaml_path.write_text(json.dumps({"net": cfg["net"], "main": {"loaded_path": str(ckpt)}}))
    mean, std = cfg["serve"]["stats"]
    args = serve_mod._parse_args([
        str(yaml_path), "--in", str(inbox), "--out", str(outbox), "--watch",
        "--poll", str(cell["poll_s"]), "--device", ctx.device, "--stats", f"{mean},{std}",
        "--out-dtype", cell.get("out_dtype", "float32")])

    # benchmark spans around the daemon's calls
    spans = ctx.spans
    Server, Fetch = serve_mod.Server, serve_mod.Fetch
    orig = (Server.dispatch, Server.write, Fetch.wait)
    started, renamed = {}, {}
    opened, done = threading.Event(), threading.Event()
    warm = int(cell["warmup_sequences"])

    def dispatch(self, src):
        t0 = time.perf_counter()
        try:
            return orig[0](self, src)
        finally:
            t1 = time.perf_counter()
            started[str(src)] = t0
            spans.add("dispatch", t0, t1)

    def write(sr, dst):
        t0 = time.perf_counter()
        orig[1](sr, dst)
        t1 = time.perf_counter()
        spans.add("write", t0, t1)
        renamed[str(dst)] = t1
        if len(renamed) >= warm:
            opened.set()

    def wait(self):
        t0 = time.perf_counter()
        try:
            return orig[2](self)
        finally:
            spans.add("fetch", t0, time.perf_counter())

    window = {}

    def monitor():
        limit = time.perf_counter() + float(cell["open_timeout_s"])
        while not opened.wait(0.2):
            if done.is_set():
                return
            if time.perf_counter() > limit:
                window["error"] = f"fewer than {warm} sequences served in {cell['open_timeout_s']} s"
                break
        if "error" not in window:
            window["open"] = sorted(renamed.values())[warm - 1]
            deadline = window["open"] + ctx.seconds
            done.wait(max(0.0, deadline - time.perf_counter()))
        if not done.is_set():
            os.kill(os.getpid(), signal.SIGTERM)

    errors = _ErrorCount()
    log = logging.getLogger("evsr.serve")
    log.addHandler(errors)
    Server.dispatch, Server.write, Fetch.wait = dispatch, staticmethod(write), wait
    undo = _plant(ctx, serve_mod)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    prof = None
    if ctx.trace:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    watcher = threading.Thread(target=monitor, name="bench-monitor", daemon=True)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    watcher.start()
    try:
        serve_mod.serve(args)
    finally:
        done.set()
        watcher.join()
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
        if prof is not None:
            prof.stop()
        Server.dispatch, Server.write, Fetch.wait = orig[0], staticmethod(orig[1]), orig[2]
        for fn in undo:
            fn()
        log.removeHandler(errors)
    if "error" in window:
        raise RuntimeError(window["error"])
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    gc.collect()  # the daemon's net and buffers, before the reference runs
    if on_card:
        torch.cuda.empty_cache()

    t_open, deadline = window["open"], window["open"] + ctx.seconds
    inside = {d: t for d, t in renamed.items() if t_open < t <= deadline}
    if not inside:
        raise RuntimeError("no sequence was served inside the window")
    t_close = max(inside.values())
    frames = traffic["frames"]
    lat = []  # (dispatch start, latency) of each sequence of the window
    for dst, t in inside.items():
        src = str(inbox / os.path.relpath(dst, outbox))
        lat.append((started[src], t - started[src]))
    lat = [d for _, d in sorted(lat)]
    third = max(2, len(lat) // 3)
    failed = sum(t_open < t <= t_close for t in errors.times)

    # the reference, on a sample drawn from the seed
    rng = np.random.default_rng(ctx.seed)
    chosen = sorted(rng.choice(sorted(inside), size=min(int(cell["sample_sequences"]), len(inside)),
                               replace=False))
    lrs = [tree["lr"][src_index[str(inbox / os.path.relpath(d, outbox))]] for d in chosen]
    ref = reference_sr(cfg, host_params, lrs, device)
    served = np.stack([np.transpose(nifti.read(d)[:, :, 0, :], (2, 0, 1)) for d in chosen])
    gray_max, mismatch = compare.gray_gaps(served, ref)
    control = None
    if ctx.control:  # the reference at TF32 in the program's place
        gaps = compare.gray_gaps(reference_sr(cfg, host_params, lrs, device, tf32=True), ref)
        control = {"gray_mismatch_pct": gaps[1], "gray_max": gaps[0]}

    lr_shape = tree["lr"][0].shape
    T_clip = frames + 2 * cfg["net"]["kwargs"]["num_updated_frames"]
    clip_ops = work.count_ops(
        cfg, shapes, lambda net, cut: net.forward(
            torch.zeros(1, T_clip, lr_shape[0] // cut, lr_shape[1] // cut, 1),
            torch.zeros(1, T_clip, 1)), False, 1)
    reduced = None
    if prof is not None:
        reduced = reduce(device_events(prof), spans.to_wall_ns(t_open), spans.to_wall_ns(t_close),
                         spans)
    return {
        "open": t_open, "close": t_close,
        "metrics": {
            "serve_frames_per_s": len(inside) * frames / (t_close - t_open),
            "sequence_ms_p90": _p90_ms(lat),
        },
        "counts": {"sequences in the window": len(inside),
                   "sequence_ms median": 1e3 * statistics.median(lat),
                   "sequence_ms p90, first and last third of the window": [
                       _p90_ms(lat[:third]), _p90_ms(lat[-third:])],
                   "median ms in dispatch, fetch, write": [
                       1e3 * statistics.median(spans.named(n, t_open, t_close) or [0.0])
                       for n in ("dispatch", "fetch", "write")],
                   "sequences compared": len(chosen),
                   "gray_max (widest gap, gray levels)": gray_max,
                   "set-up seconds": {"weights and inbox": round(marks[1][1] - marks[0][1], 3),
                                      "daemon to the window": round(t_open - marks[1][1], 3)},
                   "inbox bytes": tree["bytes"],
                   "outbox bytes": sum(p.stat().st_size for p in outbox.rglob("*.gz"))},
        "attempted": len(inside) + failed, "failed": failed,
        "memory_peak_bytes": peak,
        "numbers": {"gray_mismatch_pct": mismatch},
        "control_numbers": control,
        "trace": reduced,
        "layer": {"units": len(inside), "unit_ops": clip_ops,
                  "gate_shape": (1, cfg["net"]["kwargs"]["num_features"][-1], *lr_shape[:2]),
                  "dispatch_ms": [1e3 * d for d in spans.named("dispatch", t_open, t_close)]},
    }
