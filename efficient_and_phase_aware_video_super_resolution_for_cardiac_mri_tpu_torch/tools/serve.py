"""Headless SR serving: raw LR NIfTI volumes in → SR NIfTI volumes out.

The port's counterpart of the JAX package's ``tools/serve.py``: the entry
point for new patients, whose acquisitions carry no HR target (the
predictors evaluate datasets that do).  It composes the port's serving
pieces:

* every zoo net and its checkpoint (``runner/checkpoint.load_net_state_dict``:
  a ``.pth`` of the port or the reference, or a JAX package pickle):
  whole-sequence nets take the clip, window nets get the circular window
  around each frame, batched into one forward, frame nets get the frames
  batched (``_WORKLOADS``);
* the flagship's warm-up margins and phase codes: the margins are the
  cycle's own frames wrapped circularly, as the eval datasets build them
  (``data/datasets.VSRRefineNetDataset``), and a patient without a code in
  ``--pos-code`` gets one generated from its LR frames by the preprocessing
  tools' algorithm (``tools/cardiac_cropping.find_bbox`` and
  ``tools/gen_positional_encoding.phase_code``, numpy twins of OpenCV's);
* ``--t-bucket`` (circular extension of the cycle, sliced back to the true
  T), ``--tile`` / ``--tile-overlap`` / ``--seam-stats`` (``ops/tiling.py``),
  ``--dtype bfloat16`` (``utils/casting``), the windowed-op telemetry
  (``ops/telemetry.py``), ``--aot-cache`` (accepted and logged: the port
  compiles nothing per shape);
* a double-buffered loop (``utils/dispatch.DoubleBuffer``): volume k+1's
  forwards are launched before volume k's output is fetched, assembled and
  handed to a writer thread.

The forward runs under ``torch.inference_mode()``; the output is
denormalized on the device and fetched as uint8 (exact integers in
[0, 255]).  Outputs mirror the input tree, ``OUT/<relpath>``, in the source
(H·r, W·r, S, T) layout, float32 by default (``--out-dtype uint8`` writes
the same values in a quarter of the bytes).  Writes are atomic (tmp +
rename) and finished outputs are skipped, so ``--watch`` (poll the input
until SIGTERM/SIGINT) is restart-safe.  A volume that fails is logged and
skipped; the daemon goes on.

    python -m <torch pkg>.tools.serve CONFIG.yaml --in LR_DIR --out SR_DIR \\
        [--ckpt model_best.pth] [--stats acdc|dsb15|MEAN,STD] \\
        [--pos-code position_code.pkl] [--dtype bfloat16] [--t-bucket N] \\
        [--tile N [--tile-overlap R]] [--aot-cache DIR] \\
        [--watch [--poll SEC]] [--device cuda:0|cpu]

CONFIG.yaml is any zoo config: only its ``net:`` section (and
``main.loaded_path`` as the default checkpoint) is read.  The device is the
card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import pickle
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..config import NETS, load_config
from ..ops import telemetry as tel
from ..ops.tiling import tiled_apply
from ..runner import common
from ..runner.checkpoint import load_net_state_dict
from ..utils import casting, native_io, nifti
from ..utils.dispatch import DoubleBuffer, Fetch, upload
from ..utils.stats import get_stats

LOG = logging.getLogger("evsr.serve")

#: which element of a multi-output forward is the served SR frame, as the
#: predictors pick it: a stage list serves its final fused stage, FRVSR
#: returns (sr, warped)
_OUTPUT_PICKERS = {
    "FRVSRNet": lambda outs: outs[0] if isinstance(outs, (tuple, list)) else outs,
}

#: how each zoo family consumes a cardiac cycle: ``sequence`` nets take the
#: whole (1, T(+2U), H, W, C) clip; ``window`` nets the N-frame window around
#: each frame (one batch of T windows); ``frame`` nets the frames (one batch)
_WORKLOADS = {
    "Bicubic": "frame", "EDSRNet": "frame", "SRFBNet": "frame",
    "DRFSISRNet": "frame",
    "DUFNet": "window", "EDVRNet": "window", "RBPNet": "window",
    "TOFlowNet": "window",
    "DRFNet": "sequence", "FRVSRNet": "sequence", "RefineNet": "sequence",
}


def _pick_output(net_name: str, outputs):
    picker = _OUTPUT_PICKERS.get(net_name)
    if picker is not None:
        return picker(outputs)
    return outputs[-1] if isinstance(outputs, (tuple, list)) else outputs


def neutral_phase_code(T: int) -> np.ndarray:
    """Fallback when phase estimation fails (blank or degenerate data): one
    cosine period over the cycle, the code's shape without a detected
    end-systole anchor."""
    return np.cos(np.linspace(0, 2 * np.pi, T, endpoint=False)).astype(np.float32)


def generate_phase_code(raw_slice: np.ndarray) -> np.ndarray:
    """(H, W, 1, T) raw (un-normalized) LR sequence → (T,) phase code.

    The offline pipeline derives codes from HR data and motion bboxes; at
    serving time only LR exists, so the same Otsu end-systole algorithm runs
    on the LR frames with a motion bbox found on them (the full frame when
    the bbox degenerates)."""
    from .cardiac_cropping import find_bbox
    from .gen_positional_encoding import phase_code

    H, W, _, T = raw_slice.shape
    try:
        bbox = find_bbox(raw_slice)
        h0, hn, w0, wn = bbox
        if hn - h0 < 2 or wn - w0 < 2:
            bbox = (0, H, 0, W)
    except Exception:
        bbox = (0, H, 0, W)
    try:
        code = phase_code(raw_slice, bbox)
        if code.shape != (T,) or not np.all(np.isfinite(code)):
            raise ValueError("degenerate code")
        return code.astype(np.float32)
    except Exception:
        LOG.warning("phase-code estimation failed; using the neutral cosine code")
        return neutral_phase_code(T)


def _wrap(core: np.ndarray, U: int, t_bucket: int | None):
    """The eval-time input sequence from one cardiac cycle: circular warm-up
    margins of U frames each side and, with ``t_bucket``, the core extended
    circularly to the next multiple (``VSRPredictor._bucket_batch``).
    ``core``: (T, ...) → (extended array, true T).  Both margins index
    modulo T, so a clip shorter than U still gets full margins."""
    T = core.shape[0]
    Tb = -(-T // t_bucket) * t_bucket if t_bucket else T
    idx = np.arange(Tb) % T
    front = np.arange(-U, 0) % T
    back = np.arange(Tb, Tb + U) % T
    parts = [core[front], core[idx], core[back]] if U else [core[idx]]
    return np.concatenate(parts, axis=0), T


class Server:
    """One loaded net on one device, serving volumes."""

    def __init__(self, cfg, args, device: torch.device):
        from ..main import _import_components

        _import_components()  # populate the NETS registry
        net_kwargs = dict(cfg["net"].get("kwargs") or {})
        self.net_name = cfg["net"]["name"]
        self.device = device
        self.workload = (args.workload if args.workload != "auto"
                         else _WORKLOADS.get(self.net_name, "sequence"))
        self.margins = (int(net_kwargs.get("num_updated_frames", 0) or 0)
                        if self.workload == "sequence" else 0)
        self.positional = bool(net_kwargs.get("positional_encoding", False))
        # the window comes from the net itself, its centre from
        # --temporal-order (the MISR datasets' default 'middle')
        self.num_frames = int(net_kwargs.get("num_frames") or net_kwargs.get("nframes") or 5)
        self.temporal_order = args.temporal_order
        self.mean, self.std = _parse_stats(args.stats)
        self.t_bucket = args.t_bucket
        self.dtype = casting.resolve_dtype(args.dtype)
        self.telemetry = not args.no_telemetry
        self.telemetry_warn_frac = float(args.telemetry_warn_frac)
        self.telemetry_summary: dict = {}
        self.seam_stats = args.seam_stats
        self._seam_probed_shapes: set = set()
        self.tile = (args.tile, args.tile) if args.tile else None
        self.tile_overlap = args.tile_overlap
        self.pos_codes = _load_pickle(args.pos_code) if args.pos_code else None
        common.accept_aot_cache(args.aot_cache)

        ckpt = args.ckpt or (cfg.get("main") or {}).get("loaded_path")
        if not ckpt:
            raise SystemExit("no checkpoint: pass --ckpt or set main.loaded_path")
        self.net = NETS.get(self.net_name)(**net_kwargs)
        self.net.load_state_dict(load_net_state_dict(Path(ckpt), self.net_name), strict=True)
        self.net.to(device).eval()
        LOG.info(f"Loaded {self.net_name} weights from {ckpt}.")

    # ------------------------------------------------------------ forward
    def _forward(self, state, *inputs) -> torch.Tensor:
        """The net on device inputs → the denormalized uint8 SR output."""
        out = _pick_output(self.net_name,
                           casting.forward_in(self.net, self.dtype, *inputs, state=state))
        return common.denorm_uint8(out.float(), self.mean, self.std).to(torch.uint8)

    def _want_seam(self, inputs) -> bool:
        if self.seam_stats == "all":
            return True
        if self.seam_stats == "off":
            return False
        hw = next((tuple(a.shape[-3:-1]) for a in inputs if a.dim() >= 4), None)
        if hw is None or hw in self._seam_probed_shapes:
            return False
        self._seam_probed_shapes.add(hw)
        return True

    def _run(self, inputs, collector: tel.Collector, state):
        """One slice's forward, whole or tiled → (uint8 output, seam stats
        or None).  A tile's output is already in display units, so the
        seam statistics are gray levels."""
        def forward(*a):
            return self._forward(state, *a)

        if self.tile is None:
            return forward(*inputs), None

        def probe(*a):
            # probe windows re-cover predicted samples: their telemetry is dropped
            with collector.pause():
                return forward(*a)

        if self._want_seam(inputs):
            return tiled_apply(forward, inputs, self.tile, self.tile_overlap,
                               seam_stats=True, probe_fn=probe)
        return tiled_apply(forward, inputs, self.tile, self.tile_overlap), None

    # ----------------------------------------------------------- per file
    @torch.inference_mode()
    def dispatch(self, src: Path):
        """Load and prepare one volume and launch its slices' forwards →
        (Fetch of the per-slice uint8 outputs and telemetry triples, site
        names, seam stats or None, true T).  The fetch is the caller's
        ``finish`` step, one volume behind."""
        vol = native_io.load_volume(src) if native_io.enabled() else \
            np.asarray(nifti.load(src).data, np.float32)  # (H, W, S, T)
        if vol.ndim == 3:
            vol = vol[:, :, None, :]
        if vol.ndim != 4:
            raise ValueError(f"{src}: expected (H, W, S, T) volume, got {vol.shape}")
        H, W, S, T = vol.shape
        patient = src.name.split(".")[0].split("_")[0]

        collector = tel.Collector()
        state = casting.cast_state(self.net, self.dtype)  # once for all slices
        outs, seams = [], []
        true_t = T
        with tel.collect(self.net, collector) if self.telemetry else contextlib.nullcontext():
            for s in range(S):
                raw = vol[:, :, s:s + 1, :]  # (H, W, 1, T)
                frames = np.transpose(raw, (3, 0, 1, 2))  # (T, H, W, 1)
                core = ((frames - self.mean) / self.std).astype(np.float32)
                if self.workload == "sequence":
                    lr, true_t = _wrap(core, self.margins, self.t_bucket)
                    inputs = [lr[None]]  # (1, T + 2U, H, W, 1)
                    if self.positional:
                        code = self._phase_code(patient, raw)
                        pos, _ = _wrap(code[:, None], self.margins, self.t_bucket)
                        inputs.append(pos[None].astype(np.float32))
                else:
                    # the whole cycle as one batch of T items (frames, or the
                    # circular windows around each frame); t_bucket pads the
                    # batch with wrapped centres
                    Tb = -(-T // self.t_bucket) * self.t_bucket if self.t_bucket else T
                    centers = np.arange(Tb) % T
                    if self.workload == "frame":
                        inputs = [core[centers]]  # (Tb, H, W, 1)
                    else:
                        idx = np.stack([self._window_idx(int(t), T) for t in centers])
                        inputs = [core[idx]]  # (Tb, N, H, W, 1)
                inputs = [upload(np.ascontiguousarray(a), self.device) for a in inputs]
                out, seam = self._run(inputs, collector, state)
                outs.append(out)
                if seam:
                    seams.append(seam)
        seam_agg = None
        if seams:
            seam_agg = {"rms": max(s["rms"] for s in seams),
                        "max_abs": max(s["max_abs"] for s in seams),
                        "n_probes": sum(s["n_probes"] for s in seams)}
        sites = list(collector.triples)
        triples = torch.stack([t.float() for t in collector.triples.values()]) if sites else None
        fetch = Fetch(triples=triples, **{f"slice{s}": o for s, o in enumerate(outs)})
        return fetch, sites, seam_agg, true_t

    def _window_idx(self, t: int, T: int) -> np.ndarray:
        """Circular [start, end) window around centre ``t`` (the MISR
        datasets' ``temporal_order``)."""
        n = self.num_frames
        if self.temporal_order == "last":
            start, end = t - n + 1, t + 1
        else:
            start, end = t - (n - 1) // 2, t + ((n - 1) - (n - 1) // 2) + 1
        return np.arange(start, end) % T

    def _phase_code(self, patient: str, raw_slice: np.ndarray) -> np.ndarray:
        if self.pos_codes is not None:
            code = self.pos_codes.get(patient)
            if code is not None:
                return np.asarray(code, np.float32)
            LOG.warning(f"{patient}: not in --pos-code pickle; generating")
        return generate_phase_code(raw_slice)

    @staticmethod
    def assemble(outs, true_t: int, out_dtype=np.float32) -> np.ndarray:
        """Per-slice uint8 outputs → the source (H', W', S, T) layout.
        Sequence nets return (1, T', H', W', 1), frame and window nets a
        (T', H', W', 1) batch; both are sliced to the true T.  float32 (the
        predictors' ``export_nifti`` convention) is exact, the values being
        integers in [0, 255]."""
        srs = [(a[0] if a.ndim == 5 else a)[:true_t] for a in outs]  # (T, H', W', 1)
        sr = np.stack([np.transpose(s[..., 0], (1, 2, 0)) for s in srs], axis=2)
        return sr.astype(out_dtype)

    @staticmethod
    def write(sr: np.ndarray, dst: Path):
        """Atomic NIfTI write: a crash leaves only a .tmp, which the
        done-check ignores.  The tmp keeps the final ``.gz`` suffix, by
        which ``nifti.save`` decides to compress."""
        dst.parent.mkdir(parents=True, exist_ok=True)
        tmp = dst.with_name(dst.name + (".tmp.gz" if dst.name.endswith(".gz") else ".tmp"))
        nifti.save(sr, tmp)
        tmp.rename(dst)


def _parse_stats(spec: str) -> tuple[float, float]:
    if "," in spec:
        m, s = spec.split(",")
        return float(m), float(s)
    return get_stats(spec)


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def discover(in_dir: Path, out_dir: Path, pattern: str):
    """(src, dst) pairs not served yet, in a stable order."""
    pairs = []
    for src in sorted(in_dir.glob(pattern)):
        if not src.is_file() or ".tmp" in src.name:
            continue
        dst = out_dir / src.relative_to(in_dir)
        if not dst.exists():
            pairs.append((src, dst))
    return pairs


def serve(args) -> int:
    """Serve every volume under ``--in`` not yet under ``--out`` (and, with
    ``--watch``, new ones until SIGTERM/SIGINT) → the number served."""
    from ..main import resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    server = Server(cfg, args, device)
    in_dir, out_dir = Path(args.in_dir), Path(args.out_dir)
    out_dtype = np.dtype(args.out_dtype)

    stop = threading.Event()
    if args.watch:
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, lambda *_: stop.set())
            except ValueError:  # not the main thread
                pass

    # gzip and the disk write are host work: writer threads overlap them
    # with the next volume; every write is drained before the next
    # discover(), so the done-check never races a pending write
    writers = ThreadPoolExecutor(max_workers=2, thread_name_prefix="evsr-write")
    pending: list = []
    failed = [0]

    def _finish_one(item):
        fetch, sites, seam, true_t, dst, src, t0 = item
        try:
            # a volume's device error surfaces at its fetch: log, go on
            got = fetch.wait()
            outs = [got[f"slice{s}"] for s in range(len(got) - 1)]
            sr = server.assemble(outs, true_t, out_dtype)
        except Exception as e:
            LOG.error(f"{src}: {type(e).__name__}: {e}")
            failed[0] += 1
            return
        note = ""
        if sites:
            summary = tel.summarize(dict(zip(sites, torch.from_numpy(got["triples"]))))
            tel.check(summary, server.telemetry_warn_frac, context=src.name)
            tel.merge_summaries(server.telemetry_summary, summary)
            note = f" [{tel.format_summary(summary)}]"
        if seam:
            note += (f" [tile seam: rms={seam['rms']:.3f} max={seam['max_abs']:.1f} "
                     f"display units]")
        frames = true_t * len(outs)

        def _write():
            server.write(sr, dst)
            sec = time.perf_counter() - t0
            LOG.info(f"{src.name}: {frames} frames in {sec:.2f}s ({frames / sec:.1f} fps) "
                     f"-> {dst}{note}")

        pending.append(writers.submit(_write))

    buf = DoubleBuffer(_finish_one)
    total, busy_sec = 0, 0.0
    try:
        while True:
            pairs = discover(in_dir, out_dir, args.glob)
            cycle_t0 = time.perf_counter()
            served_this_cycle = 0
            for src, dst in pairs:
                if stop.is_set():
                    break
                t0 = time.perf_counter()
                try:
                    fetch, sites, seam, true_t = server.dispatch(src)
                except Exception as e:  # one bad volume must not end the daemon
                    LOG.error(f"{src}: {type(e).__name__}: {e}")
                    continue
                buf.push((fetch, sites, seam, true_t, dst, src, t0))
                total += 1
                served_this_cycle += 1
            buf.drain()
            for f in pending:
                try:
                    f.result()
                except Exception as e:
                    LOG.error(f"write failed: {type(e).__name__}: {e}")
                    failed[0] += 1
            pending.clear()
            total -= failed[0]
            served_this_cycle -= failed[0]
            failed[0] = 0
            if served_this_cycle:
                busy_sec += time.perf_counter() - cycle_t0
            if not args.watch or stop.is_set():
                break
            stop.wait(args.poll)
    finally:
        writers.shutdown(wait=True)
    if server.telemetry_summary:
        LOG.info("Windowed-op telemetry (run aggregate): "
                 f"{tel.format_summary(server.telemetry_summary)}.")
    if total and busy_sec:
        # per-file lines measure launch-to-write latency, which overlaps
        # between volumes; this is the aggregate rate
        LOG.info(f"Served {total} volume(s) in {busy_sec:.3f}s busy "
                 f"({total / busy_sec:.2f} volumes/sec aggregate).")
    else:
        LOG.info(f"Served {total} volume(s).")
    return total


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config", help="zoo YAML; only net: (+ main.loaded_path) is read")
    p.add_argument("--in", dest="in_dir", required=True, help="LR NIfTI tree")
    p.add_argument("--out", dest="out_dir", required=True, help="SR output tree")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint (.pth of the port or the reference, or a JAX pickle)")
    p.add_argument("--glob", default="**/*.nii*", help="input file pattern")
    p.add_argument("--stats", default="acdc",
                   help="'acdc', 'dsb15', or 'MEAN,STD' normalization stats")
    p.add_argument("--pos-code", default=None,
                   help="position_code.pkl with exact per-patient codes "
                        "(generated from the LR data when absent)")
    p.add_argument("--device", default="cuda:0", help="cuda:0 (the default) or cpu")
    p.add_argument("--dtype", default=None, help="compute dtype, e.g. bfloat16")
    p.add_argument("--out-dtype", default="float32", choices=["float32", "uint8"],
                   help="on-disk SR dtype; values are exact [0,255] integers "
                        "either way, uint8 quarters the written bytes")
    p.add_argument("--workload", default="auto", choices=["auto", "sequence", "window", "frame"],
                   help="how the net consumes the cycle (auto: by net family)")
    p.add_argument("--temporal-order", default="middle", choices=["middle", "last"],
                   help="window-net centre convention (MISR dataset default)")
    p.add_argument("--t-bucket", type=int, default=None,
                   help="pad cycles circularly to a multiple of N frames")
    p.add_argument("--tile", type=int, default=None, help="tiled inference: LR tile size")
    p.add_argument("--tile-overlap", type=int, default=8)
    p.add_argument("--aot-cache", default=None,
                   help="accepted and logged: the port compiles nothing per shape")
    p.add_argument("--watch", action="store_true",
                   help="poll --in for new volumes until SIGTERM/SIGINT")
    p.add_argument("--poll", type=float, default=5.0, help="watch poll seconds")
    p.add_argument("--no-telemetry", action="store_true",
                   help="disable the windowed-knob exceedance telemetry (on by default, "
                        "free for nets without max_flow/dcn_max_offset)")
    p.add_argument("--telemetry-warn-frac", type=float, default=0.0,
                   help="warn when a volume's out-of-window sample fraction exceeds this")
    p.add_argument("--seam-stats", default="first", choices=["first", "all", "off"],
                   help="tiled serving: measure the tile-seam error with boundary-probe "
                        "windows, for one slice per distinct input (H, W) ('first'), every "
                        "slice ('all') or none ('off')")
    return p.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(message)s", level=logging.INFO,
                        datefmt="%Y-%m-%d %H:%M:%S")
    return serve(_parse_args(argv))


if __name__ == "__main__":
    main()
