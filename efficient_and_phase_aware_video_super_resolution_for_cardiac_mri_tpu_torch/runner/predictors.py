"""Predictors: test-time evaluation and export.

The port's counterpart of the JAX package's ``runner/predictors.py`` for the
RefineNet eval path, the single-image family (SISR, SISRSRFB), the
multi-frame family (MISR) and the plain video family (VSR, FRVSR).  The
contract is the reference's: batch size 1, per-frame loss/metric tables,
Cardiac* metrics routed with the patient name parsed from the dataset path,
CSV / GIF / PNG export, and the log weighted by sequence length.

The forward runs eagerly under ``torch.inference_mode()`` on the predictor's
device; each item's scores and display frames come back to the host once.
The loop is double-buffered as the JAX package's is
(``utils/dispatch.DoubleBuffer``): item k+1's batch is copied to the card
and its forward launched before item k's results are fetched, logged and
exported, in item order.  The inputs go up from pinned memory and the
results come down into pinned memory behind an event, neither of which
waits for the stream, so the host prepares item k+1 while the card still
computes item k.  ``EVSR_EAGER_EVAL=1`` fetches each item before the next
is launched; the logs, files, telemetry lines and ``item_seconds`` are the
same in both orders.
The JAX package's serving knobs, each computing what it computes there:

* ``compute_dtype`` (``bfloat16``): the forward on bf16 copies of the
  parameters and inputs (``utils/casting.forward_in``), its output cast
  back to fp32; losses, metrics and the uint8 display in fp32.
* ``t_bucket`` N: the cycle is extended circularly to the next multiple of
  N (``VSRPredictor._bucket_batch``); the masks use the true shape, and
  losses, metrics and exported frames are sliced back to the true T.
* ``tile`` / ``tile_overlap`` / ``seam_stats``: the forward runs on fixed
  windows (``ops/tiling.py``), the first item of each (H, W) also through
  seam probes whose disagreement is logged in gray levels.
* ``aot_cache``: accepted and logged; the port compiles nothing per shape.
* ``telemetry`` (on by default) / ``telemetry_warn_frac``: each item's
  forward collects the windowed call sites' exceedance triples
  (``ops/telemetry.py``; nets without ``max_flow`` or ``dcn_max_offset``
  record none, EDVR's four DCN packs record theirs, a tiled item merges
  its windows' and drops its seam probes'), fetched with the
  item's scores; an item whose out-of-window fraction exceeds
  ``telemetry_warn_frac`` logs a warning naming its file, and the run's
  aggregate is logged as ``Windowed-op telemetry``.

* ``export_nifti``: the SR frames written back as NIfTI volumes,
  ``<saved_dir>/nifti/<patient>/<sequenceNN>.nii.gz``, (H, W, 1, T) float32
  display values: one file a sequence item for the video family, the frames
  of consecutive items stacked per (patient, slice) for the single-image
  and multi-frame families.

With a ``mesh`` (``parallel/mesh.py``) the items are dealt round-robin to
the spatial groups (every rank holds the whole net, so a model axis splits
items too; without a spatial axis a group is one rank); each group runs
its items through the same loop, and the lead rank gathers every group's
fetched scores, frames and telemetry and folds them in item order, so the
Test log, the CSV and the exports are the meshless run's.

Under a spatial axis each rank of a group feeds the net its rows of the
item's image inputs (the phase code has no H axis and goes whole), the
net's convs exchange their halos (``parallel/halo.py``), and the SR rows
are gathered whole before the losses, the metrics and the exports: SSIM's
11-tap window and the Cardiac masks see whole frames, as under the JAX
package's GSPMD.  A height the spatial size does not divide is computed
whole on every rank of the group (warned once).  ``pad_h`` (the parallel
section's, as in the JAX package's ``main``) edge-extends such heights to
the next multiple instead, after the ``t_bucket`` padding, and crops the
output and the target back to the true height before they are scored.
"""
from __future__ import annotations

import contextlib
import csv
import logging
import os
import time
from pathlib import Path

import numpy as np
import torch

import torch.distributed as dist

from ..config import PREDICTORS
from ..ops import telemetry as tel
from ..ops.tiling import tiled_apply
from ..parallel import (
    gather_rows,
    pad_height_to_multiple,
    shard_spatially,
    spatial_step,
    take_rows,
)
from ..parallel.mesh import _spatial_key
from ..utils import casting, imgio, nifti
from ..utils.dispatch import DoubleBuffer, Fetch, upload
from ..utils.stats import get_stats
from . import checkpoint as ckpt_io
from . import common

LOG = logging.getLogger(__name__)


def _fetch_item(total, losses, metrics, frames, collector: tel.Collector) -> Fetch:
    """Start an item's fetch; its telemetry triples travel with its scores
    as one (sites, 3) stack (``ops/telemetry.summarize`` reads them back)."""
    triples = torch.stack([t.float() for t in collector.triples.values()]) \
        if collector.triples else None
    return Fetch(total=total, losses=losses, metrics=metrics, frames=frames, triples=triples)


def _nifti_path(saved_dir: Path, patient: str, sid: str) -> Path:
    return saved_dir / "nifti" / patient / f"{sid.replace('slice', 'sequence')}.nii.gz"


class BasePredictor:
    """Reference ``src/runner/predictors/base_predictor.py:6-136``."""

    dataset_stats = "acdc"

    def __init__(
        self,
        device: torch.device | str = "cuda",
        test_dataloader=None,
        net=None,
        loss_fns=None,
        loss_weights=None,
        metric_fns=None,
        saved_dir=None,
        exported=False,
        export_nifti: bool = False,
        dataset_stats: str | None = None,
        telemetry: bool = True,
        telemetry_warn_frac: float = 0.0,
        t_bucket: int = 0,
        compute_dtype: str | None = None,
        aot_cache: str | None = None,
        tile=None,
        tile_overlap: int | None = None,
        seam_stats: bool | str = "first",
        parallel=None,
        mesh=None,
        pad_h: bool = False,
    ):
        # ``tile``: the forward on fixed-shape overlapping windows, exact when
        # the overlap covers the net's receptive field; the overlap is
        # mandatory (no net-independent default is safe).  A single-device
        # strategy: not with a ``parallel:`` section nor with ``pad_h``.
        if tile is not None:
            hw = (tile, tile) if np.ndim(tile) == 0 else tuple(int(t) for t in tile)
            if len(hw) != 2:
                raise ValueError(f"tile must be an int or (th, tw), got {tile!r}")
            if tile_overlap is None:
                raise ValueError(
                    "tile requires tile_overlap (>= the net's receptive-field "
                    "radius in LR pixels — see docs/TPU_EXTENSIONS.md)"
                )
            if tile_overlap < 0 or min(hw) <= 2 * int(tile_overlap):
                raise ValueError(
                    f"tile {hw} must exceed 2*tile_overlap "
                    f"({2 * int(tile_overlap)}) and tile_overlap must be >= 0"
                )
            if parallel or mesh is not None:
                raise ValueError(
                    "tile is a single-device serving strategy; unset parallel/mesh "
                    "(scale tiled serving by devices via tools/batch_infer)"
                )
            if pad_h:
                raise ValueError("tile replaces pad_h; enable only one")
            self._tile, self._tile_overlap = (int(hw[0]), int(hw[1])), int(tile_overlap)
        else:
            self._tile = self._tile_overlap = None
        self.device = torch.device(device)
        self.mesh = mesh
        #: edge-extend heights the spatial size does not divide (a no-op
        #: without a spatial axis)
        self.pad_h = bool(pad_h)
        if net is not None and mesh is not None:
            shard_spatially(net, mesh.spatial_axis)
        self.telemetry = bool(telemetry)
        self.telemetry_warn_frac = float(telemetry_warn_frac)
        #: the run's per-site aggregate of the items' telemetry summaries
        self.telemetry_summary: dict = {}
        #: 0 = off; else the time axis is padded to multiples of it
        self.t_bucket = int(t_bucket or 0)
        self.compute_dtype = casting.resolve_dtype(compute_dtype)
        common.accept_aot_cache(aot_cache)
        # seam probes cost up to 4 extra window forwards an item: "first"
        # probes the first item of each distinct input (H, W), True every
        # item, False none
        if seam_stats not in (True, False, "first"):
            raise ValueError(f"seam_stats must be True, False or 'first'; got {seam_stats!r}")
        self.seam_stats = seam_stats
        self._seam_probed_shapes: set = set()
        #: run maximum of the seam rms / max in gray levels, and its item count
        self.seam_summary: dict = {}
        self.test_dataloader = test_dataloader
        self.net = net
        self.loss_fns = list(loss_fns or [])
        self.loss_weights = np.asarray(
            loss_weights if loss_weights is not None else [1.0] * len(self.loss_fns), np.float32
        )
        self.metric_fns = list(metric_fns or [])
        if test_dataloader is not None and test_dataloader.batch_size != 1:
            raise ValueError(
                f"The testing batch size should be 1. Got {test_dataloader.batch_size}."
            )
        if exported or export_nifti:
            self.saved_dir = Path(saved_dir)
        self.exported = exported
        self.export_nifti = bool(export_nifti)
        if dataset_stats:
            self.dataset_stats = dataset_stats
        self.mean, self.std = get_stats(self.dataset_stats)
        self.log = None
        self.throughput = {"frames_per_sec": 0.0, "frames": 0}
        #: wall seconds of each item, from its batch on the host to its
        #: scores and display frames back on the host (double-buffered, this
        #: spans the next item's launch)
        self.item_seconds: list[float] = []

    # ------------------------------------------------------------- workload
    def _model_inputs(self, batch) -> tuple:
        raise NotImplementedError

    def _targets(self, batch):
        raise NotImplementedError

    def _select_output(self, outputs):
        return outputs

    def _bucket_batch(self, batch):
        """Hook: pad the batch's time axis to the bucket length → (batch,
        true T or None); fixed-shape workloads never bucket."""
        return batch, None

    def _pad_spatial(self, batch):
        """``pad_h``: edge-extend the height of the batch's image arrays to
        the next multiple of the spatial size → (batch, true HR height or
        None); the step crops the output and the target back to it (the
        JAX package's ``_pad_spatial``)."""
        sp = self.mesh.spatial if self.mesh is not None else 1
        if not self.pad_h or sp <= 1:
            return batch, None
        true_h = int(np.shape(self._targets(batch))[-3])
        new, padded = dict(batch), False
        for key, value in batch.items():
            if np.ndim(value) < 4 or not _spatial_key(key):
                continue
            extended = pad_height_to_multiple(value, sp)
            if extended.shape != np.shape(value):
                new[key], padded = extended, True
        return (new, true_h) if padded else (batch, None)

    def _shard_rows(self, inputs) -> tuple[list, object]:
        """Under a spatial axis: this rank's rows of the image inputs, with
        the net's halo axis on → (inputs, axis); the whole inputs with it
        off when the spatial size does not divide the height (warned)."""
        rows, axis = spatial_step(self.net, np.shape(inputs[0]), self.mesh)
        if rows is None:
            return list(inputs), None
        return [take_rows(x, rows) if np.ndim(x) >= 4 else x for x in inputs], axis

    def _frame_losses(self, out, target):
        raise NotImplementedError

    def _frame_metrics(self, out, target, masks):
        raise NotImplementedError

    def _metric_masks(self, name: str, spatial_shape) -> tuple:
        """Per-metric device masks for Cardiac metrics (None elsewhere)."""
        return tuple(
            upload(fn.mask_for(name, spatial_shape), self.device)
            if getattr(fn, "requires_name", False) else None
            for fn in self.metric_fns
        )

    def _item_meta(self, index: int):
        """(patient, sid, filename) parsed from the dataset path
        (reference ``acdc_sisr_predictor.py:57-59``)."""
        lr_path = self.test_dataloader.dataset.data[index][0]
        filename = lr_path.parts[-1].split(".")[0]
        parts = filename.split("_")
        return parts[0], parts[2], filename

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return upload(np.ascontiguousarray(x), self.device)

    def _forward(self, *inputs, state=None):
        """The net in the compute dtype → the scored output, in fp32;
        ``state`` is the item's cast weights (``casting.cast_state``)."""
        return self._select_output(
            casting.forward_in(self.net, self.compute_dtype, *inputs, state=state))

    def _want_seam(self, inputs) -> bool:
        """Whether this item runs the seam probes (``seam_stats``): with
        "first", the first item of each distinct input (H, W), since the
        tile plan and so the seams are a function of that shape."""
        if self.seam_stats is True:
            return True
        if not self.seam_stats:
            return False
        hw = next((tuple(a.shape[-3:-1]) for a in inputs if a.dim() >= 4), None)
        if hw is None or hw in self._seam_probed_shapes:
            return False
        self._seam_probed_shapes.add(hw)
        return True

    # --------------------------------------------------------------- engine
    @torch.inference_mode()
    def _step(self, batch, masks):
        """Launch one item on the device → (total, losses (T, n_loss),
        metrics (T, n_metric), uint8 display frames when exporting, seam
        stats of a tiled item that ran the probes, the item's telemetry
        collector), every tensor still on the device; ``Fetch`` brings
        them to the host."""
        batch, out_h = self._pad_spatial(batch)
        inputs, axis = self._shard_rows(self._model_inputs(batch))
        inputs = [self._to_device(x) for x in inputs]
        target = self._to_device(self._targets(batch))
        seam = None
        state = casting.cast_state(self.net, self.compute_dtype)  # once for all windows
        collector = tel.Collector()

        def forward(*window):
            return self._forward(*window, state=state)

        def probe(*window):
            # a seam probe re-covers samples the windows counted: unrecorded
            with collector.pause():
                return forward(*window)

        with tel.collect(self.net, collector) if self.telemetry else contextlib.nullcontext():
            if self._tile is None:
                out = forward(*inputs)
            elif self._want_seam(inputs):
                out, seam = tiled_apply(forward, inputs, self._tile, self._tile_overlap,
                                        seam_stats=True, probe_fn=probe)
            else:
                out = tiled_apply(forward, inputs, self._tile, self._tile_overlap)
        # contiguous whichever path made it (a gather, a resize's permuted
        # view): the losses and metrics then reduce in one order
        out = gather_rows(out, axis).contiguous()
        if out_h is not None:  # pad_h: only the true rows are scored
            out, target = out[..., :out_h, :, :], target[..., :out_h, :, :]
        losses = self._frame_losses(out, target)
        weights = self._to_device(self.loss_weights)
        total = torch.sum(losses.mean(dim=0) * weights)
        out_d = common.denorm_uint8(out, self.mean, self.std)
        tgt_d = common.denorm_uint8(target, self.mean, self.std)
        metrics = self._frame_metrics(out_d, tgt_d, masks)
        frames = out_d.to(torch.uint8) if self.exported or self.export_nifti else None
        return total, losses, metrics, frames, seam, collector

    def predict(self):
        self.net.to(self.device).eval()
        log, count, frames = common.init_log(self.loss_fns, self.metric_fns), 0, 0
        results = None
        if self.exported:
            header = (
                ["name"]
                + [fn.name for fn in self.metric_fns]
                + [fn.name for fn in self.loss_fns]
            )
            results = [header]
        self.item_seconds = []
        self.seam_summary = {}
        split = self.mesh is not None and self.mesh.size > 1
        if split:  # one spatial group an item
            sp = self.mesh.spatial
            self.test_dataloader.set_item_shard(self.mesh.rank // sp, self.mesh.size // sp)
        # under a split: this group's items (its first rank's), folded by the lead
        fetched = []

        def finish(item):
            """Fetch one launched item (blocks on its event only); fold it
            into the log and the exports, in launch order, or keep it for
            the lead."""
            t_item, index, true_T, patient, sid, filename, fetch, seam, sites = item
            got = fetch.wait()
            self.item_seconds.append(time.perf_counter() - t_item)
            record = (index, true_T, patient, sid, filename, got, seam, sites)
            if split:
                if self.mesh.spatial_index == 0:
                    fetched.append(record)
            else:
                fold(record)

        def fold(record):
            nonlocal frames, count
            _, true_T, patient, sid, filename, got, seam, sites = record
            total, losses, metrics, out_d = got["total"], got["losses"], got["metrics"], got["frames"]
            # {} when nothing was recorded
            summary = tel.summarize(dict(zip(sites, torch.from_numpy(got["triples"])))) \
                if sites else {}
            if summary:
                # warn per item (one patient leaving the window is the
                # actionable event); aggregate for the run's line
                tel.check(summary, self.telemetry_warn_frac, context=filename)
                tel.merge_summaries(self.telemetry_summary, summary)
            if seam:
                self._log_seam(filename, seam)
            if true_T is not None:  # slice the wrapped frames back off
                losses, metrics = losses[:true_T], metrics[:true_T]
                if out_d is not None:
                    out_d = out_d[:, :true_T]
                total = losses.mean(axis=0) @ self.loss_weights
            T = losses.shape[0]
            frames += T
            if self.exported:
                self._export_item(results, filename, patient, sid, losses, metrics, out_d)
            if self.export_nifti:
                self._export_nifti_item(patient, sid, out_d)
            weight = self.test_dataloader.batch_size * T
            log["Loss"] += float(total) * weight
            for fn, col in zip(self.loss_fns, losses.mean(axis=0)):
                log[fn.name] += float(col) * weight
            for fn, col in zip(self.metric_fns, metrics.mean(axis=0)):
                log[fn.name] += float(col) * weight
            count += weight

        # EVSR_EAGER_EVAL=1: fetch each item before the next is launched
        pipe = DoubleBuffer(finish, eager=os.environ.get("EVSR_EAGER_EVAL") == "1")
        t0 = time.perf_counter()
        for batch in self.test_dataloader:
            t_item = time.perf_counter()
            index = int(batch["index"][0])
            patient, sid, filename = self._item_meta(index)
            batch, true_T = self._bucket_batch(batch)
            # bucketing pads time only: the masks see the true (H, W)
            masks = self._metric_masks(patient, np.shape(self._targets(batch))[-3:-1])
            total, losses, metrics, out_d, seam, collector = self._step(batch, masks)
            pipe.push((t_item, index, true_T, patient, sid, filename,
                       _fetch_item(total, losses, metrics, out_d, collector), seam,
                       list(collector.triples)))
        pipe.drain()
        lead = not split or self.mesh.is_lead
        if split:
            everyone = [None] * self.mesh.size if lead else None
            dist.gather_object(fetched, everyone, dst=0, group=self.mesh.host_group)
            if lead:
                for record in sorted((r for part in everyone for r in part), key=lambda r: r[0]):
                    fold(record)
        elapsed = max(time.perf_counter() - t0, 1e-9)
        self.throughput = {"frames_per_sec": frames / elapsed, "frames": frames}
        if self.exported and lead:
            self._finish_export(results)
        if self.export_nifti and lead:
            self._finish_nifti()
        for key in log:
            log[key] /= max(count, 1)
        if split:  # every rank returns the lead's log
            shared = [log]
            dist.broadcast_object_list(shared, src=0, group=self.mesh.host_group)
            log = shared[0]
        if self.telemetry_summary:
            LOG.info("Windowed-op telemetry: %s.", tel.format_summary(self.telemetry_summary))
        if self.seam_summary:
            LOG.info(
                "Tile seam (run max over %d items): rms=%.4f max=%.3f display units.",
                self.seam_summary["items"], self.seam_summary["max_rms"],
                self.seam_summary["max_abs"],
            )
        if lead:
            LOG.info(f"Test log: {log}.")
        self.log = log
        return log

    def _log_seam(self, filename, seam):
        """The seam probes' disagreement in display units (the denorm is
        linear: × std), per item and as the run maximum."""
        rms_d = seam["rms"] * float(np.mean(self.std))
        max_d = seam["max_abs"] * float(np.mean(self.std))
        s = self.seam_summary
        s["max_rms"] = max(s.get("max_rms", 0.0), rms_d)
        s["max_abs"] = max(s.get("max_abs", 0.0), max_d)
        s["items"] = s.get("items", 0) + 1
        LOG.info(f"tile seam [{filename}]: rms={rms_d:.4f} max={max_d:.3f} "
                 f"(display units, {seam['n_probes']} boundary probes)")

    def _export_item(self, results, filename, patient, sid, losses, metrics, out_d):
        raise NotImplementedError

    def _export_nifti_item(self, patient, sid, out_d):
        """Whole-sequence items (the video family): the (1, T, H, W, 1) SR
        display frames in the source trees' (H, W, 1, T) layout, one file a
        sequence (the JAX package's ``_export_nifti_item``)."""
        sr = np.transpose(out_d[0].astype(np.float32), (1, 2, 3, 0))
        nifti.save(sr, _nifti_path(self.saved_dir, patient, sid))

    def _finish_nifti(self):
        pass

    def _finish_export(self, results):
        with open(self.saved_dir / "results.csv", "w", newline="") as f:
            csv.writer(f).writerows(results)

    def load(self, path):
        """Restore net weights only (reference ``base_predictor.py:130-136``)
        from a ``.pth`` or a JAX package checkpoint."""
        self.net.load_state_dict(ckpt_io.load_net_state_dict(path, type(self.net).__name__),
                                 strict=True)


class SISRPredictor(BasePredictor):
    """One frame an item (reference ``acdc_sisr_predictor.py:15-157``): a CSV
    row and a PNG per frame, a GIF per (patient, slice) assembled across
    consecutive items.  The assembly relies on the loader yielding the
    unshuffled items in order, which ``data/loader.py`` keeps with any
    number of workers."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._gif_buffer: list = []
        self._gif_key = None
        self._nifti_buffer: list = []
        self._nifti_key = None

    def _model_inputs(self, batch):
        return (batch["lr_img"],)

    def _targets(self, batch):
        return batch["hr_img"]

    def _item_meta(self, index):
        """(patient, sid, filename) of ``<patient>_2d_sliceNN_frameMM``."""
        filename = self.test_dataloader.dataset.data[index][0].parts[-1].split(".")[0]
        patient, _, sid, _ = filename.split("_")
        return patient, sid, filename

    def _frame_losses(self, out, target):
        # out/target: (1, H, W, C) → one row (1, n_loss)
        return torch.stack([fn(out, target) for fn in self.loss_fns])[None]

    def _frame_metrics(self, out, target, masks):
        cols = [fn.per_sample(out, target, mask).mean()
                for fn, mask in zip(self.metric_fns, masks)]
        return torch.stack(cols)[None]

    def _export_item(self, results, filename, patient, sid, losses, metrics, out_d):
        results.append([filename, *metrics.mean(axis=0), *losses.mean(axis=0)])
        sr = out_d[0, ..., 0]  # (H, W) uint8
        key = (patient, sid)
        if self._gif_buffer and key != self._gif_key:
            self._flush_gif()
        self._gif_buffer.append(sr)
        self._gif_key = key
        imgs_dir = self.saved_dir / "imgs" / patient
        imgs_dir.mkdir(parents=True, exist_ok=True)
        # MISR sids come from 2d+1d names ('sequenceNN'), its PNGs are named
        # by slice (reference acdc_misr_predictor.py:91); a no-op for SISR
        imgio.write_png(imgs_dir / f"{sid.replace('sequence', 'slice')}_{filename.split('_')[-1]}.png",
                    sr)

    def _flush_gif(self):
        patient, sid = self._gif_key
        videos_dir = self.saved_dir / "videos" / patient
        videos_dir.mkdir(parents=True, exist_ok=True)
        imgio.write_gif(videos_dir / f"{sid.replace('slice', 'sequence')}.gif", self._gif_buffer)
        self._gif_buffer = []

    def _export_nifti_item(self, patient, sid, out_d):
        """Frame items: buffered per (patient, slice) in item order (the
        loader keeps the unshuffled order, as the GIF assembly relies on)
        and written as one (H, W, 1, T) volume when the key changes."""
        key = (patient, sid)
        if self._nifti_buffer and key != self._nifti_key:
            self._flush_nifti()
        self._nifti_buffer.append(out_d[0].astype(np.float32))
        self._nifti_key = key

    def _flush_nifti(self):
        patient, sid = self._nifti_key
        nifti.save(np.stack(self._nifti_buffer, axis=-1), _nifti_path(self.saved_dir, patient, sid))
        self._nifti_buffer = []

    def _finish_nifti(self):
        if self._nifti_buffer:
            self._flush_nifti()

    def _finish_export(self, results):
        if self._gif_buffer:
            self._flush_gif()
        super()._finish_export(results)


class SISRSRFBPredictor(SISRPredictor):
    """SRFB feedback nets: the last step's output is scored
    (reference ``acdc_sisr_srfb_predictor.py``)."""

    def _select_output(self, outputs):
        return outputs[-1]


class MISRPredictor(SISRPredictor):
    """A window in, its reference frame out (reference
    ``acdc_misr_predictor.py``): rows, PNGs and GIFs as for single frames,
    named ``<patient>_2d_sliceNN_frameMM`` after the window's frame."""

    def _model_inputs(self, batch):
        return (batch["lr_imgs"],)

    def _item_meta(self, index):
        """(patient, sid, filename) from the ``videos/`` tree's
        ``(lr_path, hr_path, t)``: sid is the sequence's ``sequenceNN``."""
        lr_path, _, t = self.test_dataloader.dataset.data[index]
        filename = lr_path.parts[-1].split(".")[0]
        patient, _, sid = filename.split("_")
        name = filename.replace("2d+1d", "2d").replace("sequence", "slice")
        return patient, sid, f"{name}_frame{t + 1:0>2d}"


class VSRPredictor(BasePredictor):
    """Whole-sequence eval: per-frame (T, #) losses/metrics, GIF + PNG export
    (reference ``acdc_vsr_predictor.py:15-180``)."""

    def _model_inputs(self, batch):
        return (batch["lr_imgs"],)

    def _targets(self, batch):
        return batch["hr_imgs"]

    def _bucket_batch(self, batch):
        """Extend the cardiac cycle circularly to the next multiple of
        ``t_bucket`` (the JAX package's ``VSRPredictor._bucket_batch``).

        The sequences are periodic cycles, so the pad frames are real
        wrapped frames: core' = cycle[t mod T], and the trailing warm-up
        margin is rebuilt to follow the extended core.
        """
        tb = self.t_bucket
        if not tb:
            return batch, None
        hr = np.asarray(batch["hr_imgs"])
        T = hr.shape[1]
        Tb = -(-T // tb) * tb
        if Tb == T:
            return batch, None
        lr = np.asarray(batch["lr_imgs"])
        U = (lr.shape[1] - T) // 2  # warm-up margin (0 for plain VSR)
        idx = np.arange(Tb) % T
        back = np.arange(Tb, Tb + U) % T
        new = dict(batch)
        new["hr_imgs"] = hr[:, idx]
        core = lr[:, U : U + T]
        new["lr_imgs"] = np.concatenate([lr[:, :U], core[:, idx], core[:, back]], axis=1)
        if "pos_code" in batch:
            pos = np.asarray(batch["pos_code"])
            pcore = pos[:, U : U + T]
            new["pos_code"] = np.concatenate([pos[:, :U], pcore[:, idx], pcore[:, back]], axis=1)
        return new, T

    def _frame_losses(self, out, target):
        # out/target: (B, T, H, W, C) → per-frame loss columns (T, n_loss)
        return torch.stack([fn(out, target, dim=(0, 2, 3, 4)) for fn in self.loss_fns], dim=1)

    def _frame_metrics(self, out, target, masks):
        # each frame is scored as a batch of B images and averaged over B,
        # like the JAX package's vmap of the metric over time
        B, T = out.shape[:2]
        o = out.transpose(0, 1).reshape(T * B, *out.shape[2:])
        t = target.transpose(0, 1).reshape(T * B, *target.shape[2:])
        cols = [fn.per_sample(o, t, mask).view(T, B).mean(dim=1)
                for fn, mask in zip(self.metric_fns, masks)]
        return torch.stack(cols, dim=1)

    def _export_item(self, results, filename, patient, sid, losses, metrics, out_d):
        T = losses.shape[0]
        base = filename.replace("2d+1d", "2d").replace("sequence", "slice")
        for t in range(T):
            results.append([f"{base}_frame{t+1:0>2d}", *metrics[t], *losses[t]])
        sr_imgs = out_d[0, ..., 0]  # (T, H, W) uint8
        videos_dir = self.saved_dir / "videos" / patient
        videos_dir.mkdir(parents=True, exist_ok=True)
        imgio.write_gif(videos_dir / f"{sid}.gif", list(sr_imgs))
        imgs_dir = self.saved_dir / "imgs" / patient
        imgs_dir.mkdir(parents=True, exist_ok=True)
        for t, sr in enumerate(sr_imgs):
            imgio.write_png(imgs_dir / f"{sid.replace('sequence', 'slice')}_frame{t+1:0>2d}.png", sr)


class FRVSRPredictor(VSRPredictor):
    """FRVSR returns (SR frames, warped LR frames) unless ``is_prediction``:
    the SR frames are scored."""

    def _select_output(self, outputs):
        return outputs[0] if isinstance(outputs, (tuple, list)) else outputs


class VSRRefineNetPredictor(VSRPredictor):
    """Feeds (lr, pos_code), evaluates the final fused stage ``outputs[-1]``
    (reference ``acdc_vsr_refinenet_predictor.py:15-183``)."""

    def _model_inputs(self, batch):
        return (batch["lr_imgs"], batch["pos_code"])

    def _select_output(self, outputs):
        return outputs[-1]


for _workload, _cls in (("SISR", SISRPredictor), ("SISRSRFB", SISRSRFBPredictor),
                       ("MISR", MISRPredictor), ("VSR", VSRPredictor),
                       ("VSRRefineNet", VSRRefineNetPredictor), ("FRVSR", FRVSRPredictor)):
    common.register_dataset_variants(PREDICTORS, _workload, "Predictor", _cls)
