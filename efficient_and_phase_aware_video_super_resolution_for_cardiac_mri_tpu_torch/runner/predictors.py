"""Predictors: test-time evaluation and export.

The port's counterpart of the JAX package's ``runner/predictors.py`` for the
RefineNet eval path.  The contract is the reference's: batch size 1,
per-frame loss/metric tables, Cardiac* metrics routed with the patient name
parsed from the dataset path, CSV / GIF / PNG export, and the log weighted
by sequence length.

The forward runs eagerly under ``torch.inference_mode()`` on the predictor's
device; each item's scores and display frames come back to the host once.
The JAX package's TPU serving knobs are not ported yet: a config that sets
one of them to anything but its default raises ``NotImplementedError``.
"""
from __future__ import annotations

import csv
import logging
import time
from pathlib import Path

import numpy as np
import torch

from ..config import PREDICTORS
from ..utils.stats import get_stats
from . import checkpoint as ckpt_io
from . import common

LOG = logging.getLogger(__name__)

#: serving knobs of the JAX package that this port does not implement yet,
#: with the default a config may leave them at
DEFERRED_KNOBS = {
    "tile": None,
    "tile_overlap": None,
    "t_bucket": 0,
    "pad_h": False,
    "compute_dtype": None,
    "aot_cache": None,
    "export_nifti": False,
    "telemetry_warn_frac": 0.0,
    "seam_stats": "first",
}


def _dump_video(path, imgs):
    import imageio

    with imageio.get_writer(path) as writer:
        for img in imgs:
            writer.append_data(img)


def _dump_image(path, img):
    import imageio

    imageio.imwrite(path, img)


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
        dataset_stats: str | None = None,
        telemetry: bool = True,
        **knobs,
    ):
        for knob, value in knobs.items():
            if knob not in DEFERRED_KNOBS:
                raise TypeError(f"{type(self).__name__} got an unexpected keyword argument {knob!r}")
            default = DEFERRED_KNOBS[knob]
            if value != default and (value or default):
                raise NotImplementedError(
                    f"predictor knob {knob}={value!r} is not implemented in the PyTorch port yet"
                )
        # ``telemetry`` reports windowed ops (max_flow / dcn_max_offset);
        # RefineNet has none, so the knob is accepted and does nothing
        self.device = torch.device(device)
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
        if exported:
            self.saved_dir = Path(saved_dir)
        self.exported = exported
        if dataset_stats:
            self.dataset_stats = dataset_stats
        self.mean, self.std = get_stats(self.dataset_stats)
        self.log = None
        self.throughput = {"frames_per_sec": 0.0, "frames": 0}
        #: wall seconds of each item, from its batch on the host to its
        #: scores and display frames back on the host
        self.item_seconds: list[float] = []

    # ------------------------------------------------------------- workload
    def _model_inputs(self, batch) -> tuple:
        raise NotImplementedError

    def _targets(self, batch):
        raise NotImplementedError

    def _select_output(self, outputs):
        return outputs

    def _frame_losses(self, out, target):
        raise NotImplementedError

    def _frame_metrics(self, out, target, masks):
        raise NotImplementedError

    def _metric_masks(self, name: str, spatial_shape) -> tuple:
        """Per-metric device masks for Cardiac metrics (None elsewhere)."""
        return tuple(
            torch.from_numpy(fn.mask_for(name, spatial_shape)).to(self.device)
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
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # --------------------------------------------------------------- engine
    @torch.inference_mode()
    def _step(self, batch, masks):
        """One item on the device → host (total, losses (T, n_loss),
        metrics (T, n_metric), uint8 display frames when exporting)."""
        inputs = [self._to_device(x) for x in self._model_inputs(batch)]
        target = self._to_device(self._targets(batch))
        out = self._select_output(self.net(*inputs))
        losses = self._frame_losses(out, target)
        weights = torch.from_numpy(self.loss_weights).to(self.device)
        total = torch.sum(losses.mean(dim=0) * weights)
        out_d = common.denorm_uint8(out, self.mean, self.std)
        tgt_d = common.denorm_uint8(target, self.mean, self.std)
        metrics = self._frame_metrics(out_d, tgt_d, masks)
        frames = out_d.to(torch.uint8).cpu().numpy() if self.exported else None
        return float(total), losses.cpu().numpy(), metrics.cpu().numpy(), frames

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
        t0 = time.perf_counter()
        for batch in self.test_dataloader:
            t_item = time.perf_counter()
            index = int(batch["index"][0])
            patient, sid, filename = self._item_meta(index)
            masks = self._metric_masks(patient, np.shape(self._targets(batch))[-3:-1])
            total, losses, metrics, out_d = self._step(batch, masks)
            self.item_seconds.append(time.perf_counter() - t_item)
            T = losses.shape[0]
            frames += T
            if self.exported:
                self._export_item(results, filename, patient, sid, losses, metrics, out_d)
            weight = self.test_dataloader.batch_size * T
            log["Loss"] += total * weight
            for fn, col in zip(self.loss_fns, losses.mean(axis=0)):
                log[fn.name] += float(col) * weight
            for fn, col in zip(self.metric_fns, metrics.mean(axis=0)):
                log[fn.name] += float(col) * weight
            count += weight
        elapsed = max(time.perf_counter() - t0, 1e-9)
        self.throughput = {"frames_per_sec": frames / elapsed, "frames": frames}
        if self.exported:
            self._finish_export(results)
        for key in log:
            log[key] /= max(count, 1)
        LOG.info(f"Test log: {log}.")
        self.log = log
        return log

    def _export_item(self, results, filename, patient, sid, losses, metrics, out_d):
        raise NotImplementedError

    def _finish_export(self, results):
        with open(self.saved_dir / "results.csv", "w", newline="") as f:
            csv.writer(f).writerows(results)

    def load(self, path):
        """Restore net weights only (reference ``base_predictor.py:130-136``)
        from a ``.pth`` or a JAX package checkpoint."""
        self.net.load_state_dict(ckpt_io.load_net_state_dict(path), strict=True)


class VSRPredictor(BasePredictor):
    """Whole-sequence eval: per-frame (T, #) losses/metrics, GIF + PNG export
    (reference ``acdc_vsr_predictor.py:15-180``)."""

    def _model_inputs(self, batch):
        return (batch["lr_imgs"],)

    def _targets(self, batch):
        return batch["hr_imgs"]

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
        _dump_video(videos_dir / f"{sid}.gif", list(sr_imgs))
        imgs_dir = self.saved_dir / "imgs" / patient
        imgs_dir.mkdir(parents=True, exist_ok=True)
        for t, sr in enumerate(sr_imgs):
            _dump_image(imgs_dir / f"{sid.replace('sequence', 'slice')}_frame{t+1:0>2d}.png", sr)


class VSRRefineNetPredictor(VSRPredictor):
    """Feeds (lr, pos_code), evaluates the final fused stage ``outputs[-1]``
    (reference ``acdc_vsr_refinenet_predictor.py:15-183``)."""

    def _model_inputs(self, batch):
        return (batch["lr_imgs"], batch["pos_code"])

    def _select_output(self, outputs):
        return outputs[-1]


common.register_dataset_variants(PREDICTORS, "VSRRefineNet", "Predictor", VSRRefineNetPredictor)
