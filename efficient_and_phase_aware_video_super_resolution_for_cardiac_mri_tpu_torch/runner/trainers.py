"""Trainers: the epoch and step engine (reference ``src/runner/trainers/*``).

The port's counterpart of the JAX package's ``runner/trainers.py`` for the
RefineNet path, the single-image family (SISR, SISRSRFB), the multi-frame
family (MISR) and the plain video family (VSR, FRVSR).  The epoch
protocol is the JAX package's, statement for statement
(``base_trainer.py:46-97``): per-epoch numpy reseed and
``loader.set_epoch``, train epoch → valid epoch → lr step → logger →
monitor save / best / early stop, the log weighted by the configured batch
size × T (quirk 8, kept for parity), SIGTERM preemption, and the epoch and
wall-clock self-preemption budgets.

A train step runs eagerly on the trainer's device: forward, the weighted
losses, ``backward``, the optimizer update.  The valid epoch runs under
``torch.inference_mode()``, so no autograd graph of a whole clip is kept.
The epoch's loss and metric sums stay on the device and come to the host
once, at the end of the epoch (``.item()`` per step would stall the card
every step), as the JAX package's accumulators do.

The JAX package's trainer knobs, each computing what it computes there:

* ``compute_dtype`` (``bfloat16``): the forward and backward run on bf16
  copies of the fp32 parameters and buffers made inside the autograd graph
  (``utils/casting.forward_in``); parameters, Adam state, losses and
  metrics stay fp32.  A training forward's BatchNorm updates land in the
  bf16 copies of its running statistics and are carried back into the fp32
  buffers after the step, as the JAX package carries its bf16
  ``batch_stats`` updates back as fp32 masters.
* ``grad_accum_steps`` A: the batch splits into A equal microbatches whose
  gradients are summed, then scaled by 1/A before one optimizer step; the
  logged values are the microbatches' mean, the display outputs the whole
  batch.
* ``int_feed``: the datasets' explicit-stats ``Normalize`` moves to the
  device; image arrays travel as uint8/int16 where that is lossless (as
  bf16 for a fractional LR under bf16 compute) and are normalized there.
* ``aot_cache``: accepted and logged; the port compiles nothing per shape.
* ``telemetry`` / ``telemetry_warn_frac``: every valid epoch collects the
  windowed call sites' exceedance triples (``ops/telemetry.py``; nets
  without ``max_flow`` or ``dcn_max_offset`` record none), fetches them
  once at the epoch's end,
  logs ``Windowed-op telemetry (valid epoch N)`` and warns for a site whose
  out-of-window fraction exceeds ``telemetry_warn_frac``.  The train step
  never collects.

* ``checkpoint_backend``: ``pickle`` (the default) writes the reference's
  ``.pth``; ``orbax`` / ``orbax_async`` write ``torch.distributed.checkpoint``
  directories synchronously or in the background (``runner/checkpoint.py``),
  waited for at the end of the run.

With ``EVSR_PROFILE_DIR`` set, each train and valid epoch is traced by
``torch.profiler`` into ``EVSR_PROFILE_DIR/train_epoch_<N>`` and
``valid_epoch_<N>`` (``utils/profiling.trace``), as in the JAX package.

With a ``mesh`` (``parallel/mesh.py``) the step runs on the module
``parallel.partition`` gives: DDP over the data ranks, or FSDP2 (ZeRO-3)
for a model axis.  The loaders yield each rank's slice of the global
batch; BatchNorm reduces over the ranks holding the step's other items
and rows (``Mesh.statistics_group``);
``grad_accum_steps`` syncs the gradients on the last microbatch only
(``no_sync`` / ``set_requires_gradient_sync``); the epoch's logged sums
are averaged over the data ranks before the log, the monitor and the
scheduler see them, so every rank takes the same decisions.  The lead rank
alone writes the logger's events and the ``.pth`` (gathered whole first
under a model axis); a directory checkpoint is written by every rank.
``skip_nonfinite`` is checked at each epoch boundary, after the train log,
as in the JAX package (``runner/optim.py``).

Under a spatial axis (the nets whose class declares ``spatial_ready``) the
ranks of a spatial group take the same items, and each feeds the net its
rows of the image arrays (LR and HR; the phase code goes whole): the
net's convs exchange their halos (``parallel/halo.py``) and each rank's
losses are over its rows.  DDP averages the gradients over every rank, the
halos' backward having returned each borrowed row's gradient to its
owner; with equal shards the mean of the ranks' local means is the global
mean.  A training BatchNorm reduces over the ranks holding the step's
other rows and items (``Mesh.statistics_group``).  The metrics and the
display see the outputs and targets gathered whole; the logged values are
averaged over every rank.  A height the spatial size does not divide is
computed whole on every rank of the group (warned once).
"""
from __future__ import annotations

import contextlib
import logging
import signal
import time

import numpy as np
import torch

from .. import parallel
from ..config import TRAINERS
from ..models.common import batch_norm_group
from ..ops import telemetry as tel
from ..parallel.mesh import _spatial_key
from ..utils import casting
from ..utils.profiling import trace
from ..utils.seeding import SeedState, seed_everything
from ..utils.stats import get_stats
from . import checkpoint as ckpt_io
from . import common

LOG = logging.getLogger(__name__)

CHECKPOINT_BACKENDS = ("pickle", "orbax", "orbax_async")


class BaseTrainer:
    """Config surface mirrors the reference BaseTrainer kwargs."""

    #: dataset whose stats denormalize metric inputs; set via registration name
    dataset_stats = "acdc"

    def __init__(
        self,
        device: torch.device | str = "cuda",
        train_dataloader=None,
        valid_dataloader=None,
        net=None,
        loss_fns=None,
        loss_weights=None,
        metric_fns=None,
        optimizer=None,
        lr_scheduler=None,
        logger=None,
        monitor=None,
        num_epochs=1,
        seed_state: SeedState | None = None,
        dataset_stats: str | None = None,
        telemetry: bool = True,
        telemetry_warn_frac: float = 0.0,
        preempt_after_epochs: int = 0,
        preempt_after_seconds: float = 0.0,
        compute_dtype: str | None = None,
        grad_accum_steps: int = 1,
        aot_cache: str | None = None,
        int_feed: bool = False,
        mesh: parallel.Mesh | None = None,
        checkpoint_backend: str = "pickle",
    ):
        if checkpoint_backend not in CHECKPOINT_BACKENDS:
            raise ValueError(
                f"checkpoint_backend must be one of {CHECKPOINT_BACKENDS}, got {checkpoint_backend!r}")
        self.checkpoint_backend = checkpoint_backend
        self.device = torch.device(device)
        self.mesh = mesh
        self.train_dataloader = train_dataloader
        self.valid_dataloader = valid_dataloader
        for loader in (train_dataloader, valid_dataloader):
            if mesh is not None and hasattr(loader, "set_mesh"):
                loader.set_mesh(mesh)
        self.compute_dtype = casting.resolve_dtype(compute_dtype)
        self.net = net.to(self.device) if net is not None else None
        #: FSDP2 computes in its own mixed-precision policy: no cast copies
        self._fsdp = mesh is not None and mesh.model > 1
        #: the module the step calls (the net, its DDP wrapper, or the net
        #: sharded in place by FSDP2)
        self.model = parallel.partition(self.net, mesh, self.compute_dtype) \
            if self.net is not None else None
        self.loss_fns = list(loss_fns or [])
        self.loss_weights = torch.tensor(
            loss_weights if loss_weights is not None else [1.0] * len(self.loss_fns),
            dtype=torch.float32, device=self.device,
        )
        self.metric_fns = list(metric_fns or [])
        self.optimizer = optimizer
        #: the torch optimizer over the net's parameters (its state is the
        #: JAX package's ``opt_state``)
        self.opt = optimizer.init(self.net.parameters()) if optimizer is not None else None
        self.lr_scheduler = lr_scheduler
        self.logger = logger
        self.monitor = monitor
        self.num_epochs = num_epochs
        self.epoch = 1
        if dataset_stats:
            self.dataset_stats = dataset_stats
        self.mean, self.std = get_stats(self.dataset_stats)
        self.seed_state = seed_state or seed_everything("vsr", num_epochs)
        if not self.seed_state.np_random_seeds:
            self.seed_state = seed_everything(self.seed_state.seed, num_epochs)
        self.throughput = {"train_steps_per_sec": 0.0, "frames_per_sec": 0.0}
        #: per-epoch train/valid logs, in order
        self.history = {"train": [], "valid": []}
        self.telemetry = bool(telemetry)
        self.telemetry_warn_frac = float(telemetry_warn_frac)
        self.telemetry_summary: dict = {}  # run aggregate across epochs
        self.telemetry_history: list[dict] = []  # per-valid-epoch summaries
        # self-preemption budgets (SURVEY §5 failure recovery): once hit at an
        # epoch boundary, take the SIGTERM path (checkpoint
        # model_preempted.pth, clean exit); ``loaded_path: auto`` resumes.
        # 0 = off.  The seconds budget is checked after each epoch.
        self.preempt_after_epochs = int(preempt_after_epochs)
        self.preempt_after_seconds = float(preempt_after_seconds)
        self._preempt_requested = False
        self.grad_accum_steps = max(1, int(grad_accum_steps))
        common.accept_aot_cache(aot_cache)
        #: int_feed's on-device (means, std + 1e-10), or None
        self._feed_norm = None
        self.int_feed = bool(int_feed)
        if self.int_feed:
            self._resolve_int_feed()

    # ------------------------------------------------------------- workload
    def _model_inputs(self, batch) -> tuple:
        raise NotImplementedError

    def _targets(self, batch):
        raise NotImplementedError

    def _compute_losses(self, outputs, batch, training: bool) -> list:
        """The losses of ``outputs`` against the fed (device) ``batch``: by
        default each loss of the outputs against the targets."""
        target = self._targets(batch)
        return [fn(outputs, target) for fn in self.loss_fns]

    def _compute_metrics(self, outputs, target) -> list:
        raise NotImplementedError

    def _display_outputs(self, outputs):
        """Output handed to the logger (last batch only)."""
        return outputs

    def _log_weight(self, batch, mode: str) -> float:
        """Reference weighting: configured batch_size (quirk 8)."""
        loader = self.train_dataloader if mode == "training" else self.valid_dataloader
        return loader.batch_size

    def _frame_count(self, batch) -> int:
        """LR frames the batch feeds the net: B for (B, h, w, C) frames,
        B·T for (B, T, h, w, C) windows and sequences."""
        shape = np.shape(self._model_inputs(batch)[0])
        return int(shape[0] * (shape[1] if len(shape) == 5 else 1))

    def _denorm(self, x):
        return common.denorm_uint8(x, self.mean, self.std)

    # ------------------------------------------------------------- int_feed
    def _resolve_int_feed(self):
        """Move the datasets' explicit-stats Normalize to the device, if every
        dataset has one (the JAX package's ``_resolve_int_feed``)."""
        if self.mesh is not None and self.mesh.hosts > 1:
            # the JAX package's rule: a run of several hosts keeps one feed dtype
            LOG.warning(
                "int_feed disabled: the compacted feed dtype is data-dependent "
                "and multi-process traces must agree on one signature."
            )
            self.int_feed = False
            return
        datasets = [
            getattr(loader, "dataset", None)
            for loader in (self.train_dataloader, self.valid_dataloader)
            if loader is not None
        ]
        probes = [
            ds.deferrable_normalize() if hasattr(ds, "deferrable_normalize") else None
            for ds in datasets
        ]
        if not probes or any(p is None for p in probes):
            LOG.warning(
                "int_feed disabled: every dataset needs an explicit-stats "
                "Normalize transform to defer to the device."
            )
            self.int_feed = False
            return
        if any(p != probes[0] for p in probes):
            raise ValueError(f"int_feed: train/valid Normalize stats differ ({probes}).")
        means, stds = probes[0]
        for ds in datasets:
            ds.defer_normalize()
        # the host op's arithmetic: numpy adds 1e-10 to the std in float64,
        # then divides the float32 image by it as a float32 scalar
        self._feed_norm = (
            torch.tensor(np.asarray(means, np.float32), device=self.device),
            torch.tensor(np.asarray([np.float64(s) + 1e-10 for s in stds], np.float32),
                         device=self.device),
        )

    # --------------------------------------------------------------- engine
    def _wire(self, batch) -> dict:
        """The host side of the feed: each floating array as the tensor that
        travels to the device; other entries pass through.  With
        ``int_feed`` an image array (key with ``img``) travels as uint8/int16
        when that is lossless, and a fractional LR array as bf16 under bf16
        compute (the forward casts it to bf16 anyway); targets never travel
        as bf16."""
        out = {}
        bf16_wire = self.compute_dtype == torch.bfloat16
        for key, value in batch.items():
            if not (isinstance(value, np.ndarray) and value.dtype.kind == "f"):
                out[key] = value
                continue
            image = self._feed_norm is not None and "img" in key
            if image:
                value = common.compact_lossless(value)
            t = torch.from_numpy(np.ascontiguousarray(value))
            if image and bf16_wire and "lr" in key and t.dtype == torch.float32:
                t = t.to(torch.bfloat16)
            out[key] = t
        return out

    def _feed(self, batch) -> dict:
        """The batch on the device; with ``int_feed`` its image arrays are
        normalized there, in fp32."""
        out = {}
        for key, value in self._wire(batch).items():
            if isinstance(value, torch.Tensor):
                value = value.to(self.device)
                if self._feed_norm is not None and "img" in key:
                    means, divs = self._feed_norm
                    value = (value.float() - means) / divs
            out[key] = value
        return out

    @property
    def _step_dtype(self):
        """The dtype ``casting.forward_in`` runs the step in (FSDP2 casts
        by its own policy)."""
        return None if self._fsdp else self.compute_dtype

    def _shard_rows(self, batch):
        """Under a spatial axis: this rank's rows of the batch's image arrays,
        with the net's halo axis on; the whole batch with it off when the
        spatial size does not divide the LR height (warned) → (batch, axis
        or None)."""
        lr = self._model_inputs(batch)[0]
        rows, axis = parallel.spatial_step(self.net, np.shape(lr), self.mesh)
        if rows is None:
            return batch, None
        out = {}
        for key, value in batch.items():
            if isinstance(value, np.ndarray) and value.ndim >= 4 and _spatial_key(key):
                k = np.shape(value)[-3] // np.shape(lr)[-3]  # 1 for LR, the scale for HR
                value = parallel.take_rows(value, slice(rows.start * k, rows.stop * k))
            out[key] = value
        return out, axis

    @staticmethod
    def _whole(x, axis):
        """The outputs (a tensor or a list or tuple of them) or the target
        with their rows gathered whole over the spatial group."""
        if axis is None:
            return x
        if isinstance(x, (list, tuple)):
            return type(x)(BaseTrainer._whole(v, axis) for v in x)
        return parallel.gather_rows(x, axis)

    def _forward(self, batch, training: bool, state=None):
        """Forward and the weighted losses → (total, losses, outputs, target,
        spatial axis of the step or None); ``state`` is the step's cast
        weights (``casting.cast_state``).  Under a spatial axis the outputs,
        the target and the losses are this rank's rows'."""
        batch, axis = self._shard_rows(batch)
        batch = self._feed(batch)
        group = None
        if training and self.mesh is not None:
            group = self.mesh.statistics_group(getattr(self.train_dataloader, "sharded", False),
                                               axis is not None)
        with batch_norm_group(group):
            outputs = casting.forward_in(self.model, self._step_dtype,
                                         *self._model_inputs(batch), state=state)
        target = self._targets(batch)
        losses = self._compute_losses(outputs, batch, training)
        total = torch.sum(torch.stack(losses) * self.loss_weights)
        return total, losses, outputs, target, axis

    def _train_step(self, batch):
        """One optimizer step over the batch, as ``grad_accum_steps``
        microbatches → (total, losses, metrics, display outputs)."""
        accum = self.grad_accum_steps
        b = next(v for v in batch.values() if isinstance(v, np.ndarray)).shape[0]
        if b % accum:
            raise ValueError(
                f"grad_accum_steps={accum} must divide the batch size; got batch {b}. "
                "Adjust train_batch_size or drop_last."
            )
        m = b // accum
        self.opt.zero_grad(set_to_none=True)
        state = casting.cast_state(self.model, self._step_dtype)  # shared by the microbatches
        sums, displays = None, []
        for i in range(accum):
            micro = batch if accum == 1 else {
                k: v[i * m:(i + 1) * m] if isinstance(v, np.ndarray) else v
                for k, v in batch.items()
            }
            with self._gradient_sync(i == accum - 1):
                total, losses, outputs, target, axis = self._forward(micro, True, state)
                total.backward()  # sums the microbatches' gradients into .grad
            with torch.no_grad():
                outputs, target = self._whole(outputs, axis), self._whole(target, axis)
                metrics = self._compute_metrics(outputs, target)
                displays.append(self._display_outputs(outputs).detach())
            values = torch.stack([total.detach(), *[l.detach() for l in losses], *metrics])
            sums = values if sums is None else sums + values
        if state is not None:
            self._keep_buffers(state)
        if accum > 1:
            inv = 1.0 / accum
            for p in self.net.parameters():
                if p.grad is not None:
                    p.grad.mul_(inv)
            sums = sums * inv
        self.optimizer.step(self.opt)
        n = len(self.loss_fns)
        display = displays[0] if accum == 1 else torch.cat(displays)
        return sums[0], list(sums[1:1 + n]), list(sums[1 + n:]), display

    def _gradient_sync(self, sync: bool):
        """Under a mesh, the gradients of every microbatch but the last stay
        local (DDP ``no_sync``; FSDP2 ``set_requires_gradient_sync``)."""
        if self.mesh is None or sync:
            if self._fsdp:
                self.model.set_requires_gradient_sync(True)
            return contextlib.nullcontext()
        if self._fsdp:
            self.model.set_requires_gradient_sync(False)
            return contextlib.nullcontext()
        return self.model.no_sync()

    @torch.no_grad()
    def _keep_buffers(self, state: dict) -> None:
        """Copy the step's updates of the cast buffers (BatchNorm running
        statistics) back into the net's own, in their dtype."""
        for name, buf in self.model.named_buffers():
            cast = state.get(name)
            if cast is not None and cast is not buf:
                buf.copy_(cast)

    @torch.inference_mode()
    def _eval_step(self, batch):
        total, losses, outputs, target, axis = self._forward(batch, False)
        outputs, target = self._whole(outputs, axis), self._whole(target, axis)
        return total, losses, self._compute_metrics(outputs, target), self._display_outputs(outputs)

    def _run_epoch(self, mode: str):
        training = mode == "training"
        loader = self.train_dataloader if training else self.valid_dataloader
        self.net.train(training)
        count, steps, frames = 0.0, 0, 0
        batch = outputs = None
        acc = None  # [total, *losses, *metrics], weighted sums on the device
        # the valid epoch's windowed-op telemetry, merged on the device
        collector = tel.Collector()
        collecting = self.telemetry and not training
        t0 = time.perf_counter()
        with tel.collect(self.net, collector) if collecting else contextlib.nullcontext():
            for batch in loader:
                step = self._train_step if training else self._eval_step
                total, losses, metrics, outputs = step(batch)
                w = float(self._log_weight(batch, mode))
                values = torch.stack([total, *losses, *metrics]) * w
                acc = values if acc is None else acc + values
                count += w
                steps += 1
                frames += self._frame_count(batch)
        log = common.init_log(self.loss_fns, self.metric_fns)
        if acc is not None:
            # each step's values are its global batch's means: average the
            # data ranks' sums (equal slices, or the same whole batch); under
            # a spatial axis every rank's (the losses over equal bands of
            # rows, the metrics the same whole-frame values on each)
            parallel.all_reduce_mean(acc, self.mesh)
            for key, val in zip(log, acc.tolist()):  # the epoch's one fetch
                log[key] = val
        # measured after the fetch, so it includes the device's drain
        elapsed = max(time.perf_counter() - t0, 1e-9)
        if training and steps:
            self.throughput["train_steps_per_sec"] = steps / elapsed
            self.throughput["frames_per_sec"] = frames / elapsed
        for key in log:
            log[key] /= max(count, 1)
        summary = collector.summary()  # the epoch's one fetch of it; {} when none
        if summary:
            tel.check(summary, self.telemetry_warn_frac, context=f"valid epoch {self.epoch}")
            tel.merge_summaries(self.telemetry_summary, summary)
            self.telemetry_history.append(summary)
            LOG.info("Windowed-op telemetry (valid epoch %d): %s.", self.epoch,
                     tel.format_summary(summary))
        return log, batch, outputs

    def train(self):
        """Epoch protocol of reference ``base_trainer.py:46-97``.

        SIGTERM requests a checkpoint at the end of the current epoch and a
        clean exit; ``loaded_path: auto`` then resumes from it.
        """
        self._preempt_requested = False

        def _on_term(signum, frame):
            self._preempt_requested = True
            LOG.warning("SIGTERM received: checkpointing and exiting at the end of this epoch.")

        prev_handler = None
        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            pass  # not the main thread (e.g. embedded): no handler
        try:
            self._train_loop()
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def _train_loop(self):
        epochs_this_run = 0
        run_t0 = time.perf_counter()
        while self.epoch <= self.num_epochs:
            seeds = self.seed_state.np_random_seeds
            while self.epoch - 1 >= len(seeds):
                # resume trained past the original num_epochs (the reference
                # would IndexError here): extend deterministically
                seeds.append((self.seed_state.base_int + 7919 * len(seeds)) % 10000000)
            np.random.seed(seeds[self.epoch - 1] % (2**32))
            for loader in (self.train_dataloader, self.valid_dataloader):
                if hasattr(loader, "set_epoch"):
                    loader.set_epoch(seeds[self.epoch - 1])
            LOG.info(f"Epoch {self.epoch}.")
            with trace(f"train_epoch_{self.epoch}"):
                train_log, train_batch, train_outputs = self._run_epoch("training")
            LOG.info(
                f"Train log: {train_log} "
                f"({self.throughput['train_steps_per_sec']:.2f} steps/sec)."
            )
            if self.optimizer is not None and self.optimizer.skip_nonfinite:
                skipped = self.optimizer.check_nonfinite(self.opt)  # raises on divergence
                if skipped:
                    LOG.warning(f"{skipped} non-finite gradient steps skipped so far.")
            with trace(f"valid_epoch_{self.epoch}"):
                valid_log, valid_batch, valid_outputs = self._run_epoch("validation")
            LOG.info(f"Valid log: {valid_log}.")
            self.history["train"].append(dict(train_log))
            self.history["valid"].append(dict(valid_log))

            if self.lr_scheduler is not None:
                new_lr = self.lr_scheduler.step(valid_log.get("Loss"))
                self.optimizer.set_lr(self.opt, new_lr)

            if self.logger is not None and self._lead:
                self.logger.write(
                    self.epoch, train_log, train_batch, _to_numpy(train_outputs),
                    valid_log, valid_batch, _to_numpy(valid_outputs),
                )

            saved_path = self.monitor.is_saved(self.epoch) if self.monitor else None
            if saved_path:
                LOG.info(f"Save the checkpoint to {saved_path}.")
                self.save(saved_path)
            saved_path = self.monitor.is_best(valid_log) if self.monitor else None
            if saved_path:
                LOG.info(
                    f"Save the best checkpoint to {saved_path} "
                    f"({self.monitor.mode} {self.monitor.target}: {self.monitor.best})."
                )
                self.save(saved_path)

            if self.monitor and self.monitor.is_early_stopped():
                LOG.info("Early stopped.")
                break
            epochs_this_run += 1
            if self.epoch < self.num_epochs:
                if self.preempt_after_epochs and epochs_this_run >= self.preempt_after_epochs:
                    LOG.info("Epoch budget reached (%d this run): self-preempting.", epochs_this_run)
                    self._preempt_requested = True
                elif (
                    self.preempt_after_seconds
                    and time.perf_counter() - run_t0 >= self.preempt_after_seconds
                ):
                    LOG.info("Wall-clock budget reached (%.0f s this run): self-preempting.",
                             time.perf_counter() - run_t0)
                    self._preempt_requested = True
            if self._preempt_requested:
                if self.monitor:
                    path = self.monitor.checkpoints_dir / "model_preempted.pth"
                    self.save(path)
                    LOG.info(f"Preemption checkpoint saved to {path}; exiting.")
                break
            self.epoch += 1
        # commit barrier for orbax_async saves: nothing leaves the loop with
        # a checkpoint still being written (a no-op otherwise)
        ckpt_io.wait_for_async_saves()
        if self.logger is not None:
            self.logger.close()

    # ----------------------------------------------------------- checkpoint
    @property
    def _lead(self) -> bool:
        return self.mesh is None or self.mesh.is_lead

    def _param_names(self) -> list[str]:
        return [name for name, _ in self.net.named_parameters()]

    def _full_state(self) -> tuple[dict, dict | None]:
        """The net's and the optimizer's whole state in the ``.pth``
        layout (the optimizer's keyed by parameter index); under a model
        axis gathered from the shards (a collective: every rank calls)."""
        if not self._fsdp:
            opt = self.optimizer.state_dict(self.opt) if self.opt is not None else None
            return self.net.state_dict(), opt
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            get_model_state_dict,
            get_optimizer_state_dict,
        )

        # gathered to the lead alone (the other ranks get empty dicts)
        full = StateDictOptions(full_state_dict=True, cpu_offload=True)
        net_state = get_model_state_dict(self.net, options=full)
        opt = None
        if self.opt is not None:
            opt = get_optimizer_state_dict(self.net, self.opt, options=full)
            if self._lead:
                opt = _by_index(opt, self._param_names())
                if getattr(self.opt, "nonfinite", None) is not None:
                    opt["nonfinite"] = [int(v) for v in self.opt.nonfinite.tolist()]
        return net_state, opt

    def _load_full(self, net_state: dict, opt_state: dict | None) -> None:
        """Inverse of :meth:`_full_state` (every rank calls)."""
        if not self._fsdp:
            self.net.load_state_dict(net_state, strict=True)
            if self.opt is not None and opt_state is not None:
                self.optimizer.load_state_dict(self.opt, opt_state)
            return
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            set_model_state_dict,
            set_optimizer_state_dict,
        )

        full = StateDictOptions(full_state_dict=True)
        set_model_state_dict(self.net, net_state, options=full)
        if self.opt is not None and opt_state is not None:
            opt_state = dict(opt_state)
            counters = opt_state.pop("nonfinite", None)
            # the net's unused parameters have no state to load
            set_optimizer_state_dict(self.net, self.opt, _by_name(opt_state, self._param_names()),
                                     options=StateDictOptions(full_state_dict=True, strict=False))
            if counters is not None and getattr(self.opt, "nonfinite", None) is not None:
                self.opt.nonfinite.copy_(torch.tensor(counters, dtype=torch.int64))

    def save(self, path):
        """Every rank calls; ``pickle`` is written by the lead alone."""
        meta = {"lr_scheduler": self.lr_scheduler.state_dict() if self.lr_scheduler else None,
                "monitor": self.monitor.state_dict() if self.monitor else None,
                "epoch": self.epoch, "seed_state": self.seed_state.state_dict()}
        if self.checkpoint_backend == "pickle":
            net_state, opt_state = self._full_state()
            if self._lead:
                ckpt_io.save_checkpoint(
                    path, net_state=net_state, optimizer_state=opt_state,
                    lr_scheduler_state=meta["lr_scheduler"], monitor_state=meta["monitor"],
                    epoch=meta["epoch"], seed_state=meta["seed_state"])
            return
        from torch.distributed.checkpoint.state_dict import get_state_dict

        arrays = {"net": self.net.state_dict()}
        if self.opt is not None:
            arrays["net"], arrays["optimizer"] = get_state_dict(self.net, self.opt)
            if getattr(self.opt, "nonfinite", None) is not None:
                meta["nonfinite"] = [int(v) for v in self.opt.nonfinite.tolist()]
        barrier = None
        group = None
        if self.mesh is not None:
            group = self.mesh.host_group
            barrier = lambda: torch.distributed.barrier(group=group)  # noqa: E731
        ckpt_io.save_directory(path, arrays=arrays, meta=meta, lead=self._lead,
                               asynchronous=self.checkpoint_backend == "orbax_async",
                               process_group=group, barrier=barrier)

    def load(self, path):
        ckpt = ckpt_io.load_checkpoint(path, type(self.net).__name__)
        opt_state = ckpt.get("optimizer")
        if opt_state is not None and opt_state.get("state") and isinstance(
                next(iter(opt_state["state"])), str):  # a directory's, keyed by name
            opt_state = _by_index(opt_state, self._param_names())
            if ckpt.get("nonfinite") is not None:
                opt_state["nonfinite"] = ckpt["nonfinite"]
        if opt_state is None and ckpt.get("optimizer_jax") is not None and self.opt is not None:
            opt_state = ckpt_io.optimizer_state_from_jax(self.opt, ckpt["optimizer_jax"],
                                                         self._param_names())
        self._load_full(ckpt["net"], opt_state)
        if self.lr_scheduler is not None and ckpt.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(ckpt["lr_scheduler"])
        if self.monitor is not None and ckpt.get("monitor"):
            self.monitor.load_state_dict(ckpt["monitor"])
        self.epoch = (ckpt.get("epoch") or 0) + 1
        if ckpt.get("seed_state") is not None:
            self.seed_state = SeedState.from_state_dict(ckpt["seed_state"])


def _by_index(opt_state: dict, names: list[str]) -> dict:
    """An optimizer state dict keyed by parameter name → keyed by the
    parameter's index in ``names`` (``torch.optim``'s own layout)."""
    index = {name: i for i, name in enumerate(names)}
    return {
        **{k: v for k, v in opt_state.items() if k not in ("state", "param_groups")},
        "state": {index[name]: value for name, value in opt_state["state"].items()},
        "param_groups": [{**group, "params": [index[p] for p in group["params"]]}
                         for group in opt_state["param_groups"]],
    }


def _by_name(opt_state: dict, names: list[str]) -> dict:
    """Inverse of :func:`_by_index`."""
    return {
        **{k: v for k, v in opt_state.items() if k not in ("state", "param_groups")},
        "state": {names[i]: value for i, value in opt_state["state"].items()},
        "param_groups": [{**group, "params": [names[i] for i in group["params"]]}
                         for group in opt_state["param_groups"]],
    }


def _to_numpy(x):
    return None if x is None else x.float().cpu().numpy()


def _per_frame_metric(fn, outputs, targets):
    """Per-frame metric over (B, T, ...) tensors, averaged over T: each frame
    is scored as a batch of B images and averaged over B, like the JAX
    package's vmap over time (the reference computes metrics frame by frame,
    ``acdc_vsr_trainer.py:83-107``; PSNR/SSIM are nonlinear, so order
    matters)."""
    B, T = outputs.shape[:2]
    o = outputs.transpose(0, 1).reshape(T * B, *outputs.shape[2:])
    t = targets.transpose(0, 1).reshape(T * B, *targets.shape[2:])
    return fn.per_sample(o, t).view(T, B).mean(dim=1).mean()


class SISRTrainer(BaseTrainer):
    """Single-image SR (reference ``acdc_sisr_trainer.py:8-49``): (B, h, w, C)
    in, (B, rh, rw, C) out, metrics over the batch."""

    def _model_inputs(self, batch):
        return (batch["lr_img"],)

    def _targets(self, batch):
        return batch["hr_img"]

    def _compute_metrics(self, outputs, target):
        o, t = self._denorm(outputs), self._denorm(target)
        return [fn(o, t) for fn in self.metric_fns]


class SISRSRFBTrainer(SISRTrainer):
    """SRFB feedback nets: a list of per-step outputs; each loss is its mean
    over the steps, the metrics and the display use the last step
    (reference ``acdc_sisr_srfb_trainer.py:6-39``)."""

    def _compute_losses(self, outputs, batch, training):
        target = self._targets(batch)
        return [torch.mean(torch.stack([fn(o, target) for o in outputs])) for fn in self.loss_fns]

    def _compute_metrics(self, outputs, target):
        return super()._compute_metrics(outputs[-1], target)

    def _display_outputs(self, outputs):
        return outputs[-1]


class MISRTrainer(SISRTrainer):
    """A window of frames in, its reference frame out (reference
    ``acdc_misr_trainer.py:8-49``): (B, T, h, w, C) → (B, rh, rw, C), the
    losses and metrics of the single-image trainer."""

    def _model_inputs(self, batch):
        return (batch["lr_imgs"],)


class VSRTrainer(BaseTrainer):
    """Sequence in, sequence out; logs weighted by B·T and per-frame metrics
    (reference ``acdc_vsr_trainer.py:9-123``)."""

    def _model_inputs(self, batch):
        return (batch["lr_imgs"],)

    def _targets(self, batch):
        return batch["hr_imgs"]

    def _log_weight(self, batch, mode):
        return super()._log_weight(batch, mode) * batch["lr_imgs"].shape[1]

    def _compute_metrics(self, outputs, target):
        o, t = self._denorm(outputs), self._denorm(target)
        return [_per_frame_metric(fn, o, t) for fn in self.metric_fns]


class VSRRefineNetTrainer(VSRTrainer):
    """RefineNet: stage-discounted multi-branch loss
    (reference ``acdc_vsr_refinenet_trainer.py:10-136``).

    Training loss per loss_fn = Σ over the 3·num_stages branches of
    ``0.5^(num_stages − 1 − branch//3) · mean(per-frame loss)``; eval loss and
    all metrics use only the final fused branch ``outputs[-1]``.
    """

    def _model_inputs(self, batch):
        return (batch["lr_imgs"], batch["pos_code"])

    def _compute_losses(self, outputs, batch, training):
        target = self._targets(batch)
        if training:
            num_stages = len(outputs) // 3
            return [
                torch.sum(torch.stack([
                    fn(o, target) * (0.5 ** (num_stages - i // 3 - 1))
                    for i, o in enumerate(outputs)
                ]))
                for fn in self.loss_fns
            ]
        return [fn(outputs[-1], target) for fn in self.loss_fns]

    def _compute_metrics(self, outputs, target):
        return super()._compute_metrics(outputs[-1], target)

    def _display_outputs(self, outputs):
        return outputs[-1]


class FRVSRTrainer(VSRTrainer):
    """Frame-recurrent VSR (reference ``acdc_frvsr_trainer.py:9-124``): the
    net returns (SR frames, previous LR frames warped to each frame);
    ``FlowLoss`` compares the warped LR frames with the batch's LR frames,
    every other loss the SR frames with the HR frames; metrics and the
    display use the SR frames."""

    def _compute_losses(self, outputs, batch, training):
        sr_imgs, lr_warped = outputs
        target = self._targets(batch)
        return [fn(lr_warped, batch["lr_imgs"]) if fn.name == "FlowLoss" else fn(sr_imgs, target)
                for fn in self.loss_fns]

    def _compute_metrics(self, outputs, target):
        return super()._compute_metrics(outputs[0], target)

    def _display_outputs(self, outputs):
        return outputs[0]


for _workload, _cls in (("SISR", SISRTrainer), ("SISRSRFB", SISRSRFBTrainer),
                       ("MISR", MISRTrainer), ("VSR", VSRTrainer),
                       ("VSRRefineNet", VSRRefineNetTrainer), ("FRVSR", FRVSRTrainer)):
    common.register_dataset_variants(TRAINERS, _workload, "Trainer", _cls)
