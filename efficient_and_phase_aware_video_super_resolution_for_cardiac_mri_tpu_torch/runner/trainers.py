"""Trainers: the epoch and step engine (reference ``src/runner/trainers/*``).

The port's counterpart of the JAX package's ``runner/trainers.py`` for the
RefineNet path.  The epoch protocol is the JAX package's, statement for
statement (``base_trainer.py:46-97``): per-epoch numpy reseed and
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
  copies of the fp32 parameters made inside the autograd graph
  (``utils/casting.forward_in``); parameters, Adam state, losses and
  metrics stay fp32.
* ``grad_accum_steps`` A: the batch splits into A equal microbatches whose
  gradients are summed, then scaled by 1/A before one optimizer step; the
  logged values are the microbatches' mean, the display outputs the whole
  batch.
* ``int_feed``: the datasets' explicit-stats ``Normalize`` moves to the
  device; image arrays travel as uint8/int16 where that is lossless (as
  bf16 for a fractional LR under bf16 compute) and are normalized there.
* ``aot_cache``: accepted and logged; the port compiles nothing per shape.

The knobs still to port raise ``NotImplementedError`` naming their ROADMAP
item when set to anything but their default.
"""
from __future__ import annotations

import logging
import signal
import time

import numpy as np
import torch

from ..config import TRAINERS
from ..utils import casting
from ..utils.seeding import SeedState, seed_everything
from ..utils.stats import get_stats
from . import checkpoint as ckpt_io
from . import common

LOG = logging.getLogger(__name__)

#: trainer knobs of the JAX package that this port does not implement yet:
#: their default, and the ROADMAP queue-1 item that ports them
DEFERRED_KNOBS = {
    "checkpoint_backend": ("pickle", 10),
    "telemetry_warn_frac": (0.0, 12),
}


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
        preempt_after_epochs: int = 0,
        preempt_after_seconds: float = 0.0,
        compute_dtype: str | None = None,
        grad_accum_steps: int = 1,
        aot_cache: str | None = None,
        int_feed: bool = False,
        **knobs,
    ):
        for knob, value in knobs.items():
            if knob not in DEFERRED_KNOBS:
                raise TypeError(f"{type(self).__name__} got an unexpected keyword argument {knob!r}")
            default, item = DEFERRED_KNOBS[knob]
            if value != default and (value or default):
                raise NotImplementedError(
                    f"trainer knob {knob}={value!r} is not implemented in the PyTorch port yet "
                    f"(ROADMAP queue 1, item {item})"
                )
        # ``telemetry`` reports windowed ops (max_flow / dcn_max_offset);
        # RefineNet has none, so the knob is accepted and does nothing
        self.device = torch.device(device)
        self.train_dataloader = train_dataloader
        self.valid_dataloader = valid_dataloader
        self.net = net.to(self.device) if net is not None else None
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
        # self-preemption budgets (SURVEY §5 failure recovery): once hit at an
        # epoch boundary, take the SIGTERM path (checkpoint
        # model_preempted.pth, clean exit); ``loaded_path: auto`` resumes.
        # 0 = off.  The seconds budget is checked after each epoch.
        self.preempt_after_epochs = int(preempt_after_epochs)
        self.preempt_after_seconds = float(preempt_after_seconds)
        self._preempt_requested = False
        self.compute_dtype = casting.resolve_dtype(compute_dtype)
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

    def _compute_losses(self, outputs, target, training: bool) -> list:
        raise NotImplementedError

    def _compute_metrics(self, outputs, target) -> list:
        raise NotImplementedError

    def _display_outputs(self, outputs):
        """Output handed to the logger (last batch only)."""
        return outputs

    def _log_weight(self, batch, mode: str) -> float:
        """Reference weighting: configured batch_size (quirk 8)."""
        loader = self.train_dataloader if mode == "training" else self.valid_dataloader
        return loader.batch_size

    def _denorm(self, x):
        return common.denorm_uint8(x, self.mean, self.std)

    # ------------------------------------------------------------- int_feed
    def _resolve_int_feed(self):
        """Move the datasets' explicit-stats Normalize to the device, if every
        dataset has one (the JAX package's ``_resolve_int_feed``)."""
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

    def _forward(self, batch, training: bool, state=None):
        """Forward and the weighted losses → (total, losses, outputs, target);
        ``state`` is the step's cast weights (``casting.cast_state``)."""
        batch = self._feed(batch)
        outputs = casting.forward_in(self.net, self.compute_dtype, *self._model_inputs(batch),
                                     state=state)
        target = self._targets(batch)
        losses = self._compute_losses(outputs, target, training)
        total = torch.sum(torch.stack(losses) * self.loss_weights)
        return total, losses, outputs, target

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
        state = casting.cast_state(self.net, self.compute_dtype)  # shared by the microbatches
        sums, displays = None, []
        for i in range(accum):
            micro = batch if accum == 1 else {
                k: v[i * m:(i + 1) * m] if isinstance(v, np.ndarray) else v
                for k, v in batch.items()
            }
            total, losses, outputs, target = self._forward(micro, True, state)
            total.backward()  # sums the microbatches' gradients into .grad
            with torch.no_grad():
                metrics = self._compute_metrics(outputs, target)
                displays.append(self._display_outputs(outputs).detach())
            values = torch.stack([total.detach(), *[l.detach() for l in losses], *metrics])
            sums = values if sums is None else sums + values
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

    @torch.inference_mode()
    def _eval_step(self, batch):
        total, losses, outputs, target = self._forward(batch, False)
        return total, losses, self._compute_metrics(outputs, target), self._display_outputs(outputs)

    def _run_epoch(self, mode: str):
        training = mode == "training"
        loader = self.train_dataloader if training else self.valid_dataloader
        self.net.train(training)
        count, steps, frames = 0.0, 0, 0
        batch = outputs = None
        acc = None  # [total, *losses, *metrics], weighted sums on the device
        t0 = time.perf_counter()
        for batch in loader:
            step = self._train_step if training else self._eval_step
            total, losses, metrics, outputs = step(batch)
            w = float(self._log_weight(batch, mode))
            values = torch.stack([total, *losses, *metrics]) * w
            acc = values if acc is None else acc + values
            count += w
            steps += 1
            # LR frames consumed this step: (B, T, ...)
            frames += int(batch["lr_imgs"].shape[0] * batch["lr_imgs"].shape[1])
        log = common.init_log(self.loss_fns, self.metric_fns)
        if acc is not None:
            for key, val in zip(log, acc.tolist()):  # the epoch's one fetch
                log[key] = val
        # measured after the fetch, so it includes the device's drain
        elapsed = max(time.perf_counter() - t0, 1e-9)
        if training and steps:
            self.throughput["train_steps_per_sec"] = steps / elapsed
            self.throughput["frames_per_sec"] = frames / elapsed
        for key in log:
            log[key] /= max(count, 1)
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
            train_log, train_batch, train_outputs = self._run_epoch("training")
            LOG.info(
                f"Train log: {train_log} "
                f"({self.throughput['train_steps_per_sec']:.2f} steps/sec)."
            )
            valid_log, valid_batch, valid_outputs = self._run_epoch("validation")
            LOG.info(f"Valid log: {valid_log}.")
            self.history["train"].append(dict(train_log))
            self.history["valid"].append(dict(valid_log))

            if self.lr_scheduler is not None:
                new_lr = self.lr_scheduler.step(valid_log.get("Loss"))
                self.optimizer.set_lr(self.opt, new_lr)

            if self.logger is not None:
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
        if self.logger is not None:
            self.logger.close()

    # ----------------------------------------------------------- checkpoint
    def save(self, path):
        ckpt_io.save_checkpoint(
            path,
            net_state=self.net.state_dict(),
            optimizer_state=self.opt.state_dict() if self.opt is not None else None,
            lr_scheduler_state=self.lr_scheduler.state_dict() if self.lr_scheduler else None,
            monitor_state=self.monitor.state_dict() if self.monitor else None,
            epoch=self.epoch,
            seed_state=self.seed_state.state_dict(),
        )

    def load(self, path):
        ckpt = ckpt_io.load_checkpoint(path)
        self.net.load_state_dict(ckpt["net"], strict=True)
        if self.opt is not None and ckpt.get("optimizer") is not None:
            self.opt.load_state_dict(ckpt["optimizer"])
        if self.lr_scheduler is not None and ckpt.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(ckpt["lr_scheduler"])
        if self.monitor is not None and ckpt.get("monitor"):
            self.monitor.load_state_dict(ckpt["monitor"])
        self.epoch = (ckpt.get("epoch") or 0) + 1
        if ckpt.get("seed_state") is not None:
            self.seed_state = SeedState.from_state_dict(ckpt["seed_state"])


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


class VSRTrainer(BaseTrainer):
    """Sequence in, sequence out; logs weighted by B·T and per-frame metrics
    (reference ``acdc_vsr_trainer.py:9-123``)."""

    def _model_inputs(self, batch):
        return (batch["lr_imgs"],)

    def _targets(self, batch):
        return batch["hr_imgs"]

    def _log_weight(self, batch, mode):
        return super()._log_weight(batch, mode) * batch["lr_imgs"].shape[1]

    def _compute_losses(self, outputs, target, training):
        return [fn(outputs, target) for fn in self.loss_fns]

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

    def _compute_losses(self, outputs, target, training):
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


common.register_dataset_variants(TRAINERS, "VSRRefineNet", "Trainer", VSRRefineNetTrainer)
