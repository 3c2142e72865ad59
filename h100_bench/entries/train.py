"""Training entry: the trainer's own epoch loop over the port's dataset,
augments and threaded loader.

Set-up writes the traffic's train split, builds the configuration's
trainer as the port's ``main`` does (dataset, ``Dataloader``, the net with
the seeded weights drawn on the device, losses, metrics, Adam), and drives
it through ``_run_epoch("training")``, the call ``_train_loop`` makes, for
``warmup_steps`` steps.  The first three of them are the checked ones: the
reference follows them from the same weights and batches.  The same
trainer then runs the window through the same call.

The loader is one pass of one epoch (``Feed``): the split holds more items
than the set-up and the window take, so no epoch boundary falls inside
them; were the split to run out inside the window, the window would end at
the last whole step instead.  The step time is the span of whole steps over
their count: from the request for the first timed step's batch to the
synchronised end of the last step that began inside ``--seconds``.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..bench import compare, phantom, work
from ..bench.context import program
from ..bench.trace import device_events, reduce
from ..reference.adam import Adam
from ..reference.phase_code import cosine_code


#: the faults a training step can have, planted by ``_plant`` (one chip:
#: no exchange between chips to leave out)
FAULTS = ("state", "half", "output")


class Feed:
    """The trainer's train loader: the real loader's iterator, kept across
    the set-up pass and the window, with the benchmark's spans around it.

    ``plan(steps=n, hooks={k: fn})`` yields n batches and calls ``fn`` at
    the k-th request (k = n + 1 is the request that ends the pass);
    ``plan(seconds=s)`` times whole steps."""

    def __init__(self, loader, spans, sync):
        self.loader, self.spans, self.sync = loader, spans, sync
        self.batch_size = loader.batch_size
        self._it = iter(loader)
        self.captured: list = []
        self.capture = 0
        self.waits: list = []
        self.ended_early = False

    def __getattr__(self, name):
        return getattr(self.__dict__["loader"], name)

    def plan(self, steps=None, seconds=None, hooks=None):
        self.steps, self.seconds, self.hooks = steps, seconds, hooks or {}
        self.calls, self.t0, self.t_end, self.last = 0, None, None, None
        return self

    def __iter__(self):
        return self

    def _stop(self):
        self.sync()
        self.t_end = time.perf_counter()
        if self.last is not None:
            self.spans.add("step", self.last, self.t_end)
        raise StopIteration

    def __next__(self):
        now = time.perf_counter()
        self.calls += 1
        if self.last is not None:
            self.spans.add("step", self.last, now)
        if self.calls in self.hooks:
            self.hooks[self.calls]()
        if self.steps is not None and self.calls > self.steps:
            self._stop()
        if self.seconds is not None:
            if self.t0 is None:
                self.sync()
                self.t0 = now = time.perf_counter()
            elif now - self.t0 >= self.seconds:
                self._stop()
        try:
            batch = next(self._it)
        except StopIteration:
            self.ended_early = True
            self._stop()
        t1 = time.perf_counter()
        self.spans.add("loader_wait", now, t1)
        if self.seconds is not None:
            self.waits.append(t1 - now)
        if len(self.captured) < self.capture:
            self.captured.append(batch)
        self.last = t1
        return batch

    def close(self):
        """End the loader's pass: its thread pool finishes and stops."""
        self._it.close()


def _build(ctx, cfg, tree_root, net, device, spans):
    """The configuration's trainer, as the port's ``main`` builds one."""
    port_main = program("main")
    port_main._import_components()
    reg = program("config")
    optim = program("runner.optim")
    ds_kwargs = {"data_dir": tree_root / "videos", "type": "train"}
    if cfg["dataset"]["name"].endswith("RefineNetDataset"):
        ds_kwargs["pos_code_path"] = tree_root / "position_code.pkl"
    dataset = reg.DATASETS.build(cfg["dataset"], **ds_kwargs)
    dl = dict(cfg["dataloader"]["kwargs"])
    batch = dl.pop("train_batch_size")
    loader = reg.DATALOADERS.get(cfg["dataloader"]["name"])(dataset, batch_size=batch, **dl)
    loader.set_epoch(ctx.seed % (2 ** 63))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    feed = Feed(loader, spans, sync)
    trainer = reg.TRAINERS.get(cfg["trainer"]["name"])(
        device=device, train_dataloader=feed, net=net,
        loss_fns=[reg.LOSSES.build(c) for c in cfg["losses"]],
        loss_weights=[c.get("weight", 1.0) for c in cfg["losses"]],
        metric_fns=[reg.METRICS.build(c) for c in cfg["metrics"]],
        optimizer=optim.build_optimizer(cfg["optimizer"]), num_epochs=1)
    return trainer, feed


def _plant(ctx, trainer):
    """Faults under the timed path (tests and the limit probe): ``state``
    leaves the parameters and Adam's state unchanged by each step;
    ``half`` takes each step over the first half of its batch; ``output``
    alters each step's losses by 1% where they are produced."""
    if "state" in ctx.faults:
        trainer.optimizer.step = lambda opt: None
    if "half" in ctx.faults:
        step = trainer._train_step

        def half(batch):
            b = len(batch["index"]) // 2
            return step({k: v[:b] for k, v in batch.items()})

        trainer._train_step = half
    if "output" in ctx.faults:
        losses = trainer._compute_losses
        trainer._compute_losses = lambda *a: [x * 1.01 for x in losses(*a)]


def reference_steps(cfg, theta0: dict, batches: list, device, tf32: bool = False,
                    dtype=torch.float32):
    """The reference's three steps from ``theta0`` over ``batches`` →
    (losses, first gradients, changes of the parameters), in ``dtype``."""
    ref = work.reference(cfg)
    params = {k: v.to(device, dtype).clone().requires_grad_(True) for k, v in theta0.items()}
    net = ref.NET(params, cfg["net"]["kwargs"])
    kw = cfg["optimizer"]["kwargs"]
    adam = Adam(params, lr=kw["lr"], betas=tuple(kw.get("betas", (0.9, 0.999))),
                eps=kw.get("eps", 1e-8))
    losses, first = [], None
    keys = list(params)
    for batch in batches:
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, dtype)
                   for k, v in batch.items() if isinstance(v, np.ndarray) and v.dtype.kind == "f"}
        with work.numerics(tf32):
            loss = ref.loss(net, tensors, cfg)
            grads = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
        grads = dict(zip(keys, grads))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items() if g is not None}
        adam.step(grads)
        losses.append(float(loss.detach()))
        del loss, grads, tensors
    delta = {k: (params[k].detach() - theta0[k].to(device, dtype)) for k in keys}
    return losses, first, delta


def unmatched_items(cfg, tree, batches, codes) -> int:
    """Items of the batches that are not a flip and crop of the tree's
    frames at their dataset index (normalised as the configuration says),
    or whose phase code is not the tree's."""
    ref = work.reference(cfg)
    kwargs = cfg["dataset"]["kwargs"]
    norm = next(t for t in kwargs["transforms"] if t["name"] == "Normalize")["kwargs"]
    mean, std = float(norm["means"][0]), float(norm["stds"][0])
    scale = int(kwargs["downscale_factor"])
    T = tree["lr"][0].shape[-1]
    bad = 0
    for batch in batches:
        hr_key = "hr_imgs" if "hr_imgs" in batch else "hr_img"
        for i, index in enumerate(batch["index"]):
            s, t = divmod(int(index), T)
            lr_idx, hr_idx = ref.item_frames(t, T, kwargs)
            lr = (np.transpose(tree["lr"][s], (2, 0, 1))[lr_idx] - mean) / np.float32(std + 1e-10)
            hr = (np.transpose(tree["hr"][s], (2, 0, 1))[hr_idx] - mean) / np.float32(std + 1e-10)
            item_lr = batch["lr_imgs"][i][..., 0]
            item_hr = batch[hr_key][i][..., 0].reshape(len(hr_idx), *batch[hr_key].shape[-3:-1])
            ok = compare.find_crop(item_lr, lr.astype(np.float32), item_hr, hr.astype(np.float32),
                                   scale)
            if ok and "pos_code" in batch:
                ok = np.array_equal(batch["pos_code"][i][:, 0], codes[lr_idx])
            bad += not ok
    return bad


def run(ctx) -> dict:
    device = program("main").resolve_device(ctx.device)  # fp32, TF32 off on the card
    cfg, traffic, cell = ctx.config, ctx.traffic, ctx.workload
    on_card = device.type == "cuda"
    marks = [("start", time.perf_counter())]
    tree = phantom.write_tree(traffic, ctx.seed, ctx.work, device)
    marks.append(("tree", time.perf_counter()))
    net = work.build_net(cfg["net"], device)
    shapes = work.shapes_of(net)
    params = work.seeded_weights(cfg, shapes, ctx.seed, device)
    net.load_state_dict(params)
    theta0 = {k: v.cpu() for k, v in params.items()}
    del params
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("net and weights", time.perf_counter()))
    trainer, feed = _build(ctx, cfg, ctx.work, net, device, ctx.spans)
    marks.append(("trainer", time.perf_counter()))
    _plant(ctx, trainer)

    # the checked steps: losses as each step returns them, Adam's state
    # after the first, the parameters after the third
    checked = 3
    net, opt = trainer.net, trainer.opt
    losses, snap = [], {}
    step = trainer._train_step

    def recorded(batch):
        out = step(batch)
        if len(losses) < checked:
            losses.append(out[0].detach().clone())
        return out

    def after_first():
        snap["m1"] = {name: opt.state[p]["exp_avg"].detach().clone()
                      for name, p in net.named_parameters() if p in opt.state}

    def after_third():
        snap["theta3"] = {name: p.detach().clone() for name, p in net.named_parameters()}

    trainer._train_step = recorded
    feed.capture = checked
    warm = max(int(cell["warmup_steps"]), checked)
    feed.plan(steps=warm, hooks={2: after_first, checked + 1: after_third})
    trainer.net.train(True)
    trainer._run_epoch("training")
    trainer._train_step = step
    marks.append(("warm-up steps", time.perf_counter()))

    prof = None
    if ctx.trace:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    feed.plan(seconds=ctx.seconds)
    try:
        trainer._run_epoch("training")
    finally:
        if prof is not None:
            prof.stop()
        feed.close()
    t_open, t_close, steps = feed.t0, feed.t_end, len(feed.waits)
    waits, ended = list(feed.waits), feed.ended_early
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # the program's readings, then its state freed before the reference runs
    b1 = float(trainer.optimizer.kwargs.get("betas", (0.9, 0.999))[0])
    grad_prog = {k: (v / (1 - b1)).cpu() for k, v in snap["m1"].items()}
    delta_prog = {k: (v.cpu() - theta0[k]) for k, v in snap["theta3"].items()}
    loss_prog = [float(x) for x in losses]
    batches = feed.captured
    del trainer, feed, net, opt, snap, losses, step, recorded, after_first, after_third
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    loss_ref, grad_ref, delta_ref = reference_steps(cfg, theta0, batches, device)
    grad_ref = {k: v.cpu() for k, v in grad_ref.items()}
    delta_ref = {k: v.cpu() for k, v in delta_ref.items()}
    moved = compare.moved_leaves(grad_ref)
    T = traffic["frames"]
    unmatched = float(unmatched_items(cfg, tree, batches, cosine_code(T, phantom.end_systole(T))))

    def numbers_of(losses, grads, delta):
        gaps = [abs(p - r) / abs(r) for p, r in zip(losses, loss_ref)]
        return {"loss_gap": max(gaps), "loss_gap_first": gaps[0],
                "grad_gap": compare.norm_gap(grads, grad_ref, grad_ref.keys()),
                "update_gap": compare.norm_gap(delta, delta_ref, moved),
                "update_gap_median": compare.median_gap(delta, delta_ref, moved),
                "batch_unmatched": unmatched}

    numbers = numbers_of(loss_prog, grad_prog, delta_prog)
    worst = {name: sorted(compare.leaf_gaps(prog, ref_, keys).items(), key=lambda kv: -kv[1])[:3]
             for name, prog, ref_, keys in (("grad", grad_prog, grad_ref, grad_ref.keys()),
                                            ("update", delta_prog, delta_ref, moved))}
    control = None
    if ctx.control:  # the reference at TF32 in the program's place
        losses, grads, delta = reference_steps(cfg, theta0, batches, device, tf32=True)
        control = numbers_of(losses, {k: v.cpu() for k, v in grads.items()},
                             {k: v.cpu() for k, v in delta.items()})
        control["loss gap by step"] = [abs(p - r) / abs(r) for p, r in zip(losses, loss_ref)]

    witness = None
    if ctx.witness:  # the reference in float64: how far each fp32 side lies from it
        losses, grads, delta = reference_steps(cfg, theta0, batches, device,
                                               dtype=torch.float64)
        grads = {k: v.cpu() for k, v in grads.items()}
        delta = {k: v.cpu() for k, v in delta.items()}

        def to_fp64(p_losses, p_grads, p_delta):
            return {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(p_losses, losses)),
                    "grad_gap": compare.norm_gap(p_grads, grads, grads.keys()),
                    "update_gap": compare.norm_gap(p_delta, delta, moved),
                    "update_gap_median": compare.median_gap(p_delta, delta, moved)}

        witness = {"program to float64": to_fp64(loss_prog, grad_prog, delta_prog),
                   "fp32 reference to float64": to_fp64(loss_ref, grad_ref, delta_ref)}
        del grads, delta

    batch0 = batches[0]
    ref_mod = work.reference(cfg)

    def step_ops(net, cut):
        small = {}
        for k, v in batch0.items():
            if isinstance(v, np.ndarray) and v.dtype.kind == "f":
                shape = (1, *v.shape[1:])
                if v.ndim >= 4:  # frames: (..., h, w, C)
                    shape = (*shape[:-3], shape[-3] // cut, shape[-2] // cut, shape[-1])
                small[k] = torch.zeros(shape)
        ref_mod.loss(net, small, cfg)

    reduced = None
    if prof is not None:
        reduced = reduce(device_events(prof), ctx.spans.to_wall_ns(t_open),
                         ctx.spans.to_wall_ns(t_close), ctx.spans)
    lr_shape = batch0["lr_imgs"].shape  # (B, frames, h, w, C)
    return {
        "open": t_open, "close": t_close,
        "metrics": {"step_ms": 1e3 * (t_close - t_open) / steps},
        "counts": {"steps in the window": steps, "window ended at the split's end": ended,
                   "loss gap by step": [abs(p - r) / abs(r) for p, r in zip(loss_prog, loss_ref)],
                   "worst leaves": worst,
                   "set-up seconds": {b[0]: round(b[1] - a[1], 3) for a, b in zip(marks, marks[1:])},
                   "tree bytes": tree["bytes"]},
        "attempted": steps, "failed": 0,
        "memory_peak_bytes": peak,
        "numbers": numbers, "control_numbers": control, "witness": witness,
        "trace": reduced,
        "layer": {"units": steps,
                  "unit_ops": work.count_ops(cfg, shapes, step_ops, True, len(batch0["index"])),
                  "loader_wait_ms": [1e3 * w for w in waits],
                  "batch": int(lr_shape[0]), "lr_hw": tuple(lr_shape[2:4]),
                  # the gate kernels' (B, F, h, w), in nets that have them
                  "gate_shape": (int(lr_shape[0]),
                                 cfg["net"]["kwargs"].get("num_features", [0])[-1],
                                 *lr_shape[2:4])},
    }

