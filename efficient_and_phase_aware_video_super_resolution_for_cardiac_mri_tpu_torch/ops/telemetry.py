"""Exceedance telemetry for the windowed-approximation knobs.

The port's copy of the JAX package's ``ops/telemetry.py``.  ``max_flow``
replaces the unbounded gather of a warp with a window of shifted products
(``ops/warp.py``), and ``dcn_max_offset`` drops a deformable conv's
bilinear corners beyond a window (``ops/deform_conv.py``): each is exact
only while the displacement stays inside the window; an out-of-window
displacement silently degrades the scores.  Every windowed call site
therefore reduces its displacements, on the device, to

    triple = [count(|d| > bound), count(total), max(|d|)]   (float32, (3,))

with ``|d|`` in pixels and ``bound`` the configured knob.  Remedy on a
warning: raise the knob until the fraction is 0, or drop it to restore the
exact gather path (``net.kwargs.max_flow``, ``net.kwargs.dcn_max_offset``).

Collection is opt-in.  Where the JAX package sows into a flax variable
collection, a caller here opens :func:`collect` around the forwards it
wants measured: it points every module of the net at one
:class:`Collector`, and each call site records its triple under its module
path (``spy_net/pyramid_flow_window``, ``flow_window``,
``sr_flow_window``, ``pcd_align/L1_dcnpack/dcn_offset_window``: the names
the JAX package's :func:`summarize` prints for the same net).  Outside
``collect`` a call site computes nothing and nothing syncs; the training
step never collects.  The triples stay on the device and
:func:`summarize` fetches them in one transfer.

The JAX package's ``strip`` has no counterpart: it drops a stale
collection that ``net.init`` leaves in a variables dict, and a torch
module carries no collection once ``collect`` ends.
"""
from __future__ import annotations

import contextlib
import logging
from typing import Mapping

import numpy as np
import torch
from torch import nn

LOG = logging.getLogger(__name__)


def exceedance_triple(bound: float, *mags: torch.Tensor) -> torch.Tensor:
    """[n_out, n_total, max_abs] over the per-sample displacement magnitude.

    ``mags`` are same-shaped tensors of |displacement| components in pixels
    (|flow_x| and |flow_y|); a sample is out of the window when any
    component exceeds ``bound``, the windowed ops' exactness condition."""
    mag = mags[0].float()
    for m in mags[1:]:
        mag = torch.maximum(mag, m.float())
    n_out = (mag > float(bound)).sum(dtype=torch.float32)
    return torch.stack([n_out, n_out.new_tensor(float(mag.numel())), mag.max()])


def merge_triples(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Associative fold of two triples (sum the counts, max of the maxima)."""
    return torch.cat([a[:2] + b[:2], torch.maximum(a[2:], b[2:])])


def over_axis(triple: torch.Tensor, axis) -> torch.Tensor:
    """A band's triple merged with the other bands' of its frame (every
    rank of the spatial ``axis`` calls it; ``parallel/halo.SpatialAxis``,
    None: the triple itself), by one ``all_gather``."""
    if axis is None:
        return triple
    import torch.distributed as dist

    parts = [torch.empty_like(triple) for _ in range(axis.size)]
    dist.all_gather(parts, triple.contiguous(), group=axis.group)
    return merge_time_axis(torch.stack(parts, dim=1))


def merge_time_axis(stacked: torch.Tensor) -> torch.Tensor:
    """Fold a (3, T) stack of per-step triples into one."""
    return torch.stack([stacked[0].sum(), stacked[1].sum(), stacked[2].max()])


class Collector:
    """The triples of one collection (a served item, a valid epoch), by site
    path, merged on the device as they arrive.  ``pause()`` drops what the
    forwards inside it record (a tiled item's seam probes, which re-cover
    samples the windows already counted)."""

    def __init__(self):
        self.triples: dict[str, torch.Tensor] = {}
        self.paused = False

    def add(self, path: str, triple: torch.Tensor) -> None:
        prev = self.triples.get(path)
        self.triples[path] = triple if prev is None else merge_triples(prev, triple)

    @contextlib.contextmanager
    def pause(self):
        self.paused, was = True, self.paused
        try:
            yield
        finally:
            self.paused = was

    def summary(self) -> dict[str, dict[str, float]]:
        return summarize(self.triples)


@contextlib.contextmanager
def collect(net: nn.Module, collector: Collector | None = None):
    """Record the windowed call sites of ``net``'s forwards inside the block
    into ``collector`` (a new one when not given), which it yields."""
    collector = Collector() if collector is None else collector
    modules = list(net.named_modules())
    for prefix, module in modules:
        module.__dict__["_telemetry"] = (collector, prefix.replace(".", "/"))
    try:
        yield collector
    finally:
        for _, module in modules:
            module.__dict__.pop("_telemetry", None)


def _sink(module: nn.Module):
    sink = module.__dict__.get("_telemetry")
    return None if sink is None or sink[0].paused else sink


def collecting(module: nn.Module) -> bool:
    """Whether ``module``'s call sites record now: a call site asks before
    it computes its magnitudes and triple."""
    return _sink(module) is not None


def record_triple(module: nn.Module, name: str, triple: torch.Tensor) -> None:
    """Merge a call site's triple into the site ``<module path>/name``; a
    no-op unless collecting.  The triple leaves the autograd graph (a
    forward under autograd may be collected too)."""
    sink = _sink(module)
    if sink is not None:
        collector, prefix = sink
        collector.add(f"{prefix}/{name}" if prefix else name, triple.detach())


def record_offset_exceedance(module: nn.Module, offset: torch.Tensor, deformable_groups: int,
                             bound: float, name: str = "dcn_offset_window", axis=None) -> None:
    """A deformable conv's call site (the JAX package's
    ``sow_offset_exceedance``): |y| and |x| of every group's and tap's
    offset, (B, dg·2K, Ho, Wo) with channel ``g·2K + 2·tap`` the y and
    ``+1`` the x component, against ``dcn_max_offset``; nothing is computed
    unless collecting.  Under a spatial ``axis`` the band's triple is merged
    with the frame's other bands' (:func:`over_axis`)."""
    if not collecting(module):
        return
    B, C, Ho, Wo = offset.shape
    off = offset.reshape(B, deformable_groups, C // (2 * deformable_groups), 2, Ho, Wo)
    record_triple(module, name, over_axis(exceedance_triple(bound, off[:, :, :, 0].abs(),
                                                            off[:, :, :, 1].abs()), axis))


# --------------------------------------------------------------- host side


def summarize(triples: Mapping[str, torch.Tensor]) -> dict[str, dict[str, float]]:
    """Per-site stats ``{path: {"frac_out", "max_abs", "n"}}`` from one
    triple a site path; empty when nothing was recorded.  Every triple comes
    to the host in one transfer, stacked first into one (N, 3) tensor."""
    if not triples:
        return {}
    stacked = torch.stack([t.float() for t in triples.values()]).cpu().numpy()
    return {path: {"frac_out": float(n_out / n) if n else 0.0, "max_abs": float(mx), "n": float(n)}
            for path, (n_out, n, mx) in zip(triples, stacked)}


def merge_summaries(acc: dict, new: dict) -> dict:
    """Fold per-item summaries into a running per-site aggregate."""
    for path, s in new.items():
        if path not in acc:
            acc[path] = dict(s)
        else:
            a = acc[path]
            n = a["n"] + s["n"]
            a["frac_out"] = (a["frac_out"] * a["n"] + s["frac_out"] * s["n"]) / max(n, 1.0)
            a["max_abs"] = max(a["max_abs"], s["max_abs"])
            a["n"] = n
    return acc


def format_summary(summary: dict) -> str:
    """One human line per site: ``site: frac_out=1.2e-3 max|d|=5.31``."""
    return "; ".join(
        f"{p}: frac_out={s['frac_out']:.2e} max|d|={s['max_abs']:.2f}"
        for p, s in sorted(summary.items())
    )


def check(summary: dict, warn_frac: float = 0.0, context: str = "") -> list[str]:
    """Warn for every site whose out-of-window fraction exceeds ``warn_frac``;
    returns the warned site paths.  The warning carries the remedy because
    the failure is otherwise silent: scores simply degrade."""
    warned = []
    for path, s in sorted(summary.items()):
        if s["frac_out"] > warn_frac:
            warned.append(path)
            LOG.warning(
                "windowed-approximation exceedance%s at %s: %.3g%% of samples "
                "fall outside the configured window (max |displacement| %.2f px). "
                "Scores are silently degraded relative to the exact gather path — "
                "raise the window knob (max_flow / dcn_max_offset) above %.0f, or "
                "remove it to restore exact unbounded sampling.",
                f" [{context}]" if context else "",
                path,
                100.0 * s["frac_out"],
                s["max_abs"],
                np.ceil(s["max_abs"]),
            )
    return warned
