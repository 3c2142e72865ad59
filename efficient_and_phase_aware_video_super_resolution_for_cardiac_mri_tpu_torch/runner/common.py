"""Helpers shared by the trainer and predictor engines.

One definition, two engines: a change to the denorm convention or the log
layout hits training metrics and test metrics together.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..utils.stats import denormalize

LOG = logging.getLogger(__name__)


def denorm_uint8(x: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """Reference denormalize (``src/utils.py:19``): back to rounded, clipped
    [0, 255] intensity before metric computation."""
    return denormalize(x, mean=mean, std=std)


def compact_lossless(x: np.ndarray) -> np.ndarray:
    """float32 → uint8/int16 only when the round trip back to float32 is
    bit-exact (trainer ``int_feed``): the cardiac HR trees store integer
    intensities in [0, 255] as float32 NIfTI, so their host → device copy
    shrinks 4× losslessly.  Fractional, out-of-range or non-finite data
    passes through unchanged (the JAX package's ``runner/common.py``)."""
    if not isinstance(x, np.ndarray) or x.dtype != np.float32 or x.size == 0:
        return x
    mn, mx = float(x.min()), float(x.max())
    if not (np.isfinite(mn) and np.isfinite(mx)):
        return x
    if 0.0 <= mn and mx <= 255.0:
        dt = np.uint8
    elif -32768.0 <= mn and mx <= 32767.0:
        dt = np.int16
    else:
        return x
    c = x.astype(dt)
    return c if np.array_equal(c.astype(np.float32), x) else x


def accept_aot_cache(aot_cache) -> None:
    """The JAX package's ``aot_cache`` stores compiled XLA executables so a
    restart skips compilation.  The port runs eagerly and compiles nothing
    per shape; its one compiled artifact, the nvcc library of
    ``ops/_build.py``, is already keyed by a source hash and reused across
    restarts.  So the knob is accepted, said so once, and changes nothing."""
    if aot_cache:
        LOG.info(
            f"aot_cache={str(aot_cache)!r} accepted and unused: the PyTorch port compiles "
            "nothing per shape, and its CUDA kernels are built once per source hash."
        )


def init_log(loss_fns, metric_fns) -> dict:
    """Zeroed epoch log: Loss + one entry per loss/metric, reference order."""
    log = {"Loss": 0.0}
    for fn in loss_fns:
        log[fn.name] = 0.0
    for fn in metric_fns:
        log[fn.name] = 0.0
    return log


def register_dataset_variants(registry, workload: str, suffix: str, cls) -> None:
    """Register the Acdc/Dsb15 twins of a workload engine under the
    reference's naming scheme (e.g. ``AcdcVSRRefineNetTrainer``) with the
    matching dataset stats baked in."""
    for prefix, stats in (("Acdc", "acdc"), ("Dsb15", "dsb15")):
        name = f"{prefix}{workload}{suffix}"
        registry.add(name, type(name, (cls,), {"dataset_stats": stats}))
