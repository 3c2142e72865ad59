"""What a run hands its entry, and the program's package."""
from __future__ import annotations

import importlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

from .trace import Spans

#: the checkout's root (the parent of ``h100_bench/``)
ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "h100_bench"
#: the program under test: the PyTorch port
PROGRAM = "efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch"
#: top-level module names that no run may load, compared whole (the port's
#: name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax",
             "efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu")


def load(kind: str, name: str) -> dict:
    """``h100_bench/<kind>/<name>.json``."""
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def program(module: str = ""):
    """The port's package or one of its modules."""
    return importlib.import_module(f"{PROGRAM}.{module}" if module else PROGRAM)


def forbidden_loaded(modules) -> list:
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


@dataclass
class Context:
    """One run of one cell."""

    cell: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    work: Path
    spans: Spans = field(default_factory=Spans)
    #: faults planted under the timed path (tests and the limit probe only)
    faults: tuple = ()
    #: the TF32 control in the program's place (the limit probe only)
    control: bool = False
    #: the training reference also in float64, which both fp32 sides are
    #: measured against (the limit probe only)
    witness: bool = False
    #: when the context was made (perf_counter seconds)
    entry_start: float = field(default_factory=time.perf_counter)
