"""A run of each cell, cut to a CPU test's size, with the timed path broken
underneath: ``correct`` comes out false for each fault the cell can have,
and true for the sound path.  The control (the reference at TF32 in the
program's place) needs the card."""
from __future__ import annotations

import importlib

import pytest
import torch
import tiny

from h100_bench.bench.harness import execute

CELLS = ["refinenet_x4-serve-lr128", "refinenet_x4-train", "edvr_x4-train"]


def _faults(cell):
    entry = importlib.import_module(f"h100_bench.entries.{tiny.load('workloads', cell)['entry']}")
    return [(cell, f) for f in entry.FAULTS]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, tmp_path):
    out = execute(tiny.context(cell, tmp_path), 0.0)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("cell,fault", [p for c in CELLS for p in _faults(c)])
def test_a_broken_timed_path_is_not_correct(cell, fault, tmp_path):
    out = execute(tiny.context(cell, tmp_path, faults=(fault,)), 0.0)
    assert not out["correct"], out["compared"]


def test_the_float64_witness_measures_both_fp32_sides(tmp_path):
    """``probe_limits.py --witness``: the training reference also in float64,
    and how far the program and the fp32 reference each lie from it."""
    out = execute(tiny.context("edvr_x4-train", tmp_path, witness=True), 0.0)
    witness = out["result"]["witness"]
    assert set(witness) == {"program to float64", "fp32 reference to float64"}
    for side in witness.values():
        assert set(side) == {"loss_gap", "grad_gap", "update_gap", "update_gap_median"}
        assert side["loss_gap"] < 1e-4 and side["grad_gap"] < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("the control is TF32, which only the card has")
    ctx = tiny.context(cell, tmp_path, narrow=False, control=True)
    ctx.device = "cuda:0"
    out = execute(ctx, 0.0)
    from h100_bench.bench.compare import judge

    assert out["correct"], out["compared"]
    assert not judge(out["result"]["control_numbers"], ctx.workload["limits"])[0]
