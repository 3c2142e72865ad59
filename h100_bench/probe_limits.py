"""The readings that the cells' correctness limits are set from.

    python3 h100_bench/probe_limits.py CELL [--seeds 12] [--control-seeds 4]
        [--fault-seeds 3] [--seconds 3] [--first-seed N] > readings.jsonl

Run on the card, not by the benchmark's runs.  In one process, for each of
``--seeds`` seeds, one run of the cell through its own entry (a short
window of ``--seconds`` at the cell's load; every set-up and comparison as
in a benchmark run): the program's numbers, and on the first
``--control-seeds`` seeds also the control's (the reference at TF32, the
next precision below the configurations' fp32 with TF32 off, in the
program's place); with ``--witness``, a training cell's reference also in
float64, and how far the program and the fp32 reference each lie from it
(which side a seed's gap comes from).  Then each fault the cell's entry can plant, on
``--fault-seeds`` seeds.  One JSON line a reading.
"""
import argparse
import gc
import importlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100_bench.bench.context import Context, load  # noqa: E402
from h100_bench.bench.harness import execute  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("cell")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=4)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=2**31 + 1000)
    p.add_argument("--seed-list", type=int, nargs="*", default=None,
                   help="these seeds instead of --seeds from --first-seed")
    p.add_argument("--witness", action="store_true",
                   help="training cells: also the reference in float64, and how far the "
                        "program and the fp32 reference each lie from it")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    cell = load("workloads", args.cell)
    entry = importlib.import_module(f"h100_bench.entries.{cell['entry']}")
    seeds = args.seed_list or [args.first_seed + 7919 * i
                               for i in range(args.seeds + args.fault_seeds)]
    n = len(args.seed_list) if args.seed_list else args.seeds
    plan = [((), seeds[i], i < args.control_seeds) for i in range(n)]
    if not args.seed_list:
        plan += [((f,), seeds[args.seeds + i], False) for f in entry.FAULTS
                 for i in range(args.fault_seeds)]
    for faults, seed, control in plan:
        with tempfile.TemporaryDirectory(prefix="h100_probe_") as d:
            ctx = Context(cell=args.cell, workload=cell, config=load("configs", cell["config"]),
                          traffic=load("traffic", cell["traffic"]), seed=seed,
                          seconds=args.seconds, trace=False, device=args.device, work=Path(d),
                          faults=faults, control=control, witness=args.witness)
            t0 = time.perf_counter()
            out = execute(ctx, t0)
            res = out["result"]
            line = {"cell": args.cell, "seed": seed, "faults": list(faults),
                    "correct": out["correct"], "numbers": res["numbers"],
                    "control": res["control_numbers"], "witness": res.get("witness"),
                    "counts": res["counts"],
                    "values": out["values"], "seconds": time.perf_counter() - t0}
        print(json.dumps(line, default=str), flush=True)
        gc.collect()


if __name__ == "__main__":
    main()
