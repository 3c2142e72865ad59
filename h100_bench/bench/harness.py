"""The benchmark's driver: one run of one cell.

``python3 h100_bench/run.py --workload CELL --seed N --seconds S --trace 0|1``

Everything a cell needs is found by name: the cell's file
``workloads/<cell>.json`` names its configuration (``configs/``), its
traffic (``traffic/``) and its entry (``entries/<entry>.py``, whose ``run``
sets up, runs the window and compares); the root ``BENCHMARK.json`` says
which end-to-end metrics the cell reports and which per-layer metrics,
each read by ``metrics/<name>.py`` or by the reader its family shares,
``metrics/<name up to the first dot>.py``.  The result is the last line of
standard output, and the compared numbers with their limits the last lines
of standard error.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from .context import BENCH, FORBIDDEN, ROOT, Context, forbidden_loaded, load
from .host import HostSampler


def _args(argv):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _cell_entry(man: dict, cell: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == cell:
            return w
    raise SystemExit(f"no cell {cell!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def end_to_end_names(man: dict, cell: str) -> list:
    return [m["name"] for m in man["end_to_end"] if _applies(m, cell, set())]


def per_layer_names(man: dict, cell: str) -> list:
    e2e = set(end_to_end_names(man, cell))
    return [m["name"] for m in man["per_layer"] if _applies(m, cell, e2e)]


def reader_path(name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, or else the
    reader its family shares, ``metrics/<name up to the first dot>.py``
    (``device_idle_pct.train`` is read by ``device_idle_pct.py``)."""
    own = BENCH / "metrics" / f"{name}.py"
    return own if own.is_file() else BENCH / "metrics" / f"{name.split('.')[0]}.py"


def reader(name: str):
    """The ``read`` of metric ``name``'s reader (:func:`reader_path`)."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location("h100_bench_metric_" + re.sub(r"\W", "_", name),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _card_line() -> dict:
    """The card's power limit, from ``nvidia-smi`` (read only)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=20).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in out.split(","))
        return {"power_limit_w": float(limit), "smi_name": name}
    except Exception:  # the reading is a note beside the numbers, not one of them
        return {}


def context(args, workload_dir: Path, device: str) -> Context:
    cell = load("workloads", args.workload)
    return Context(cell=args.workload, workload=cell, config=load("configs", cell["config"]),
                   traffic=load("traffic", cell["traffic"]), seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace), device=device,
                   work=workload_dir)


def execute(ctx: Context, t_start: float, man: dict | None = None) -> dict:
    """Run the cell's entry and make its result (everything but the look
    for a card)."""
    entry = importlib.import_module(f"h100_bench.entries.{ctx.workload['entry']}")
    host = HostSampler().start()
    try:
        res = entry.run(ctx)
    finally:
        host.stop()
    res.setdefault("counts", {})["process start to the entry (s)"] = ctx.entry_start - t_start
    res["counts"]["host over the window"] = host.over(res["open"], res["close"])
    res["counts"]["every number"] = res["numbers"]
    gc.collect()
    from ..bench.compare import judge

    correct, compared = judge(res["numbers"], ctx.workload["limits"])
    names = ctx.workload.get("metric_names", {})
    values = {names.get(k, k): v for k, v in res["metrics"].items()}
    values["setup_s"] = res["open"] - t_start
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
           "values": values, "result": res,
           "compared": compared}
    if man is not None:
        wanted = per_layer_names(man, ctx.cell) if ctx.trace else end_to_end_names(man, ctx.cell)
        metrics = {}
        if ctx.trace:
            import torch

            from .roofline import peaks

            run = dict(res, cell=ctx.cell, config=ctx.config, traffic=ctx.traffic,
                       peaks=peaks(torch.cuda.get_device_name(0)))
            for name in wanted:
                value = reader(name)(run)
                if value is not None:
                    metrics[name] = {"value": value, "unit": _unit(man, name)}
        else:
            for name in wanted:
                if name not in values:
                    raise SystemExit(f"cell {ctx.cell} does not measure {name}")
                metrics[name] = {"value": values[name], "unit": _unit(man, name)}
        out["metrics"] = metrics
    return out


def _unit(man: dict, name: str) -> str:
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] == name:
            return m["unit"]
    raise KeyError(name)


def main(argv, t_start: float) -> int:
    args = _args(argv)
    man = manifest()
    chips = int(_cell_entry(man, args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from .context import program

    program()  # the program under test must be there
    work = Path(tempfile.mkdtemp(prefix="h100_bench_"))
    try:
        ctx = context(args, work, "cuda:0")
        out = execute(ctx, t_start, man)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    loaded = forbidden_loaded(sys.modules)
    if loaded:
        print(f"modules that a run may not load were loaded: {loaded} (of {FORBIDDEN})",
              file=sys.stderr)
        return 3
    res = out["result"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"]), **_card_line()}
    line = {"correct": out["correct"], "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": out["metrics"], "device": device}
    if args.trace:
        tr = res["trace"]
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["compared"] = out["compared"]
    for key, value in res.get("counts", {}).items():
        print(f"{key}: {value}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

