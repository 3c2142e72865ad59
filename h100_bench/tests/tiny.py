"""Cells of the benchmark cut to a size that a CPU test run holds: the same
files, with the nets narrowed, the trees shrunk and the loader's threads
cut; every other setting is the cell's own."""
from __future__ import annotations

import copy

from h100_bench.bench.context import Context, load

NETS = {
    "RefineNet": {"num_features": [8, 8], "num_stages": 2},
    "EDVRNet": {"nf": 16, "groups": 2, "front_RBs": 1, "back_RBs": 2},
}
TRAFFIC = {"inbox": {"patients": 2, "sequences_per_patient": 4, "frames": 12, "hr_size": 64},
           "train": {"patients": 1, "sequences_per_patient": 3, "frames": 12, "hr_size": 64}}


def context(cell: str, tmp, seconds: float = 2.0, seed: int = 2**31 + 11, narrow: bool = True,
            **kw) -> Context:
    """The cell's run at a test's size; ``narrow`` off keeps the nets'
    published widths (for the card)."""
    workload = copy.deepcopy(load("workloads", cell))
    config = copy.deepcopy(load("configs", workload["config"]))
    traffic = copy.deepcopy(load("traffic", workload["traffic"]))
    if narrow:
        config["net"]["kwargs"].update(NETS[config["net"]["name"]])
    traffic.update(TRAFFIC[traffic["layout"]])
    if "dataset" in config:
        for aug in config["dataset"]["kwargs"]["augments"]:
            if aug["name"] == "RandomCropPatch":
                aug["kwargs"]["size"] = [8, 8]
        config["dataloader"]["kwargs"].update(train_batch_size=4, num_workers=2)
    workload.update({"sample_sequences": 2, "open_timeout_s": 300, "poll_s": 0.1}
                    if workload["entry"] == "serve" else {})
    return Context(cell=cell, workload=workload, config=config, traffic=traffic, seed=seed,
                   seconds=seconds, trace=False, device="cpu", work=tmp, **kw)
