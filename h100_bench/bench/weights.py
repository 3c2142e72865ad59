"""Seeded weights, drawn on the run's device in one call.

One uniform draw in [-1, 1) of every parameter at once from a
``torch.Generator`` on the device, cut into the leaves and scaled by each
leaf's rule: by default the conv default ``U(±1/√fan_in)`` (a bias takes its
weight's fan-in), or the first rule of the configuration's ``weights`` list
whose ``pattern`` (a regular expression) the leaf's name matches, with a
``gain`` on that bound, an absolute ``bound``, or a constant ``value``.
The weights are fp32, the precision the configurations run in.
"""
from __future__ import annotations

import math
import re

import torch


def _fan_in(name: str, shapes: dict) -> int:
    weight = shapes.get(name[: -len("bias")] + "weight") if name.endswith("bias") else shapes[name]
    if weight is None or len(weight) < 2:
        return 1
    return math.prod(weight[1:])


def draw(shapes: dict, rules: list, seed: int, device) -> dict:
    """``shapes`` maps leaf names to shapes, in a fixed order → the leaves."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out, start = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        leaf = flat[start:start + n].view(shape)
        start += n
        rule = next((r for r in rules if re.search(r["pattern"], name)), {})
        if "value" in rule:
            out[name] = torch.full(shape, float(rule["value"]), device=device)
        elif "bound" in rule:
            out[name] = leaf * float(rule["bound"])
        else:
            out[name] = leaf * (float(rule.get("gain", 1.0)) / math.sqrt(_fan_in(name, shapes)))
    return out
