"""What the entries share: the net's layout, seeded weights, operation
counts and the reference's numeric mode."""
from __future__ import annotations

import contextlib
import importlib

import torch

from ..reference import ops
from . import weights
from .context import program


def build_net(net_cfg: dict, device):
    """The program's net, constructed on ``device`` (its own init runs there
    from a fixed device generator, to be overwritten by the seeded weights;
    on the meta device its ``normal_`` would load torch's compiler stack)."""
    program("main")._import_components()
    nets = program("config").NETS
    with torch.device(device):
        return nets.get(net_cfg["name"])(
            **net_cfg["kwargs"], generator=torch.Generator(device=device).manual_seed(0))


def shapes_of(net) -> dict:
    """Leaf name → shape of the net's ``state_dict`` (the published code's
    layout)."""
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


def seeded_weights(cfg: dict, shapes: dict, seed: int, device) -> dict:
    return weights.draw(shapes, cfg.get("weights", []), seed, device)


def reference(cfg: dict):
    """The configuration's plain reference module (``reference/<name>.py``,
    named by its ``reference`` key): ``NET``, ``loss`` and ``item_frames``."""
    return importlib.import_module(f"h100_bench.reference.{cfg['reference']}")


def reference_net(cfg: dict, params: dict):
    return reference(cfg).NET(params, cfg["net"]["kwargs"])


@contextlib.contextmanager
def numerics(tf32: bool):
    """fp32 with TF32 off (the configurations' precision), or TF32 on (the
    control: the next precision down)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def count_ops(cfg: dict, shapes: dict, fn, train: bool, items: int) -> int:
    """Operations of ``fn(net, cut)`` for ``items`` items, run by the
    reference on the CPU on one item whose frame sides ``fn`` divides by
    ``cut`` (the largest of 8, 4, 2, 1 that the net takes): every counted
    operation grows linearly with the batch and the frame's area.  With
    ``train`` the backward products autograd runs are counted too."""
    params = {k: torch.zeros(s, requires_grad=train) for k, s in shapes.items()}
    net = reference_net(cfg, params)
    for cut in (8, 4, 2, 1):
        try:
            with ops.counting() as box, torch.set_grad_enabled(train):
                fn(net, cut)
        except ValueError:
            continue
        return int(box[0]) * items * cut * cut
    raise ValueError("no frame size the reference takes")
