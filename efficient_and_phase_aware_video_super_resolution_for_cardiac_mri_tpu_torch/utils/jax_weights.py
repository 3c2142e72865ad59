"""Carry the JAX package's weights into the port.

The JAX package keeps its weights as a flax param tree (nested dicts of
arrays, conv kernels HWIO, transposed-conv kernels (kh, kw, in, out)); the
port's modules keep the reference's ``state_dict`` keys with OIHW conv
weights and (in, out, kh, kw) transposed-conv weights.  This is the inverse
of the JAX package's key maps (``utils/torch_import.py``: RefineNet's is
also its ``utils/torch_export.refine_net_state_dict``), keyed by net name,
returning tensors that the port's nets accept with ``strict=True``.
Transposed-conv kernels are permuted without a flip (the inverse of
``torch_import._deconv_w``); PReLU weights keep their shape (1,).  The
reference's RefineNet refine-block PReLU, registered but never called
(SURVEY.md §5 quirk 3), is emitted at its init value 0.2.
"""
from __future__ import annotations

import re

import numpy as np
import torch


def _w(x) -> np.ndarray:  # HWIO → OIHW
    return np.asarray(x).transpose(3, 2, 0, 1)


def _deconv_w(x) -> np.ndarray:  # (kh, kw, in, out) → (in, out, kh, kw)
    return np.asarray(x).transpose(2, 3, 0, 1)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _put(sd: dict, key: str, node: dict, deconv: bool = False) -> None:
    """One flax module's leaves under the torch module path ``key``: a conv
    (``kernel``, ``bias``) or a PReLU (``weight``)."""
    if "kernel" in node:
        sd[f"{key}.weight"] = (_deconv_w if deconv else _w)(node["kernel"])
        sd[f"{key}.bias"] = node["bias"]
    else:
        sd[f"{key}.weight"] = node["weight"]


def _refine_net(params: dict) -> dict:
    sd: dict[str, np.ndarray] = {}
    _put(sd, "in_block.conv", params["in_block"]["conv"])
    _put(sd, "in_block.prelu", params["in_block"]["prelu"])
    for direction in ("forward", "backward"):
        cells = params[f"{direction}_lstm_block"]["cells"]
        for name, cell in cells.items():
            idx = name.replace("cell", "")
            _put(sd, f"{direction}_lstm_block.cell_list.{idx}.conv", cell)
    for conv_name, conv in params["refine_block"].items():
        _put(sd, f"refine_block.body.{conv_name}", conv)
    sd["refine_block.prelu.weight"] = np.full((1,), 0.2, np.float32)  # dead param (quirk 3)
    for conv_name, conv in params["out_block"].items():
        _put(sd, f"out_block.{conv_name}", conv)
    return sd


def _edsr_net(params: dict) -> dict:
    """Inverse of ``torch_import.edsr_net_key_map``."""
    sd: dict[str, np.ndarray] = {}
    for name, node in params.items():
        if name == "head":
            _put(sd, "head.0", node)
        elif name == "body_conv":
            _put(sd, "body.conv", node)
        elif name == "tail_conv":
            _put(sd, "tail.conv", node)
        elif m := re.fullmatch(r"resblock(\d+)", name):
            for conv_name, conv in node.items():
                _put(sd, f"body.{m[1]}.body.{conv_name}", conv)
        elif m := re.fullmatch(r"up_conv(\d+)", name):
            _put(sd, f"tail.0.conv{m[1]}", node)
        else:
            raise KeyError(f"Unmapped EDSRNet param: {name}")
    return sd


def _f_block(sd: dict, params: dict) -> None:
    """Inverse of ``torch_import._srfb_fblock``."""
    for name, node in params.items():
        if m := re.fullmatch(r"(in|out)_(conv|prelu)", name):
            _put(sd, f"f_block.{m[1]}_block.{m[2]}", node)
        elif m := re.fullmatch(r"(up|down)(\d+)_(\w+)", name):
            _put(sd, f"f_block.{m[1]}_blocks.{m[2]}.{m[3]}", node,
                 deconv=m[3].startswith("deconv"))
        else:
            raise KeyError(f"Unmapped feedback-block param: {name}")


def _srfb_like(params: dict, in_block_name: str) -> dict:
    """Inverse of ``torch_import._srfb_like_key_map`` (SRFBNet: ``lrf_block``
    and ``r_block``; DRFSISRNet: ``in_block`` and the ``out_block``
    upsampler)."""
    sd: dict[str, np.ndarray] = {}
    for name, node in params.items():
        if name == in_block_name:
            for child, leaf in node.items():
                _put(sd, f"{name}.{child}", leaf)
        elif name == "f_block":
            _f_block(sd, node)
        elif name in ("r_block", "out_block"):
            for child, leaf in node.items():
                _put(sd, f"{name}.{child}", leaf, deconv=child.startswith("deconv"))
        else:
            raise KeyError(f"Unmapped SRFB-family param: {name}")
    return sd


_NETS = {
    "RefineNet": _refine_net,
    "EDSRNet": _edsr_net,
    "SRFBNet": lambda params: _srfb_like(params, "lrf_block"),
    "DRFSISRNet": lambda params: _srfb_like(params, "in_block"),
}


def state_dict_from_jax_params(params: dict, net: str = "RefineNet") -> dict[str, torch.Tensor]:
    """flax ``params`` tree of the net named ``net`` → the port's state_dict."""
    if net not in _NETS:
        raise KeyError(f"No JAX weight map for net {net!r}; have {sorted(_NETS)}")
    return {k: _t(v) for k, v in _NETS[net](params).items()}
