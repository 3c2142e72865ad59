"""Carry the JAX package's RefineNet weights into the port.

The JAX package keeps its weights as a flax param tree (nested dicts of
arrays, conv kernels HWIO); the port's modules keep the reference's
``state_dict`` keys with OIHW kernels.  This is the port's own copy of the
JAX package's ``utils/torch_export.refine_net_state_dict``, returning
tensors; the port's ``RefineNet.load_state_dict(..., strict=True)`` accepts
its output.  The reference's refine-block PReLU, registered but never called
(SURVEY.md §5 quirk 3), is emitted at its init value 0.2.
"""
from __future__ import annotations

import numpy as np
import torch


def _w(x) -> np.ndarray:  # HWIO → OIHW
    return np.asarray(x).transpose(3, 2, 0, 1)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def state_dict_from_jax_params(params: dict) -> dict[str, torch.Tensor]:
    """flax RefineNet ``params`` tree → the port's RefineNet state_dict."""
    sd: dict[str, np.ndarray] = {}
    sd["in_block.conv.weight"] = _w(params["in_block"]["conv"]["kernel"])
    sd["in_block.conv.bias"] = params["in_block"]["conv"]["bias"]
    sd["in_block.prelu.weight"] = params["in_block"]["prelu"]["weight"]
    for direction in ("forward", "backward"):
        cells = params[f"{direction}_lstm_block"]["cells"]
        for name, cell in cells.items():
            idx = name.replace("cell", "")
            sd[f"{direction}_lstm_block.cell_list.{idx}.conv.weight"] = _w(cell["kernel"])
            sd[f"{direction}_lstm_block.cell_list.{idx}.conv.bias"] = cell["bias"]
    for conv_name, conv in params["refine_block"].items():
        sd[f"refine_block.body.{conv_name}.weight"] = _w(conv["kernel"])
        sd[f"refine_block.body.{conv_name}.bias"] = conv["bias"]
    sd["refine_block.prelu.weight"] = np.full((1,), 0.2, np.float32)  # dead param (quirk 3)
    for conv_name, conv in params["out_block"].items():
        sd[f"out_block.{conv_name}.weight"] = _w(conv["kernel"])
        sd[f"out_block.{conv_name}.bias"] = conv["bias"]
    return {k: _t(v) for k, v in sd.items()}
