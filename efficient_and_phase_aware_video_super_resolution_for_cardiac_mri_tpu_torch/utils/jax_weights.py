"""Carry the JAX package's weights into the port.

The JAX package keeps its weights as flax variables: a ``params`` tree
(nested dicts of arrays, conv kernels HWIO or DHWIO, transposed-conv kernels
(kh, kw, in, out), BatchNorm ``scale``/``bias``) and, for the nets with
BatchNorm, a ``batch_stats`` tree of running ``mean``/``var``.  The port's
modules keep the reference's ``state_dict`` keys with OIHW / OIDHW conv
weights, (in, out, kh, kw) transposed-conv weights and BatchNorm
``weight``/``bias``/``running_mean``/``running_var``/``num_batches_tracked``.
This is the inverse of the JAX package's key maps (``utils/torch_import.py``:
RefineNet's is also its ``utils/torch_export.refine_net_state_dict``), keyed
by net name, returning tensors that the port's nets accept with
``strict=True``.  Transposed-conv kernels are permuted without a flip (the
inverse of ``torch_import._deconv_w``); PReLU weights keep their shape (1,).
The reference's RefineNet refine-block PReLU, registered but never called
(SURVEY.md §5 quirk 3), is emitted at its init value 0.2.  JAX keeps no
``num_batches_tracked``: it is written as 0 (torch's BatchNorm reads it only
when its momentum is ``None``, which no net here uses).
"""
from __future__ import annotations

import re

import numpy as np
import torch


def _w(x) -> np.ndarray:  # HWIO → OIHW, DHWIO → OIDHW
    x = np.asarray(x)
    return x.transpose(x.ndim - 1, x.ndim - 2, *range(x.ndim - 2))


def _deconv_w(x) -> np.ndarray:  # (kh, kw, in, out) → (in, out, kh, kw)
    return np.asarray(x).transpose(2, 3, 0, 1)


def _t(x) -> torch.Tensor:
    x = np.asarray(x)
    return torch.from_numpy(np.array(x, dtype=np.int64 if x.dtype.kind in "iu" else np.float32,
                                     copy=True))


def _put(sd: dict, key: str, node: dict, w=_w) -> None:
    """One flax module's leaves under the torch module path ``key``: a conv
    (``kernel`` through ``w``, ``bias``) or a PReLU (``weight``)."""
    if "kernel" in node:
        sd[f"{key}.weight"] = w(node["kernel"])
        sd[f"{key}.bias"] = node["bias"]
    else:
        sd[f"{key}.weight"] = node["weight"]


def _put_bn(sd: dict, key: str, node: dict, stats: dict | None) -> None:
    """A ``TorchBatchNorm``: ``scale``/``bias`` and, when the variables carry
    them, its running statistics."""
    sd[f"{key}.weight"] = node["scale"]
    sd[f"{key}.bias"] = node["bias"]
    if stats is not None:
        sd[f"{key}.running_mean"] = stats["mean"]
        sd[f"{key}.running_var"] = stats["var"]
        sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)


def _sub(stats: dict | None, *path: str) -> dict | None:
    """The ``batch_stats`` subtree at ``path``, or None without statistics."""
    for name in path:
        if stats is None:
            return None
        stats = stats[name]
    return stats


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
                 w=_deconv_w if m[3].startswith("deconv") else _w)
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
                _put(sd, f"{name}.{child}", leaf, w=_deconv_w if child.startswith("deconv") else _w)
        else:
            raise KeyError(f"Unmapped SRFB-family param: {name}")
    return sd


def _duf_net(params: dict, stats: dict | None) -> dict:
    """Inverse of ``torch_import.duf_net_key_map``."""
    sd: dict[str, np.ndarray] = {}
    for name, node in params.items():
        if name == "head":
            _put(sd, "head", node)
        elif name == "denseLayer":
            for block, layers in node.items():
                if block == "tail_bn":
                    _put_bn(sd, "denseLayer.tail.bn", layers, _sub(stats, name, block))
                elif block == "tail_conv":
                    _put(sd, "denseLayer.tail.conv", layers)
                elif re.fullmatch(r"conv\d+", block):
                    for layer, leaf in layers.items():
                        key = f"denseLayer.{block}.{layer}"
                        if layer.startswith("bn"):
                            _put_bn(sd, key, leaf, _sub(stats, name, block, layer))
                        else:
                            _put(sd, key, leaf)
                else:
                    raise KeyError(f"Unmapped DUFNet param: {name}.{block}")
        elif m := re.fullmatch(r"(filter|residual)_conv(\d)", name):
            _put(sd, f"{m[1]}Net.conv{m[2]}", node)
        else:
            raise KeyError(f"Unmapped DUFNet param: {name}")
    return sd


def _rbp_block(sd: dict, key: str, node: dict) -> None:
    """A ``ConvBlock``, ``DeconvBlock`` or ``ResnetBlock``: children
    ``conv``/``deconv``/``conv1``/``conv2`` and the PReLU ``act``."""
    for child, leaf in node.items():
        _put(sd, f"{key}.{child}", leaf, w=_deconv_w if child == "deconv" else _w)


def _rbp_net(params: dict, stats: dict | None) -> dict:
    """Inverse of ``torch_import.rbp_net_key_map``: each ``res_feat{k}`` is a
    sequential of its ``res{i}`` blocks, then its ``tail`` at index
    ``num_resblocks``."""
    sd: dict[str, np.ndarray] = {}
    for name, node in params.items():
        if name in ("feat0", "feat1", "output"):
            _rbp_block(sd, name, node)
        elif name == "dbp_net":
            for sub, subnode in node.items():
                if sub in ("feat1", "output"):
                    _rbp_block(sd, f"dbp_net.{sub}", subnode)
                else:  # up{i} / down{i}: their three projections
                    for conv_name, leaf in subnode.items():
                        _rbp_block(sd, f"dbp_net.{sub}.{conv_name}", leaf)
        elif re.fullmatch(r"res_feat\d", name):
            n_blocks = sum(re.fullmatch(r"res\d+", sub) is not None for sub in node)
            for sub, subnode in node.items():
                idx = n_blocks if sub == "tail" else int(sub[len("res"):])
                _rbp_block(sd, f"{name}.{idx}", subnode)
        else:
            raise KeyError(f"Unmapped RBPNet param: {name}")
    return sd


#: SpyNet block layer → its index in the reference's ``nn.Sequential``
#: (conv, BN, ReLU four times, then the flow conv)
_SPY_LAYERS = {"conv1": 0, "bn1": 1, "conv2": 3, "bn2": 4, "conv3": 6, "bn3": 7,
               "conv4": 9, "bn4": 10, "conv5": 12}


def _toflow_net(params: dict, stats: dict | None) -> dict:
    """Inverse of ``torch_import.toflow_net_key_map``."""
    sd: dict[str, np.ndarray] = {}
    for name, node in params.items():
        if name == "spy_net":
            for block, layers in node.items():
                for layer, leaf in layers.items():
                    key = f"spy_net.blocks.{block[len('block'):]}.block.{_SPY_LAYERS[layer]}"
                    if layer.startswith("bn"):
                        _put_bn(sd, key, leaf, _sub(stats, name, block, layer))
                    else:
                        _put(sd, key, leaf)
        elif m := re.fullmatch(r"out_conv(\d)", name):
            _put(sd, f"out_block.{2 * (int(m[1]) - 1)}", node)
        else:
            raise KeyError(f"Unmapped TOFlowNet param: {name}")
    return sd


def _drf_net(params: dict) -> dict:
    """Inverse of ``torch_import.drf_net_key_map``: the ``in_block`` sits at
    the top, the feedback block and the upsampler under the scan's
    ``steps``."""
    return _srfb_like({**{k: v for k, v in params.items() if k != "steps"}, **params["steps"]},
                      "in_block")


def _frvsr_net(params: dict) -> dict:
    """Inverse of ``torch_import.frvsr_net_key_map``: FNet and SRNet under
    the scan's ``steps``."""
    sd: dict[str, np.ndarray] = {}
    for name, node in params["steps"]["fnet"].items():
        if m := re.fullmatch(r"tail_(conv\d)", name):
            _put(sd, f"fnet.tail.{m[1]}", node)
        elif re.fullmatch(r"conv\d_\d", name):
            _put(sd, f"fnet.body.{name}", node)
        else:
            raise KeyError(f"Unmapped FRVSRNet param: steps.fnet.{name}")
    for name, node in params["steps"]["srnet"].items():
        if name == "head":
            _put(sd, "srnet.head.conv", node)
        elif name == "tail":
            _put(sd, "srnet.tail.conv", node)
        elif re.fullmatch(r"deconv\d", name):
            _put(sd, f"srnet.tail.{name}", node, w=_deconv_w)
        elif m := re.fullmatch(r"resblock(\d+)", name):
            for conv_name, conv in node.items():
                _put(sd, f"srnet.body.{m[1]}.body.{conv_name}", conv)
        else:
            raise KeyError(f"Unmapped FRVSRNet param: steps.srnet.{name}")
    return sd


#: EDVRNet's top-level plain convs (the non-TSA 1x1 fusion conv is a conv
#: named ``tsa_fusion`` too)
_EDVR_TOP_CONVS = {
    "conv_first", "conv_first_1", "conv_first_2", "conv_first_3", "conv_1x1",
    "fea_L2_conv1", "fea_L2_conv2", "fea_L3_conv1", "fea_L3_conv2",
    "upconv1", "upconv2", "HRconv", "conv_last",
}


def _edvr_net(params: dict) -> dict:
    """Inverse of ``torch_import.edvr_net_key_map``: ``feature_extraction{i}``
    and ``recon_trunk{i}`` become sequential indices; a DCN pack's raw
    ``weight`` (k, k, Cin, Cout) becomes OIHW beside its ``bias`` and its
    ``conv_offset_mask``."""
    sd: dict[str, np.ndarray] = {}
    for name, node in params.items():
        if m := re.fullmatch(r"(feature_extraction|recon_trunk)(\d+)", name):
            for conv_name, conv in node.items():
                _put(sd, f"{m[1]}.{m[2]}.{conv_name}", conv)
        elif name == "pcd_align":
            for sub, subnode in node.items():
                if sub.endswith("_dcnpack"):
                    _put(sd, f"pcd_align.{sub}.conv_offset_mask", subnode["conv_offset_mask"])
                    sd[f"pcd_align.{sub}.weight"] = _w(subnode["weight"])
                    sd[f"pcd_align.{sub}.bias"] = subnode["bias"]
                else:
                    _put(sd, f"pcd_align.{sub}", subnode)
        elif name in ("tsa_fusion", "pre_deblur") and "kernel" not in node:
            for sub, subnode in node.items():
                if sub.startswith("RB_"):
                    for conv_name, conv in subnode.items():
                        _put(sd, f"{name}.{sub}.{conv_name}", conv)
                else:
                    _put(sd, f"{name}.{sub}", subnode)
        elif name in _EDVR_TOP_CONVS or name == "tsa_fusion":
            _put(sd, name, node)
        else:
            raise KeyError(f"Unmapped EDVRNet param: {name}")
    return sd


_NETS = {
    "RefineNet": lambda params, stats: _refine_net(params),
    "EDSRNet": lambda params, stats: _edsr_net(params),
    "SRFBNet": lambda params, stats: _srfb_like(params, "lrf_block"),
    "DRFSISRNet": lambda params, stats: _srfb_like(params, "in_block"),
    "DUFNet": _duf_net,
    "RBPNet": _rbp_net,
    "TOFlowNet": _toflow_net,
    "EDVRNet": lambda params, stats: _edvr_net(params),
    "DRFNet": lambda params, stats: _drf_net(params),
    "FRVSRNet": lambda params, stats: _frvsr_net(params),
}


def state_dict_from_jax_params(tree: dict, net: str = "RefineNet") -> dict[str, torch.Tensor]:
    """The flax weights of the net named ``net`` → the port's state_dict.

    ``tree`` is a ``params`` tree, or a flax ``variables`` dict
    (``{'params': ..., 'batch_stats': ...}``; a ``telemetry`` collection,
    which ``init`` of a net with ``max_flow`` sows, holds no weight and is
    ignored).  BatchNorm running statistics come only from ``batch_stats``:
    a ``params`` tree alone gives the parameters' keys (a gradient tree maps
    the same way), which a BatchNorm net then refuses to load with
    ``strict=True``."""
    if net not in _NETS:
        raise KeyError(f"No JAX weight map for net {net!r}; have {sorted(_NETS)}")
    params, stats = tree, None
    if "params" in tree and set(tree) <= {"params", "batch_stats", "telemetry"}:
        params, stats = tree["params"], tree.get("batch_stats")
    return {k: _t(v) for k, v in _NETS[net](params, stats).items()}
