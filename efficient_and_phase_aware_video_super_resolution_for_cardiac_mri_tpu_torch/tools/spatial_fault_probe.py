"""How far a faulted halo moves the bf16 spatial runs of TOFlow, FRVSR and EDVR, on the card.

    python -m efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.spatial_fault_probe

Runs ``chip_smoke.py`` phase 36's three bf16 test YAMLs (TOFlow and FRVSR
with ``max_flow: 4``, EDVR with ``dcn_max_offset: 2``) at full width on its
8-frame slice: meshless, then on ``chip_smoke.SPATIAL`` gloo ranks sharing
the card twice, as the port runs them and with a fault, the halo rows of
every windowed warp (TOFlow, FRVSR) or of every DCN band (EDVR) zeroed at
the band edges inside the frame.  For each run it prints the first item's
gathered SR against the meshless forward's (largest difference over the
largest value: phase 36's ``sr_rel``; and in norm) and the Test log's largest gap
(relative; the SSIMs absolute), so that phase 36's bf16 bounds
(``chip_smoke.TOL_VIDEO_BF16_*``) can be set between the sound and the
faulted readings.  The last line is one JSON object.  Needs a CUDA card and
a checkout (it imports ``chip_smoke.py``).
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import _build

KEYS = ("TOFlowNet_tpu", "FRVSRNet_tpu", "EDVRNet_tpu")


def _chip_smoke():
    path = _build.PACKAGE_DIR.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def break_halos() -> None:
    """Zero the rows that a band borrows from its neighbours in every
    windowed warp (``ops/warp.halo_rows``) and every DCN band
    (``ops/deform_conv.spatial_operand``); the frame's own border rows and
    every conv's halo stay as they are."""
    from ..ops import deform_conv, warp

    rows_of = warp.halo_rows

    def zeroed_rows(x, k, axis, mode="zeros"):
        xh = rows_of(x, k, axis, mode).clone()
        if axis.index > 0:
            xh[..., :k, :] = 0
        if axis.index < axis.size - 1:
            xh[..., xh.shape[-2] - k:, :] = 0
        return xh

    operand_of = deform_conv.spatial_operand

    def zeroed_operand(x, kh, padding, max_offset, axis):
        xb, pad_h, kind = operand_of(x, kh, padding, max_offset, axis)
        if kind == "band":
            above = padding - pad_h
            below = xb.shape[-2] - x.shape[-2] - above
            xb = xb.clone()
            xb[..., :above, :] = 0
            xb[..., xb.shape[-2] - below:, :] = 0
        return xb, pad_h, kind

    warp.halo_rows = zeroed_rows
    deform_conv.spatial_operand = zeroed_operand


def probe_rank(eval_cfgs: dict, device: str, fault: bool) -> dict:
    """One of the ranks: phase 36's rank on ``eval_cfgs``, its halos
    broken first when ``fault``."""
    if fault:
        break_halos()
    return _chip_smoke().spatial_zoo_rank(eval_cfgs, {}, device)


def main() -> None:
    from .. import main as port_main
    from .. import models
    from ..config import Cfg
    from ..parallel import distributed
    from ..tools.synthetic_tree import write_acdc_tree
    from . import spatial_fault_probe as this  # the ranks import it by name

    cs = _chip_smoke()
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="spatial_fault_"))
    tree = write_acdc_tree(tmp / "zoo", {"test": (1, 1)}, cycle=cs.ZOO_CYCLE, hr=cs.HR,
                           scale=cs.SCALE)
    cs.deterministic_cudnn(torch)
    meshless, cfgs = {}, {}
    for key in KEYS:
        name = cs.VIDEO_NETS[key][0]
        ckpt = tmp / f"{name}.pth"
        if not ckpt.exists():
            net = {"EDVRNet": lambda: cs.seeded_edvr(cs.EDVR_NET),
                   "TOFlowNet": lambda: cs.seeded_misr_net(models.TOFlowNet,
                                                           cs.MISR_NETS[name]),
                   "FRVSRNet": lambda: models.FRVSRNet(
                       **cs.VSR_NETS[name], generator=torch.Generator().manual_seed(0))}[name]()
            torch.save({"net": net.state_dict()}, ckpt)
        pred = port_main.test_from_config(Cfg(cs.video_eval_config(
            tree, key, ckpt, tmp / f"meshless_{key}", dev)))
        meshless[key] = {"log": pred.log, "sr": cs._first_sr(pred)}
        del pred
        cfg = cs.video_eval_config(tree, key, ckpt, tmp / f"spatial_{key}", dev)
        cfg["parallel"] = {"num_devices": cs.SPATIAL, "spatial_parallel": cs.SPATIAL}
        cfgs[key] = cfg
    result = {"card": card}
    for fault in (False, True):
        ranks = distributed.spawn(this.probe_rank, (cfgs, str(dev), fault), world=cs.SPATIAL,
                                  device=dev, backend="gloo")
        run = "faulted" if fault else "sound"
        for key in KEYS:
            got, want = ranks["eval"][key], meshless[key]
            diff = got["sr"] - want["sr"]
            sr_rel = (diff.abs().max() / want["sr"].abs().max()).item()
            sr_norm = (diff.norm() / want["sr"].norm()).item()
            gaps = {k: abs(got["log"][k] - v) / (1.0 if "SSIM" in k else abs(v))
                    for k, v in want["log"].items()}
            log_key = max(gaps, key=gaps.get)
            result.setdefault(key, {})[run] = {"sr_rel": sr_rel, "sr_norm": sr_norm,
                                               "log_gap": gaps[log_key], "log_key": log_key}
            print(f"{key} {run}: SR {sr_rel:.3e} of the largest value, {sr_norm:.3e} in norm; "
                  f"Test log's largest "
                  f"gap {gaps[log_key]:.3e} ({log_key}); exchanges {got['exchanges']}, "
                  f"DCN calls {got['dcn_calls']} ({card})", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
