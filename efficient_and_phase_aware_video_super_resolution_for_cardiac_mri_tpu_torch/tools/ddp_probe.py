"""Whether a world-1 DDP run trains as the net alone, and whether the net alone repeats itself, on the card.

    python -m efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.ddp_probe

The setup of ``tests/test_torch_cuda.py::test_world_one_ddp_step_equals_the_unwrapped_step``
(a RefineNet of 2 layers of 8 features, 4 seeded items, one epoch of 2 Adam
steps at lr 1e-3): the unwrapped trainer twice, then the trainer with
``make_mesh(1)`` over an NCCL group of one (the net under DDP), first with
cuDNN's default algorithm choice and then with its deterministic
algorithms.  For each pair of runs it prints the parameters' largest
difference and the keys outside the test's bound (``rtol`` 1e-6, ``atol``
1e-7); the last line is one JSON object.  Needs a CUDA card.
"""
from __future__ import annotations

import json

import numpy as np
import torch
import torch.distributed as dist

RTOL, ATOL = 1e-6, 1e-7
NET = dict(in_channels=1, out_channels=1, num_features=[8, 8], upscale_factor=4, num_stages=1,
           update_memory=True, num_updated_frames=2, refine_window_size=5, positional_encoding=True)


def items(seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [{"lr_imgs": rng.standard_normal((7, 8, 8, 1)).astype(np.float32),
             "hr_imgs": rng.standard_normal((3, 32, 32, 1)).astype(np.float32),
             "pos_code": rng.uniform(-1, 1, (7, 1)).astype(np.float32)} for _ in range(4)]


def train_epoch(dev: torch.device, mesh) -> dict:
    """The test's epoch; the net's ``state_dict`` after it."""
    from ..data import Dataloader
    from ..losses import L1Loss
    from ..models.refine_net import RefineNet
    from ..runner.optim import Optimizer
    from ..runner.trainers import VSRRefineNetTrainer

    loader = Dataloader(items(), batch_size=2)
    trainer = VSRRefineNetTrainer(
        device=dev, train_dataloader=loader, valid_dataloader=loader, net=RefineNet(**NET),
        loss_fns=[L1Loss()], loss_weights=[1.0], optimizer=Optimizer("Adam", lr=1e-3),
        num_epochs=1, mesh=mesh, telemetry=False)
    trainer._run_epoch("training")
    return {k: v.detach().clone() for k, v in trainer.net.state_dict().items()}


def compare(a: dict, b: dict) -> dict:
    """The largest difference of ``a`` from ``b`` and the keys outside the
    test's bound, with their largest difference."""
    missed = {}
    for key, ref in b.items():
        diff = (a[key].double() - ref.double()).abs()
        if bool((diff > ATOL + RTOL * ref.double().abs()).any()):
            missed[key] = diff.max().item()
    largest = max((a[k].double() - v.double()).abs().max().item() for k, v in b.items())
    return {"largest": largest, "bit_equal": largest == 0.0, "missed": missed}


def main() -> dict:
    from ..parallel import make_mesh
    from ..parallel.distributed import free_port

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    before = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    out = {}
    try:
        mesh = make_mesh(1, device=dev)
        for cudnn in ("default", "deterministic"):
            torch.backends.cudnn.deterministic = cudnn == "deterministic"
            torch.backends.cudnn.benchmark = False
            first, again, wrapped = (train_epoch(dev, m) for m in (None, None, mesh))
            out[cudnn] = {"unwrapped_vs_unwrapped": compare(again, first),
                          "ddp_vs_unwrapped": compare(wrapped, first)}
            for pair, found in out[cudnn].items():
                print(f"cuDNN {cudnn}, {pair}: largest difference {found['largest']:.3e}, "
                      f"bit-equal {found['bit_equal']}, outside rtol {RTOL} atol {ATOL}: "
                      f"{found['missed'] or 'none'}", flush=True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before
        dist.destroy_process_group()
    print(json.dumps({"ddp_probe": out, "device": torch.cuda.get_device_name(0)}), flush=True)
    return out


if __name__ == "__main__":
    main()
