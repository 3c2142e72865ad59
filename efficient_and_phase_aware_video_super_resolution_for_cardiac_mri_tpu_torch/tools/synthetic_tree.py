"""A synthetic ACDC videos tree at full size, for runs on the card.

The layout of ``tests/fixtures.py:make_acdc_tree`` (videos tree only):
``videos/<split>/HR/<patient>/<patient>_2d+1d_sequenceNN.nii.gz`` and its
``LR/X<scale>`` twin (every ``scale``-th pixel), plus ``position_code.pkl``
(a cosine phase code per patient) and ``coordinates.pkl`` (a centred bbox
per patient), written with the port's NIfTI writer from a numpy seed.
Patients are numbered from ``patient001`` across the splits in the order
given.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..utils import nifti


def write_acdc_tree(root, splits: dict[str, tuple[int, int]], cycle: int = 30, hr: int = 256,
                    scale: int = 4, seed: int = 0) -> dict:
    """``splits`` maps a split name to (patients, slices per patient)."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    end = int(cycle * 0.4)
    code = np.concatenate([np.cos(np.linspace(0, np.pi, end, endpoint=False)),
                           np.cos(np.linspace(np.pi, 2 * np.pi, cycle - end, endpoint=False))])
    wave = 40 * np.sin(np.linspace(0, 2 * np.pi, cycle, endpoint=False)).astype(np.float32)
    pos_codes, coords = {}, {}
    pid = 0
    for split, (patients, slices) in splits.items():
        for _ in range(patients):
            pid += 1
            patient = f"patient{pid:03d}"
            base = rng.uniform(40, 200, size=(hr, hr, 1, 1)).astype(np.float32)
            for s in range(1, slices + 1):
                vol = np.clip(base + wave + rng.normal(0, 10, size=(hr, hr, 1, cycle)), 0, 255)
                vol = vol.round().astype(np.float32)
                name = f"{patient}_2d+1d_sequence{s:0>2d}.nii.gz"
                nifti.save(vol, root / "videos" / split / "HR" / patient / name)
                nifti.save(vol[::scale, ::scale],
                           root / "videos" / split / "LR" / f"X{scale}" / patient / name)
            pos_codes[patient] = code.astype(np.float32)
            coords[patient] = (hr // 4, 3 * hr // 4, hr // 4, 3 * hr // 4)
    with open(root / "position_code.pkl", "wb") as f:
        pickle.dump(pos_codes, f)
    with open(root / "coordinates.pkl", "wb") as f:
        pickle.dump(coords, f)
    return {"videos": root / "videos", "pos_code": root / "position_code.pkl",
            "coordinates": root / "coordinates.pkl"}
