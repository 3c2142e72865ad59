"""A synthetic ACDC videos tree at full size, for runs on the card.

The layout of ``tests/fixtures.py:make_acdc_tree`` (videos tree only):
``videos/<split>/HR/<patient>/<patient>_2d+1d_sequenceNN.nii.gz`` and its
``LR/X<scale>`` twin (every ``scale``-th pixel), plus ``position_code.pkl``
(a cosine phase code per patient) and ``coordinates.pkl`` (a centred bbox
per patient, inside its smallest slice), written with the port's NIfTI
writer from a numpy seed.  Patients are numbered from ``patient001`` across
the splits in the order given.  Frames are square by default; a list of HR
sizes gives the slices of each patient those sizes in turn (DSB15's
heterogeneous frames, for tiled serving).
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..utils import nifti


def write_acdc_tree(root, splits: dict[str, tuple[int, int]], cycle: int = 30,
                    hr: int | list[tuple[int, int]] = 256, scale: int = 4, seed: int = 0) -> dict:
    """``splits`` maps a split name to (patients, slices per patient);
    ``hr`` is the HR frame side, or a list of (H, W) taken by slice
    ``s`` of each patient as ``hr[(s - 1) % len(hr)]``."""
    sizes = [(hr, hr)] if isinstance(hr, int) else [tuple(int(v) for v in hw) for hw in hr]
    max_h, max_w = max(h for h, _ in sizes), max(w for _, w in sizes)
    min_h, min_w = min(h for h, _ in sizes), min(w for _, w in sizes)
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
            base = rng.uniform(40, 200, size=(max_h, max_w, 1, 1)).astype(np.float32)
            for s in range(1, slices + 1):
                h, w = sizes[(s - 1) % len(sizes)]
                vol = np.clip(base[:h, :w] + wave + rng.normal(0, 10, size=(h, w, 1, cycle)), 0, 255)
                vol = vol.round().astype(np.float32)
                name = f"{patient}_2d+1d_sequence{s:0>2d}.nii.gz"
                nifti.save(vol, root / "videos" / split / "HR" / patient / name)
                nifti.save(vol[::scale, ::scale],
                           root / "videos" / split / "LR" / f"X{scale}" / patient / name)
            pos_codes[patient] = code.astype(np.float32)
            coords[patient] = (min_h // 4, 3 * min_h // 4, min_w // 4, 3 * min_w // 4)
    with open(root / "position_code.pkl", "wb") as f:
        pickle.dump(pos_codes, f)
    with open(root / "coordinates.pkl", "wb") as f:
        pickle.dump(coords, f)
    return {"videos": root / "videos", "pos_code": root / "position_code.pkl",
            "coordinates": root / "coordinates.pkl"}
