"""Synthetic beating-heart phantom generator, the port's copy of the JAX
package's ``tools/gen_synthetic_data.py``.

Writes a raw ACDC-style tree (``training/patientXXX/patientXXX_4d.nii.gz``
and ``testing/...``, int16: the layout ``acdc_preprocess`` reads) of cine
phantoms, then runs the port's offline pipeline on it:
``tools/acdc_preprocess`` (99.5%-CDF clip, /12 crop, k-space degradation),
``tools/cardiac_cropping`` (motion bbox, cropped GIFs) and
``tools/gen_positional_encoding`` (Otsu end-systole cosine code), so every
shipped config trains and evaluates with no real data.  For the same
arguments the raw tree, the preprocessed trees and both pickles are
byte-equal to the JAX tool's, and the GIFs decode to the same frames.

The phantom is learnable: a contracting blood pool and a thickening
myocardial ring give sharp moving boundaries, and a fixed mid-frequency
speckle fills each tissue (the content the k-space truncation destroys), so
a net trained from scratch beats Bicubic on the held-out test split
(``tools/convergence.py``).  Per frame: background, an elliptic torso with
an intensity gradient, a dark myocardium ring, a bright LV pool whose radius
follows a raised-cosine cycle peaking at end-systole (0.4·T); ~1 px
smooth-stepped boundaries.

``--layout dsb15`` writes the same phantoms as a DSB15 tree instead
(``{train,test}/<patient>/sax_NN/sax_NN.nii.gz``, one (H, W, 1, T) series a
slice, patients numbered 1, 2, ... in train and 701, 702, ... in test, the
layout ``dsb15_dicom2nifty`` leaves) and preprocesses it with
``tools/dsb15_preprocess`` (which skips series of fewer than 30 frames).

    python -m <torch pkg>.tools.gen_synthetic_data OUT_DIR \
        [--patients-train 4] [--patients-test 2] [--size 96] [--slices 2] \
        [--frames 16] [--factors 2 3 4] [--seed 0] [--raw-only] [--layout acdc]

Layout written under OUT_DIR:
    raw/               the int16 phantoms
    preprocessed/      imgs/ + videos/ HR/LR trees + position_code.pkl
    cropped/           per-patient GIFs + coordinates.pkl
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from ..utils import nifti

LOG = logging.getLogger(__name__)

#: the first patient number of each split of a DSB15 tree (the challenge's
#: train, validate and test patients start at 1, 501 and 701)
DSB15_FIRST_PATIENT = {"train": 1, "valid": 501, "test": 701}


def _smooth_noise(rng: np.random.Generator, h: int, w: int, sigma: float = 1.0) -> np.ndarray:
    """Mid-frequency speckle in [-1, 1]: white noise, separably blurred."""
    field = rng.standard_normal((h, w)).astype(np.float32)
    # separable gaussian blur without scipy/cv2 (radius 3*sigma)
    r = max(1, int(round(3 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    field = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 0, field)
    field = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 1, field)
    m = np.abs(field).max()
    return field / (m if m else 1.0)


def _smoothstep(d: np.ndarray, width: float = 1.0) -> np.ndarray:
    """Soft inside-mask from a signed 'radius - distance' map (≈1 px edge)."""
    return 1.0 / (1.0 + np.exp(np.clip(-4.0 * d / width, -60.0, 60.0)))


def phantom_volume(
    rng: np.random.Generator, size: int = 96, slices: int = 2, frames: int = 16,
) -> np.ndarray:
    """One patient's (H, W, D, T) int16 cine phantom."""
    H = W = size
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)

    # cardiac cycle: contraction 0 -> 1 at end-systole (0.4 T) -> 0
    t_es = max(1, int(round(0.4 * frames)))
    t = np.arange(frames)
    contraction = np.where(
        t <= t_es,
        (1 - np.cos(np.pi * t / t_es)) / 2,
        (1 + np.cos(np.pi * (t - t_es) / max(1, frames - t_es))) / 2,
    ).astype(np.float32)

    vol = np.empty((H, W, slices, frames), np.float32)
    torso_cy, torso_cx = H / 2 + rng.uniform(-2, 2), W / 2 + rng.uniform(-2, 2)
    torso_ay, torso_ax = 0.42 * H * rng.uniform(0.95, 1.05), 0.45 * W * rng.uniform(0.95, 1.05)
    grad_dir = rng.uniform(0, 2 * np.pi)
    for s in range(slices):
        # heart placement drifts slightly through the stack
        cy = torso_cy + rng.uniform(-0.04, 0.04) * H
        cx = torso_cx + rng.uniform(-0.04, 0.04) * W
        r_pool0 = 0.14 * size * rng.uniform(0.9, 1.1)      # end-diastole pool radius
        r_myo0 = r_pool0 + 0.06 * size * rng.uniform(0.9, 1.1)
        tex = _smooth_noise(rng, H, W)
        d_heart = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        d_torso = np.sqrt(((yy - torso_cy) / torso_ay) ** 2 + ((xx - torso_cx) / torso_ax) ** 2)
        torso = _smoothstep(1.0 - d_torso, width=2.0 / min(torso_ay, torso_ax))
        gradient = 25.0 * (
            np.cos(grad_dir) * (xx - W / 2) / W + np.sin(grad_dir) * (yy - H / 2) / H
        )
        for k in range(frames):
            r_pool = r_pool0 * (1 - 0.45 * contraction[k])
            # incompressible wall: ring area conserved, so it thickens at systole
            r_myo = np.sqrt(r_pool**2 + (r_myo0**2 - r_pool0**2))
            pool = _smoothstep(r_pool - d_heart)
            myo = _smoothstep(r_myo - d_heart) - pool
            img = (
                8.0
                + torso * (102.0 + gradient + 18.0 * tex)
                + myo * (60.0 + 10.0 * tex - (102.0 + gradient + 18.0 * tex))
                + pool * (225.0 + 12.0 * tex - (102.0 + gradient + 18.0 * tex))
                + rng.normal(0, 2.0, size=(H, W)).astype(np.float32)
            )
            vol[:, :, s, k] = img
    # int16 with headroom so acdc_preprocess's 99.5%-CDF histogram path runs
    return np.clip(vol * 4.0, 0, 4 * 255).round().astype(np.int16)


def gen_raw_tree(
    out_dir: Path, patients_train: int, patients_test: int,
    size: int, slices: int, frames: int, seed: int,
) -> Path:
    """Write the raw ACDC-style 4d tree; returns its root."""
    rng = np.random.default_rng(seed)
    raw = Path(out_dir) / "raw"
    pid = 0
    for split, n in (("training", patients_train), ("testing", patients_test)):
        for _ in range(n):
            pid += 1
            name = f"patient{pid:03d}"
            LOG.info(f"Generate {name} ({split}).")
            vol = phantom_volume(rng, size=size, slices=slices, frames=frames)
            nifti.save(vol, raw / split / name / f"{name}_4d.nii.gz")
    return raw


def gen_dsb15_raw_tree(out_dir: Path, patients: dict, size: int, slices: int, frames: int,
                       seed: int) -> Path:
    """Write a raw DSB15 tree of phantoms, ``patients`` ({split: count})
    per split in its order, each slice a (H, W, 1, T) series
    ``<split>/<patient>/sax_NN/sax_NN.nii.gz``; returns its root."""
    rng = np.random.default_rng(seed)
    raw = Path(out_dir) / "raw"
    for split, n in patients.items():
        for k in range(n):
            name = str(DSB15_FIRST_PATIENT[split] + k)
            LOG.info(f"Generate {name} ({split}).")
            vol = phantom_volume(rng, size=size, slices=slices, frames=frames)
            for s in range(slices):
                series = f"sax_{s + 1:02d}"
                nifti.save(vol[:, :, s : s + 1], raw / split / name / series / f"{series}.nii.gz")
    return raw


def main(
    out_dir: Path, patients_train: int = 4, patients_test: int = 2,
    size: int = 96, slices: int = 2, frames: int = 16,
    factors=(2, 3, 4), seed: int = 0, raw_only: bool = False, layout: str = "acdc",
) -> dict:
    """Generate, and unless ``raw_only`` run the offline pipeline; returns
    the paths configs need: the videos and imgs trees, coordinates.pkl and
    position_code.pkl."""
    if size % 12:
        raise ValueError(f"size must be a multiple of 12 (the /12 center crop); got {size}")
    if layout not in ("acdc", "dsb15"):
        raise ValueError(f"layout must be acdc or dsb15, got {layout!r}")
    out_dir = Path(out_dir)
    if layout == "acdc":
        raw = gen_raw_tree(out_dir, patients_train, patients_test, size, slices, frames, seed)
    else:
        raw = gen_dsb15_raw_tree(out_dir, {"train": patients_train, "test": patients_test},
                                 size, slices, frames, seed)
    if raw_only:
        return {"raw_dir": raw}

    from . import acdc_preprocess, cardiac_cropping, dsb15_preprocess, gen_positional_encoding

    pre, crop = out_dir / "preprocessed", out_dir / "cropped"
    (acdc_preprocess if layout == "acdc" else dsb15_preprocess).main(raw, pre, factors=tuple(factors))
    cardiac_cropping.main(pre / "videos", crop)
    gen_positional_encoding.main(pre / "videos", crop / "coordinates.pkl", pre)
    return {
        "raw_dir": raw,
        "videos_dir": pre / "videos",
        "imgs_dir": pre / "imgs",
        "coordinates_path": crop / "coordinates.pkl",
        "pos_code_path": pre / "position_code.pkl",
    }


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Synthetic cardiac phantom data generation.")
    parser.add_argument("out_dir", type=Path)
    parser.add_argument("--patients-train", type=int, default=4)
    parser.add_argument("--patients-test", type=int, default=2)
    parser.add_argument("--size", type=int, default=96)
    parser.add_argument("--slices", type=int, default=2)
    parser.add_argument("--frames", type=int, default=16)
    parser.add_argument("--factors", type=int, nargs="+", default=[2, 3, 4])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--raw-only", action="store_true")
    parser.add_argument("--layout", choices=("acdc", "dsb15"), default="acdc")
    return parser.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(message)s", level=logging.INFO,
                        datefmt="%Y-%m-%d %H:%M:%S")
    a = _parse_args()
    main(a.out_dir, a.patients_train, a.patients_test, a.size, a.slices,
         a.frames, tuple(a.factors), a.seed, a.raw_only, a.layout)
