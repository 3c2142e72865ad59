"""Cardiac-phase positional encoding CLI, the port's copy of the JAX
package's ``tools/gen_positional_encoding.py`` (reference
``src/gen_positional_encoding.py``).

Per patient: the cardiac phase from the Otsu masks of frame 0 against the
frames in [0.25T, 0.6T) inside the heart's bbox; end-systole = the frame
whose mask differs most; a cosine code — cos(0→π) over systole, then
cos(π→2π) over diastole, rolled to start — written as
``position_code.pkl`` {patient: (T,) float array}.  The blur and the
threshold run on uint8 through ``tools/imgproc.py`` (OpenCV's fixed-point
blur, bit for bit): one flipped mask pixel could move the end-systole anchor.

    python -m <torch pkg>.tools.gen_positional_encoding DATA_DIR COORDS_PKL OUT_DIR
"""
from __future__ import annotations

import argparse
import logging
import pickle
from pathlib import Path

import numpy as np

from ..utils import nifti
from . import imgproc

LOG = logging.getLogger(__name__)


def _mask(frame: np.ndarray) -> np.ndarray:
    return imgproc.threshold_otsu(imgproc.gaussian_blur_5x5(frame.astype(np.uint8)))[1]


def phase_code(data: np.ndarray, bbox: tuple[int, int, int, int]) -> np.ndarray:
    """(H, W, 1, T) HR sequence + heart bbox → (T,) cosine phase code
    (reference ``:24-38``)."""
    h0, hn, w0, wn = bbox
    T = data.shape[-1]
    mask1 = _mask(data[h0:hn, w0:wn, 0, 0])
    diffs = []
    for i in range(int(np.floor(T * 0.25)), int(np.ceil(T * 0.6))):
        mask2 = _mask(data[h0:hn, w0:wn, 0, i])
        diffs.append(int(np.sum(np.abs(mask1 - mask2))))
    start, end = 0, int(np.argmax(diffs)) + int(np.floor(T * 0.25))

    y1 = np.cos(np.linspace(0, np.pi, end - start, endpoint=False))
    y2 = np.cos(np.linspace(np.pi, 2 * np.pi, T - y1.shape[0], endpoint=False))
    code = np.concatenate((y1, y2))
    return np.concatenate((code[-start:], code[:-start])) if start else code


def main(data_dir: Path, coordinate_path: Path, output_dir: Path):
    with open(coordinate_path, "rb") as f:
        coordinates = pickle.load(f)
    pos_codes = {}
    for patient_dir in sorted(Path(data_dir).glob("**/HR/*")):
        patient_name = patient_dir.parts[-1]
        LOG.info(f"Process {patient_name}.")
        data_paths = sorted(patient_dir.glob("**/*2d+1d*.nii.gz"))
        data = np.asarray(nifti.load(data_paths[0]).get_data(), np.float32)
        pos_codes[patient_name] = phase_code(data, coordinates[patient_name])
    Path(output_dir).mkdir(parents=True, exist_ok=True)
    with open(Path(output_dir) / "position_code.pkl", "wb") as f:
        pickle.dump(pos_codes, f)
    return pos_codes


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Positional encoding generation.")
    parser.add_argument("data_dir", type=Path)
    parser.add_argument("coordinate_path", type=Path)
    parser.add_argument("output_dir", type=Path)
    return parser.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(message)s", level=logging.INFO,
                        datefmt="%Y-%m-%d %H:%M:%S")
    args = _parse_args()
    main(args.data_dir, args.coordinate_path, args.output_dir)
