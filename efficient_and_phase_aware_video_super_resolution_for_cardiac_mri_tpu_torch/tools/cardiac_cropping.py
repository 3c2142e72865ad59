"""Cardiac bounding-box CLI, the port's copy of the JAX package's
``tools/cardiac_cropping.py`` (reference ``src/cardiac_cropping.py``).

Per patient: the motion bbox of the heart from frame 0 against frame T/2 —
Gaussian blur, abs-diff, Otsu threshold, morphological close then open, 5%
outlier trim, box = mean ± 2.5·std of the active pixels' coordinates;
writes cropped GIFs (``utils/imgio.py``) and
``coordinates.pkl`` {patient: (h0, hn, w0, wn)} used by CardiacPSNR/SSIM.
:func:`find_bbox` needs nothing but numpy: its OpenCV operations are
``tools/imgproc.py``'s twins, so it gives the JAX tool's box.

    python -m <torch pkg>.tools.cardiac_cropping DATA_DIR OUTPUT_DIR
"""
from __future__ import annotations

import argparse
import logging
import pickle
from pathlib import Path

import numpy as np

from ..utils import imgio, nifti
from . import imgproc

LOG = logging.getLogger(__name__)


def find_bbox(data: np.ndarray) -> tuple[int, int, int, int]:
    """(H, W, 1, T) HR sequence → motion bbox (reference ``:43-61``)."""
    hmax, wmax, _, num_frames = data.shape
    img1 = data[..., 0].squeeze()
    img2 = data[..., num_frames // 2].squeeze()
    smoothed1 = imgproc.gaussian_blur_5x5(img1)
    smoothed2 = imgproc.gaussian_blur_5x5(img2)
    diff = np.abs(smoothed1 - smoothed2).astype(np.uint8)
    _, mask = imgproc.threshold_otsu(diff)
    opened = imgproc.morph_open(imgproc.morph_close(mask))

    xsets, ysets = np.where(opened)
    xsets = xsets[int(len(xsets) * 0.05): int(len(xsets) * 0.95)]
    ysets = ysets[int(len(ysets) * 0.05): int(len(ysets) * 0.95)]

    height, width = int(np.std(xsets).round() * 5), int(np.std(ysets).round() * 5)
    hc, wc = int(np.mean(xsets).round()), int(np.mean(ysets).round())
    h0, hn = max(0, hc - height // 2), min(hc + (height - height // 2), hmax)
    w0, wn = max(0, wc - width // 2), min(wc + (width - width // 2), wmax)
    return h0, hn, w0, wn


def main(data_dir: Path, output_dir: Path):
    coordinates = {}
    for patient_dir in sorted(Path(data_dir).glob("**/HR/*")):
        patient_name = patient_dir.parts[-1]
        LOG.info(f"Process {patient_name}.")
        videos_dir = Path(output_dir) / patient_name
        videos_dir.mkdir(parents=True, exist_ok=True)

        data_paths = sorted(patient_dir.glob("**/*2d+1d*.nii.gz"))
        data = nifti.load(data_paths[0]).get_data()
        bbox = find_bbox(np.asarray(data, np.float32))
        coordinates[patient_name] = bbox
        h0, hn, w0, wn = bbox
        for data_path in data_paths:
            seq = nifti.load(data_path).get_data().squeeze().transpose(2, 0, 1).astype(np.uint8)
            imgio.write_gif(
                videos_dir / data_path.parts[-1].replace(".nii.gz", ".gif"),
                [img[h0:hn, w0:wn] for img in seq],
            )
    Path(output_dir).mkdir(parents=True, exist_ok=True)
    with open(Path(output_dir) / "coordinates.pkl", "wb") as f:
        pickle.dump(coordinates, f)
    return coordinates


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(description="The cardiac cropping.")
    parser.add_argument("data_dir", type=Path)
    parser.add_argument("output_dir", type=Path)
    return parser.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(message)s", level=logging.INFO,
                        datefmt="%Y-%m-%d %H:%M:%S")
    args = _parse_args()
    main(args.data_dir, args.output_dir)
