"""ACDC offline preprocessing CLI, the port's copy of the JAX package's
``tools/acdc_preprocess.py`` (reference ``src/acdc_preprocess.py``).

Splits ``training/**/*4d.nii.gz`` 80/20 into train/valid with
``random.seed('vsr')``; per patient: int16 outlier clip at the 99.5% CDF and
min-max to [0, 255], centre crop to a multiple of 12, k-space degradation to
LR X{2,3,4} (``ops/kspace.py``), and per-slice "2d+1d" sequence NIfTIs and
per-frame "2d" image NIfTIs under the ``imgs/`` and ``videos/`` trees.  numpy
only; the trees it writes are byte-equal to the JAX tool's.

    python -m <torch pkg>.tools.acdc_preprocess DATA_DIR OUTPUT_DIR
"""
from __future__ import annotations

import argparse
import logging
import random
from pathlib import Path

import numpy as np

from ..ops.kspace import Downscale
from ..utils import nifti

LOG = logging.getLogger(__name__)


def normalize_int16(data: np.ndarray) -> np.ndarray:
    """99.5%-CDF outlier clip and min-max to [0, 255] (reference ``:34-39``)."""
    if data.dtype == np.int16:
        hist, _ = np.histogram(data.ravel(), bins=range(int(data.max()) + 1), density=True)
        cdf = np.cumsum(hist)
        idx = int(np.abs(cdf - 0.995).argmin())
        data = np.minimum(data, idx)
        data = ((data - data.min()) / (data.max() - data.min()) * 255.0).round()
    return data.astype(np.float32)


def crop_multiple(h: int, w: int, r: int = 12) -> tuple[int, int, int, int]:
    """Centre-crop bounds making H and W divisible by r (reference ``:43-45``)."""
    h0, hn = (h % r) // 2, h - ((h % r) - (h % r) // 2)
    w0, wn = (w % r) // 2, w - ((w % r) - (w % r) // 2)
    return h0, hn, w0, wn


def write_sequence(hr_video: np.ndarray, patient_name: str, seq: int, type_: str,
                   output_dir: Path, factors) -> None:
    """One (H, W, 1, T) HR sequence and its LR versions: the ``videos/``
    sequence NIfTI and the ``imgs/`` frame NIfTIs of each, as
    ``<patient>_2d+1d_sequenceNN`` and ``<patient>_2d_sliceNN_frameMM``."""
    output_dir = Path(output_dir)
    name = f"{patient_name}_2d+1d_sequence{seq:0>2d}.nii.gz"
    for i, factor in enumerate(factors):
        lr_frames = Downscale(factor)(*[hr_video[..., t] for t in range(hr_video.shape[-1])])
        lr_video = np.stack(lr_frames, axis=-1).astype(np.float32)
        lr = f"LR/X{factor}"
        if i == 0:
            nifti.save(hr_video, output_dir / "videos" / type_ / "HR" / patient_name / name)
        nifti.save(lr_video, output_dir / "videos" / type_ / lr / patient_name / name)
        for t in range(hr_video.shape[-1]):
            img_name = f"{patient_name}_2d_slice{seq:0>2d}_frame{t+1:0>2d}.nii.gz"
            if i == 0:
                nifti.save(hr_video[..., t], output_dir / "imgs" / type_ / "HR" / patient_name / img_name)
            nifti.save(lr_video[..., t], output_dir / "imgs" / type_ / lr / patient_name / img_name)


def process_patient(data: np.ndarray, patient_name: str, type_: str, output_dir: Path,
                    factors=(2, 3, 4)) -> tuple[float, float, int]:
    """Write the HR/LR ``imgs/`` and ``videos/`` trees of one (H, W, D, T)
    volume; returns (sum, square sum, count) for the split's statistics."""
    data = normalize_int16(data)
    h0, hn, w0, wn = crop_multiple(data.shape[0], data.shape[1])
    cropped = data[h0:hn, w0:wn]
    s, sq, n = float(cropped.sum()), float((cropped**2).sum()), int(np.prod(cropped.shape))
    for sl in range(cropped.shape[2]):
        write_sequence(cropped[:, :, sl : sl + 1], patient_name, sl + 1, type_, output_dir, factors)
    return s, sq, n


def log_stats(type_: str, sum_: float, square_sum: float, num: int) -> None:
    if num:
        mean = sum_ / num
        std = float(np.sqrt(square_sum / num - mean**2))
        LOG.info(f"The mean and the standard deviation of the {type_} data is "
                 f"{mean:.4f} and {std:.4f}.")


def main(data_dir: Path, output_dir: Path, factors=(2, 3, 4)):
    data_dir, output_dir = Path(data_dir), Path(output_dir)
    paths = sorted((data_dir / "training").glob("**/*4d.nii.gz"))
    random.seed("vsr")  # the reference's split seed (:15)
    random.shuffle(paths)
    train_paths = sorted(paths[: int(len(paths) * 0.8)])
    valid_paths = sorted(set(paths) - set(train_paths))
    test_paths = sorted((data_dir / "testing").glob("**/*4d.nii.gz"))

    for type_, split in zip(["train", "valid", "test"], [train_paths, valid_paths, test_paths]):
        LOG.info(f"Process the {type_} data.")
        sum_, square_sum, num = 0.0, 0.0, 0
        for path in split:
            patient_name = path.parts[-2]
            LOG.info(f"Process {patient_name}.")
            data = nifti.load(path).get_data()  # (H, W, D, T)
            s, sq, n = process_patient(data, patient_name, type_, output_dir, factors)
            sum_, square_sum, num = sum_ + s, square_sum + sq, num + n
        log_stats(type_, sum_, square_sum, num)


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(description="The data preprocessing.")
    parser.add_argument("data_dir", type=Path)
    parser.add_argument("output_dir", type=Path)
    return parser.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(message)s", level=logging.INFO,
                        datefmt="%Y-%m-%d %H:%M:%S")
    args = _parse_args()
    main(args.data_dir, args.output_dir)
