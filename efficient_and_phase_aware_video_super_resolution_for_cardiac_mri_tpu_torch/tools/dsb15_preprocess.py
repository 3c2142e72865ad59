"""DSB15 offline preprocessing CLI, the port's copy of the JAX package's
``tools/dsb15_preprocess.py`` (reference ``src/dsb15_preprocess.py``).

The ACDC pipeline (``tools/acdc_preprocess.py``: normalize, crop to /12,
k-space degradation, save) over the sax-series NIfTIs of each patient of
``DATA_DIR/{train,valid,test}/<patient>/<series>/*.nii.gz``.  Series are
numbered by their position among all globbed series (``sequenceNN`` =
position + 1), and malformed ones are skipped but keep their number
(``data.shape[2] != 1``, ``ndim != 4`` or fewer than 30 frames; reference
``:28-29``).  The trees are byte-equal to the JAX tool's.

    python -m <torch pkg>.tools.dsb15_preprocess DATA_DIR OUTPUT_DIR
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from ..utils import nifti
from .acdc_preprocess import crop_multiple, log_stats, normalize_int16, write_sequence

LOG = logging.getLogger(__name__)


def main(data_dir: Path, output_dir: Path, factors=(2, 3, 4)):
    data_dir, output_dir = Path(data_dir), Path(output_dir)
    for type_ in ["train", "valid", "test"]:
        split_dir = data_dir / type_
        if not split_dir.is_dir():
            continue
        LOG.info(f"Process the {type_} data.")
        sum_, square_sum, num = 0.0, 0.0, 0
        for patient_dir in sorted(p for p in split_dir.iterdir() if p.is_dir()):
            patient_name = patient_dir.name
            LOG.info(f"Process {patient_name}.")
            # reference :23-24: a one-level '*/*.nii.gz' glob, the series
            # numbered by position (j + 1, reference :72-74)
            for j, series_path in enumerate(sorted(patient_dir.glob("*/*.nii.gz"))):
                data = np.asarray(nifti.load(series_path).get_data())
                if data.ndim != 4 or data.shape[2] != 1 or data.shape[-1] < 30:
                    continue
                data = normalize_int16(data)
                h0, hn, w0, wn = crop_multiple(data.shape[0], data.shape[1])
                cropped = data[h0:hn, w0:wn]
                sum_ += float(cropped.sum())
                square_sum += float((cropped**2).sum())
                num += int(np.prod(cropped.shape))
                write_sequence(cropped[:, :, 0:1], patient_name, j + 1, type_, output_dir,
                               factors)
        log_stats(type_, sum_, square_sum, num)


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(description="The DSB15 data preprocessing.")
    parser.add_argument("data_dir", type=Path)
    parser.add_argument("output_dir", type=Path)
    return parser.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(message)s", level=logging.INFO,
                        datefmt="%Y-%m-%d %H:%M:%S")
    args = _parse_args()
    main(args.data_dir, args.output_dir)
