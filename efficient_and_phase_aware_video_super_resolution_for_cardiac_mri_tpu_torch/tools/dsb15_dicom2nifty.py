"""DSB15 DICOM → NIfTI CLI, the port's copy of the JAX package's
``tools/dsb15_dicom2nifty.py`` (reference ``src/dsb15_dicom2nifty.py``).

Walks the train/validate/test patient directories, finds the ``*/sax*``
series of each, and runs ``dcm2niix`` on each series into
``OUTPUT_DIR/<split>/<patient>/<series>`` ('validate' becomes 'valid').
``dcm2niix`` is an external program, as in the reference; without it on
``PATH`` the tool raises before it converts anything.

    python -m <torch pkg>.tools.dsb15_dicom2nifty DATA_DIR OUTPUT_DIR
"""
from __future__ import annotations

import argparse
import logging
import shutil
import subprocess
from pathlib import Path

LOG = logging.getLogger(__name__)

#: the reference's dcm2niix options (text notes, no single-file mode, 2D
#: slices merged, a BIDS sidecar without anonymization, gzip, named by the
#: series description; ``src/dsb15_dicom2nifty.py:32``)
DCM2NIIX_FLAGS = ("-t", "y", "-s", "n", "-m", "y", "-b", "y", "-ba", "n", "-z", "y", "-f", "%d")


def main(data_dir: Path, output_dir: Path):
    if shutil.which("dcm2niix") is None:
        raise RuntimeError(
            "dcm2niix not found on PATH — install it to convert DSB15 DICOMs "
            "(the same external program as the reference's)."
        )
    data_dir, output_dir = Path(data_dir), Path(output_dir)
    for split in ["train", "validate", "test"]:
        split_dir = data_dir / split
        if not split_dir.is_dir():
            continue
        out_split = "valid" if split == "validate" else split
        for patient_dir in sorted(split_dir.iterdir()):
            if not patient_dir.is_dir():
                continue
            LOG.info(f"Process {patient_dir.name}.")
            for series_dir in sorted(patient_dir.glob("*/sax*")):
                out_dir = output_dir / out_split / patient_dir.name / series_dir.name
                out_dir.mkdir(parents=True, exist_ok=True)
                subprocess.run(["dcm2niix", "-o", str(out_dir), *DCM2NIIX_FLAGS, str(series_dir)],
                               check=False, capture_output=True)


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(description="DSB15 DICOM to NIfTI conversion.")
    parser.add_argument("data_dir", type=Path)
    parser.add_argument("output_dir", type=Path)
    return parser.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(message)s", level=logging.INFO,
                        datefmt="%Y-%m-%d %H:%M:%S")
    args = _parse_args()
    main(args.data_dir, args.output_dir)
