"""Minimal, dependency-free NIfTI-1 reader/writer.

The reference relies on ``nibabel`` for every dataset read/write (e.g.
``src/data/datasets/acdc_vsr_refinenet_dataset.py:54-55``,
``src/acdc_preprocess.py:31,74-85``).  This module provides the subset of
functionality the framework needs — single-file ``.nii`` / ``.nii.gz`` volumes
with the standard scalar dtypes — implemented directly against the NIfTI-1
on-disk format so the host data pipeline has no heavyweight dependency.

Data is returned exactly as nibabel's ``get_data()`` would: the raw on-disk
array (Fortran order), with scl_slope/scl_inter scaling applied when present.
"""
from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

# NIfTI-1 datatype codes <-> numpy dtypes.
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_HDR_SIZE = 348


class NiftiImage:
    """A loaded NIfTI volume: ``data`` (numpy array) + ``affine`` (4x4)."""

    def __init__(self, data: np.ndarray, affine: np.ndarray | None = None, header: dict | None = None):
        self.data = data
        self.affine = np.eye(4, dtype=np.float32) if affine is None else np.asarray(affine)
        self.header = header or {}

    @property
    def shape(self):
        return self.data.shape

    def get_data(self) -> np.ndarray:
        return self.data

    # nibabel-compat alias
    def get_fdata(self) -> np.ndarray:
        return np.asarray(self.data, dtype=np.float64)


def _open_bytes(path: str | Path) -> bytes:
    path = Path(path)
    raw = path.read_bytes()
    if path.suffix == ".gz" or raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw


def read_header(path: str | Path) -> dict:
    """Parse just the 348-byte NIfTI-1 header (cheap shape queries).

    Used where the reference calls ``nib.load(p).header.get_data_shape()``
    (``acdc_vsr_refinenet_dataset.py:41``) without reading voxels.
    """
    path = Path(path)
    # sniff gzip by magic bytes like _open_bytes (suffix-only detection made
    # a gzipped file not named *.gz loadable by load() yet unreadable here)
    with open(path, "rb") as f:
        magic = f.read(2)
    if path.suffix == ".gz" or magic == b"\x1f\x8b":
        with gzip.open(path, "rb") as f:
            raw = f.read(_HDR_SIZE)
    else:
        with open(path, "rb") as f:
            raw = f.read(_HDR_SIZE)
    return _parse_header(raw)


def _parse_header(raw: bytes) -> dict:
    if len(raw) < _HDR_SIZE:
        raise ValueError("Truncated NIfTI header.")
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        (sizeof_hdr,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError("Not a NIfTI-1 file (bad sizeof_hdr).")
        endian = ">"
    dim = struct.unpack_from(f"{endian}8h", raw, 40)
    datatype, bitpix = struct.unpack_from(f"{endian}2h", raw, 70)
    pixdim = struct.unpack_from(f"{endian}8f", raw, 76)
    (vox_offset,) = struct.unpack_from(f"{endian}f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from(f"{endian}2f", raw, 112)
    magic = raw[344:348]
    ndim = dim[0]
    if not 0 < ndim <= 7:
        raise ValueError(f"Invalid NIfTI ndim {ndim}.")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    return {
        "endian": endian,
        "shape": shape,
        "datatype": int(datatype),
        "bitpix": int(bitpix),
        "pixdim": tuple(float(p) for p in pixdim),
        "vox_offset": int(vox_offset) if vox_offset else _HDR_SIZE + 4,
        "scl_slope": float(scl_slope),
        "scl_inter": float(scl_inter),
        "magic": magic,
    }


def load(path: str | Path) -> NiftiImage:
    """Load a ``.nii`` / ``.nii.gz`` volume."""
    raw = _open_bytes(path)
    hdr = _parse_header(raw[:_HDR_SIZE])
    if hdr["datatype"] not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype code {hdr['datatype']}.")
    dtype = np.dtype(_DTYPES[hdr["datatype"]]).newbyteorder(hdr["endian"])
    count = int(np.prod(hdr["shape"])) if hdr["shape"] else 0
    offset = hdr["vox_offset"]
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
    # NIfTI voxel data is Fortran-ordered (first axis fastest).
    data = data.reshape(hdr["shape"], order="F")
    if dtype.byteorder == ">" or (dtype.byteorder == "=" and not np.little_endian):
        data = data.astype(data.dtype.newbyteorder("="))
    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    if slope not in (0.0, 1.0) or inter != 0.0:
        data = data * np.float32(slope if slope != 0.0 else 1.0) + np.float32(inter)

    # sform affine rows live at bytes 280/296/312 (only parsed, never required).
    srow = np.frombuffer(raw, dtype=f"{hdr['endian']}f4", count=12, offset=280).reshape(3, 4)
    affine = np.eye(4, dtype=np.float32)
    if np.any(srow):
        affine[:3, :] = srow
    return NiftiImage(data, affine, hdr)


def save(img: NiftiImage | np.ndarray, path: str | Path, affine: np.ndarray | None = None) -> None:
    """Write a ``.nii`` / ``.nii.gz`` volume (gzip decided by extension)."""
    if isinstance(img, np.ndarray):
        img = NiftiImage(img, affine)
    data = np.ascontiguousarray(img.data)
    dtype = np.dtype(data.dtype)
    if dtype not in _CODES:
        raise ValueError(f"Unsupported dtype for NIfTI save: {dtype}.")

    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<2h", hdr, 70, _CODES[dtype], dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *([1.0] * data.ndim), *([0.0] * (7 - data.ndim)))
    struct.pack_into("<f", hdr, 108, float(_HDR_SIZE + 4))  # vox_offset = 352
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope, scl_inter
    # qform/sform codes (int16 at 252/254) + srow.
    affine = np.asarray(img.affine, dtype=np.float32)
    struct.pack_into("<2h", hdr, 252, 0, 1)
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].ravel())
    hdr_bytes = bytes(hdr) + b"\x00" * 4  # 4-byte extension flag, no extensions
    hdr_bytes = hdr_bytes[:344] + b"n+1\x00" + hdr_bytes[348:]

    payload = hdr_bytes + data.tobytes(order="F")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".gz":
        # mtime=0 keeps writes byte-deterministic.
        path.write_bytes(gzip.compress(payload, compresslevel=4, mtime=0))
    else:
        path.write_bytes(payload)
