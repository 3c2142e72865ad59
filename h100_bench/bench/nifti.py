"""The NIfTI-1 files the benchmark writes and reads itself: one volume a
file, gzip, float32 voxels in Fortran order (the layout of the
preprocessed ACDC trees), written from many threads at once."""
from __future__ import annotations

import gzip
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

_HDR = 348
_FLOAT32 = 16


def encode(vol: np.ndarray, level: int = 1) -> bytes:
    vol = np.asarray(vol, np.float32)
    hdr = bytearray(_HDR)
    struct.pack_into("<i", hdr, 0, _HDR)
    struct.pack_into("<8h", hdr, 40, vol.ndim, *vol.shape, *([1] * (7 - vol.ndim)))
    struct.pack_into("<2h", hdr, 70, _FLOAT32, 32)
    struct.pack_into("<8f", hdr, 76, 1.0, *([1.0] * 7))
    struct.pack_into("<f", hdr, 108, float(_HDR + 4))
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)
    struct.pack_into("<2h", hdr, 252, 0, 1)
    struct.pack_into("<12f", hdr, 280, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0)
    hdr[344:348] = b"n+1\x00"
    # the voxels in Fortran order without a copy where the volume is laid
    # out so (a transposed view of a C-ordered (T, W, H) array): zlib reads
    # them with the GIL released
    voxels = np.asfortranarray(vol).T  # C-contiguous: its bytes are vol's in F order
    gz = zlib.compressobj(level, zlib.DEFLATED, 31)  # wbits 31: a gzip stream, mtime 0
    return gz.compress(bytes(hdr) + b"\x00" * 4) + gz.compress(memoryview(voxels).cast("B")) \
        + gz.flush()


def write_many(items, threads: int = 8) -> int:
    """Write ``(path, volume)`` pairs, gzip level 1, on ``threads`` threads
    (zlib releases the GIL; volumes that are F-contiguous are compressed
    without a copy) → the bytes written."""
    def one(item):
        path, vol = item
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        data = encode(vol)
        path.write_bytes(data)
        return len(data)

    with ThreadPoolExecutor(threads) as pool:
        return sum(pool.map(one, items))


def read(path) -> np.ndarray:
    """A volume in its on-disk shape, as float32 (the daemon's outputs)."""
    raw = gzip.decompress(Path(path).read_bytes())
    ndim, *dims = struct.unpack_from("<8h", raw, 40)
    code = struct.unpack_from("<h", raw, 70)[0]
    offset = int(struct.unpack_from("<f", raw, 108)[0])
    slope, inter = struct.unpack_from("<2f", raw, 112)
    dtype = {2: np.uint8, 4: np.int16, 16: np.float32, 64: np.float64}[code]
    shape = tuple(dims[:ndim])
    data = np.frombuffer(raw, dtype, count=int(np.prod(shape)), offset=offset)
    data = data.reshape(shape, order="F").astype(np.float32)
    if slope not in (0.0, 1.0) or inter != 0.0:
        data = data * slope + inter
    return data
