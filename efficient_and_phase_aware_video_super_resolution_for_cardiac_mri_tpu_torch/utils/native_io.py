"""ctypes bindings for the repository's native NIfTI decoder
(``native/evsr_native.cpp``), the port's copy of the JAX package's
``utils/native_io.py``.

The C++ library inflates, parses and converts NIfTI volumes to float32 on a
``std::thread`` pool, outside the GIL.  It is compiled at first use with
``g++`` into the package's git-ignored ``build/``, named by a hash of the
source and the flags (an unchanged source is reused, ``native/`` is never
written), and loaded with :mod:`ctypes`.  Where it cannot be built or
loaded, every entry point reads with the Python ``utils/nifti`` reader, the
JAX package's semantics too, and one WARNING says so.  A file the library
refuses (a dtype it does not convert, a corrupt payload) is read by the
Python reader, which raises where the file is bad.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from . import nifti

LOG = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[2] / "native" / "evsr_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared"]
LD_FLAGS = ["-lz", "-lpthread"]

_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LD_FLAGS).encode())
    return BUILD_DIR / f"evsr_native-{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the source into ``build/`` unless that build exists; raise
    with the compiler's message when it fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LD_FLAGS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}): {proc.stderr.strip()[-2000:]}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
    except Exception as e:  # no compiler, no zlib headers, a load error
        LOG.warning("native NIfTI reader unavailable (%s: %s); volumes are read by the "
                    "Python reader (utils/nifti.py)", type(e).__name__, e)
        return None
    lib.evsr_decode_nifti_file.restype = ctypes.c_int
    lib.evsr_decode_nifti_file.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.evsr_decode_batch.restype = ctypes.c_int
    lib.evsr_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def enabled() -> bool:
    """Whether the datasets read through the library: built, and not
    switched off by ``EVSR_NO_NATIVE_IO=1``."""
    return os.environ.get("EVSR_NO_NATIVE_IO") != "1" and available()


def read_shape(path) -> tuple[int, ...] | None:
    """Volume shape from the 348-byte header alone (the Python reader's
    streaming ``gzip.open`` inflates only the header)."""
    try:
        return tuple(nifti.read_header(path)["shape"])
    except Exception:
        return None


def _python(path) -> np.ndarray:
    return np.asarray(nifti.load(path).get_data(), np.float32)


def load_volume(path) -> np.ndarray:
    """A float32 volume in ``nifti.load``'s (Fortran-order) layout."""
    lib = _load()
    shape = read_shape(path) if lib is not None else None
    if shape is None:
        return _python(path)
    count = int(np.prod(shape))
    out = np.empty(count, np.float32)
    dims = (ctypes.c_int64 * 8)()
    rc = lib.evsr_decode_nifti_file(str(path).encode(),
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                    count, dims)
    if rc < 0:
        return _python(path)
    return out.reshape(shape, order="F")


def load_volumes(paths, threads: int = 8) -> list[np.ndarray]:
    """Decode many volumes concurrently on the library's thread pool."""
    lib = _load()
    shapes = [read_shape(p) for p in paths] if lib is not None else [None]
    if any(s is None for s in shapes):
        return [load_volume(p) for p in paths]
    buffers = [np.empty(int(np.prod(s)), np.float32) for s in shapes]
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    c_outs = (ctypes.POINTER(ctypes.c_float) * n)(
        *[b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for b in buffers])
    c_caps = (ctypes.c_int64 * n)(*[b.size for b in buffers])
    c_dims = (ctypes.c_int64 * (8 * n))()
    if lib.evsr_decode_batch(c_paths, n, c_outs, c_caps, c_dims, threads) < 0:
        return [load_volume(p) for p in paths]
    return [b.reshape(s, order="F") for b, s in zip(buffers, shapes)]
