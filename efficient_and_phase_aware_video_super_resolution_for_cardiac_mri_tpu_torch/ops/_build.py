"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a ``.so``
with a plain C interface, loaded with :mod:`ctypes`.  The library goes into
``build/`` inside the package (listed in ``.gitignore``), named by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is reused.  Nothing is built at import time: the first call of a kernel's
wrapper builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


@dataclass
class Built:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float  # nvcc wall time; 0.0 when an earlier build was reused
    log: str  # nvcc's stderr (ptxas register and spill report)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for candidate in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of this "
        "package are built from source at first use"
    )


def build(source_name: str) -> Built:
    """Compile ``csrc/<source_name>`` (if not built yet) and load it."""
    source = CSRC_DIR / source_name
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {source}:\n{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return Built(ctypes.CDLL(str(out)), out, seconds, log)
