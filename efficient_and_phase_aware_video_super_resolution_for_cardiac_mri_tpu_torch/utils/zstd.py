"""zstd decompression through the system's ``libzstd`` (RFC 8878 frames).

The JAX package's orbax checkpoints hold zstd at two layers: the OCDBT
store's manifests and B-tree nodes, and every zarr array chunk.  Python
3.12 has no zstd of its own and the port takes no extra package, so this
module binds the C library's stable API with :mod:`ctypes` (no header is
needed): the streaming ``ZSTD_decompressStream`` decodes every frame,
whether or not it records its content size, straight into the caller's
buffer.  The library is found by ``ctypes.util`` (the dynamic loader's
cache) and loaded at the first call, never at import.

Nothing falls back: a missing library raises :class:`ZstdUnavailable`, a
corrupt or truncated frame (a failed content checksum included)
:class:`ZstdError` with the library's own message.
"""
from __future__ import annotations

import ctypes
import ctypes.util


class ZstdError(ValueError):
    """A zstd frame that does not decode."""


class ZstdUnavailable(RuntimeError):
    """The system has no loadable ``libzstd``."""


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_lib = None


def library():
    """The loaded ``libzstd`` (loaded once)."""
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise ZstdUnavailable(
            "libzstd was not found (ctypes.util.find_library('zstd') returned None): the JAX "
            "package's orbax checkpoints are zstd-compressed; install the system's zstd "
            "library (libzstd.so.1)")
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        raise ZstdUnavailable(f"libzstd ({name}) did not load: {e}") from e
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    for fn, restype, argtypes in (
        ("ZSTD_versionNumber", ctypes.c_uint, []),
        ("ZSTD_isError", ctypes.c_uint, [size_t]),
        ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
        ("ZSTD_createDStream", vp, []),
        ("ZSTD_freeDStream", size_t, [vp]),
        ("ZSTD_initDStream", size_t, [vp]),
        ("ZSTD_DStreamOutSize", size_t, []),
        ("ZSTD_decompressStream", size_t,
         [vp, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)]),
    ):
        try:
            f = getattr(lib, fn)
        except AttributeError as e:
            raise ZstdUnavailable(f"{name} lacks {fn}: {e}") from e
        f.restype, f.argtypes = restype, argtypes
    _lib = lib
    return lib


def version() -> str:
    """The library's version, e.g. ``'1.5.5'``."""
    n = library().ZSTD_versionNumber()
    return f"{n // 10000}.{n // 100 % 100}.{n % 100}"


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ZstdError(f"{what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def decompress(data: bytes) -> bytes:
    """The content of the zstd frames in ``data``, concatenated."""
    return _stream(data, None)


def decompress_into(data: bytes, out) -> None:
    """Decompress ``data`` into the writable, C-contiguous buffer ``out``
    (a numpy array or a bytearray), which it must fill exactly."""
    _stream(data, memoryview(out).cast("B"))


def _stream(data: bytes, out: memoryview | None) -> bytes | None:
    """``ZSTD_decompressStream`` over every frame in ``data``, straight
    into ``out``, or into a buffer that grows when ``out`` is None (the
    bytes are returned).  A frame cut short, or content longer or shorter
    than ``out``, raises."""
    lib = library()
    data = bytes(data)
    grow = out is None
    buf = bytearray(max(4 * len(data), lib.ZSTD_DStreamOutSize())) if grow else out
    spare = ctypes.create_string_buffer(1)  # where ``out`` is full: more content is too much
    src = ctypes.c_char_p(data)
    inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p).value, len(data), 0)
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("ZSTD_createDStream failed")
    pos = 0
    try:
        _check(lib, lib.ZSTD_initDStream(stream), "ZSTD_initDStream")
        while True:
            if grow and pos == len(buf):
                buf.extend(bytes(len(buf)))
            window = (ctypes.c_char * (len(buf) - pos)).from_buffer(buf, pos) if pos < len(buf) \
                else spare
            outb = _OutBuffer(ctypes.addressof(window), ctypes.sizeof(window), 0)
            left = _check(lib, lib.ZSTD_decompressStream(stream, ctypes.byref(outb),
                                                         ctypes.byref(inb)),
                          f"zstd frame of {len(data)} bytes")
            del window  # releases ``buf`` for the next ``extend``
            if outb.pos and pos == len(buf):
                raise ZstdError(f"the frames hold more than the {len(buf)} bytes expected")
            pos += outb.pos
            if inb.pos == inb.size and left == 0:
                break
            if inb.pos == inb.size and outb.pos < outb.size:
                raise ZstdError(f"zstd stream of {len(data)} bytes ends inside a frame")
    finally:
        lib.ZSTD_freeDStream(stream)
    if grow:
        del buf[pos:]
        return bytes(buf)
    if pos != len(buf):
        raise ZstdError(f"decoded {pos} bytes where {len(buf)} were expected")
    return None
