"""8-bit grayscale PNG and GIF files, written with numpy and the standard library.

The predictors' exports and ``tools/cardiac_cropping``'s GIFs go through
these two writers; the JAX package writes the same images through imageio,
which the machine with the card lacks.  Decoded, a file holds exactly the
frames written.

* :func:`write_png`: one 8-bit grayscale image (colour type 0), every row
  with filter 0, the whole image in one IDAT chunk compressed by ``zlib``.
* :func:`write_gif`: GIF89a with one global 256-entry gray palette (index
  ``v`` is the colour ``(v, v, v)``), the NETSCAPE2.0 loop extension
  (forever), and per frame a graphic control extension (0.1 s, drawn over
  the previous frame) and one full image block, LZW-coded with 8-bit roots
  and a clear code when the code table is full.
* :func:`gif_frame_count`: the number of image blocks in a GIF, by walking
  its blocks (a check of an export where no decoder is installed).
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GIF_PALETTE = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
_LOOP = b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
_FRAME_DELAY_CS = 10


def _gray8(img) -> np.ndarray:
    """An (H, W) or (H, W, 1) uint8 image as a C-contiguous (H, W) array."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"expected an (H, W) uint8 image, got {img.dtype} {img.shape}")
    if not (0 < img.shape[0] < 65536 and 0 < img.shape[1] < 65536):
        raise ValueError(f"image size {img.shape} is not writable")
    return np.ascontiguousarray(img)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path, img) -> None:
    """Write an 8-bit grayscale image as a PNG file."""
    img = _gray8(img)
    h, w = img.shape
    rows = np.zeros((h, w + 1), np.uint8)  # a leading 0 a row: filter type None
    rows[:, 1:] = img
    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8 bits, gray, deflate, no interlace
    Path(path).write_bytes(_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
                           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                           + _png_chunk(b"IEND", b""))


def lzw_encode(pixels: bytes) -> bytes:
    """GIF's variable-width LZW of 8-bit ``pixels`` (codes packed least
    significant bit first), starting with a clear code and ending with the
    end-of-information code.  The code width grows when the entry just
    added needs one more bit; a full table (4096 codes) is cleared."""
    clear, stop = 256, 257
    out = bytearray()
    width = 9
    acc, nbits = clear, width
    table: dict[int, int] = {}
    next_code = stop + 1
    prefix = pixels[0]
    for byte in pixels[1:]:
        key = (prefix << 8) | byte
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        acc |= prefix << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            acc |= clear << nbits
            nbits += width
            table.clear()
            next_code = stop + 1
            width = 9
        prefix = byte
    acc |= prefix << nbits
    nbits += width
    # the decoder adds an entry on reading this last code (unless it is the
    # first after a clear, when next_code is low) and widens its codes
    # before the end code if that entry needs it
    if next_code < 4096 and next_code >= (1 << width) and width < 12:
        width += 1
    acc |= stop << nbits
    nbits += width
    while nbits > 0:
        out.append(acc & 0xFF)
        acc >>= 8
        nbits -= 8
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    """``data`` as GIF data sub-blocks of at most 255 bytes, terminated."""
    parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)]
    return b"".join(parts) + b"\x00"


def write_gif(path, frames) -> None:
    """Write a sequence of equally sized 8-bit grayscale frames as an
    animated GIF file."""
    frames = [_gray8(f) for f in frames]
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    h, w = frames[0].shape
    if any(f.shape != (h, w) for f in frames):
        raise ValueError(f"every frame must be {h}x{w}")
    # screen descriptor: a global table of 2^(7+1) entries, 8 bits of colour
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), _GIF_PALETTE, _LOOP]
    for f in frames:
        out.append(struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0x04, _FRAME_DELAY_CS, 0, 0))
        out.append(struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0))
        out.append(b"\x08" + _sub_blocks(lzw_encode(f.tobytes())))  # 8-bit LZW roots
    out.append(b"\x3b")
    Path(path).write_bytes(b"".join(out))


def gif_frame_count(path) -> int:
    """The image blocks of a GIF file, counted by walking its blocks;
    raises ``ValueError`` on a file that is not a well-formed GIF."""
    data = Path(path).read_bytes()
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError(f"{path} is not a GIF")
    pos = 13
    if data[10] & 0x80:
        pos += 3 << ((data[10] & 7) + 1)
    count = 0

    def skip_sub_blocks(pos: int) -> int:
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    try:
        while data[pos] != 0x3B:
            if data[pos] == 0x21:  # extension: label, then sub-blocks
                pos = skip_sub_blocks(pos + 2)
            elif data[pos] == 0x2C:  # image descriptor, local table, LZW data
                packed = data[pos + 9]
                pos += 10
                if packed & 0x80:
                    pos += 3 << ((packed & 7) + 1)
                pos = skip_sub_blocks(pos + 1)
                count += 1
            else:
                raise ValueError(f"{path}: unknown block 0x{data[pos]:02x} at byte {pos}")
    except IndexError:
        raise ValueError(f"{path} ends inside a block") from None
    return count
