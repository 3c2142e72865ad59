"""Reading the JAX package's orbax checkpoint directories, without orbax.

The JAX package's ``checkpoint_backend: orbax`` / ``orbax_async`` (the
default of every run over more than one process) writes ``model_N.pth/``
with ``meta.pkl`` beside ``arrays/``, an orbax ``StandardCheckpointHandler``
tree.  That tree is three layers, each read here by host code:

1. **OCDBT**, tensorstore's key-value store (:class:`Ocdbt`): a manifest
   (``manifest.ocdbt``) whose version list points at the newest B-tree
   root; B-tree nodes with prefix-compressed keys; values inline in a leaf
   or by reference (data file, offset, length) into the ``d/`` files that
   each writing process keeps (``ocdbt.process_N/d/...`` once orbax has
   merged the processes' trees into the root's).  A manifest or node is
   ``magic (u32 big-endian) | length (u64) | version (varint) |
   compression (varint: 0 none, 1 zstd) | body | crc32c (u32)``; the
   checksum covers everything before it and is checked.  Lists of entries
   are stored a field at a time (every key's prefix length, then every
   suffix length, ...), integers as LEB128 varints.  The format was worked
   out against tensorstore's own reading of stores written by orbax and by
   tensorstore with other node sizes, inline limits, compressions and
   version-tree arities; ``tests/test_torch_orbax.py`` holds it there.
2. **zarr v2** arrays (:func:`read_array`): ``<name>/.zarray`` (JSON) and
   the chunks ``<name>/i.j.k`` (a scalar's one chunk is ``<name>/0``), each
   zstd-compressed, assembled over the chunk grid.
3. **The pytree** (:func:`read_tree`): ``arrays/_METADATA`` lists every
   leaf's key path (key type 1 a sequence index, 2 a dict key); a leaf's
   arrays are named by the path joined with ``.``, and the empty
   containers orbax skips come back as its restore without a target gives
   them (``{}``, ``[]``, ``()`` or None).

zstd is :mod:`..utils.zstd` (the system's ``libzstd``).  Every fault
raises :class:`OrbaxFormatError` or the zstd module's errors, naming the
file; nothing is guessed.
"""
from __future__ import annotations

import json
import math
import struct
from itertools import product
from pathlib import Path

import numpy as np
import torch

from ..utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
#: an empty tree's root reference: offset and length all ones
_MISSING = 2**64 - 1


class OrbaxFormatError(ValueError):
    """A checkpoint file that does not parse as what it should be."""


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum that ends every manifest and node."""
    c = 0xFFFFFFFF
    table = _CRC32C
    for byte in data:
        c = table[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """A cursor over a decoded body; reading past its end raises."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise OrbaxFormatError(f"{self.what}: truncated at byte {self.pos} of "
                                   f"{len(self.data)} (needs {n} more)")

    def varint(self) -> int:
        value = shift = 0
        while True:
            self._need(1)
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OrbaxFormatError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def raw(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise OrbaxFormatError(f"{self.what}: {len(self.data) - self.pos} bytes left "
                                   "after the last field")


def _decode(blob: bytes, magic: int, what: str) -> _Reader:
    """Check a manifest's or node's header, length and checksum; the body,
    decompressed."""
    if len(blob) < 18:
        raise OrbaxFormatError(f"{what}: {len(blob)} bytes, shorter than a header and checksum")
    found = struct.unpack(">I", blob[:4])[0]
    if found != magic:
        raise OrbaxFormatError(f"{what}: magic {found:#010x}, expected {magic:#010x}")
    length = struct.unpack("<Q", blob[4:12])[0]
    if length != len(blob):
        raise OrbaxFormatError(f"{what}: header records {length} bytes, found {len(blob)}")
    stored = struct.unpack("<I", blob[-4:])[0]
    computed = crc32c(blob[:-4])
    if stored != computed:
        raise OrbaxFormatError(f"{what}: crc32c mismatch (stored {stored:#010x}, computed "
                               f"{computed:#010x}); the file is corrupt")
    head = _Reader(blob[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OrbaxFormatError(f"{what}: format version {version}; only version 0 is read")
    body = blob[12 + head.pos:-4]
    if compression == 1:
        body = zstd.decompress(body)
    elif compression != 0:
        raise OrbaxFormatError(f"{what}: compression {compression}; 0 (none) and 1 (zstd) "
                               "are read")
    return _Reader(body, what)


def _prefixed(r: _Reader, n: int, extra: int = 0) -> tuple[list[bytes], list[list[int]]]:
    """``n`` prefix-compressed strings: prefix lengths (shared with the
    previous string) for all but the first, suffix lengths, ``extra`` more
    per-entry varint columns, then the suffixes' bytes."""
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    columns = [r.varints(n) for _ in range(extra)]
    out, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise OrbaxFormatError(f"{r.what}: key prefix {p} longer than the previous key")
        prev = prev[:p] + r.raw(s)
        out.append(prev)
    return out, columns


def _data_files(r: _Reader) -> list[str]:
    """The data-file table: each file's path relative to the store's root
    (prefix-compressed; the column beside the lengths gives each path's
    base-path length, and the whole path is what is opened)."""
    paths = [p.decode() for p in _prefixed(r, r.varint(), extra=1)[0]]
    for path in paths:
        if path.startswith("/") or ".." in Path(path).parts:
            raise OrbaxFormatError(f"{r.what}: data file {path!r} leaves the store")
    return paths


class Ocdbt:
    """The newest version of an OCDBT key-value store at ``root``: every
    key and, read on demand, its value."""

    def __init__(self, root):
        self.root = Path(root)
        #: the root node's height (None for an empty store)
        self.height = None
        #: key → the value (inline) or (data file, offset, length)
        self._entries: dict[bytes, bytes | tuple[str, int, int]] = {}
        self._walk_manifest()

    def _read(self, path: str, offset: int, length: int) -> bytes:
        try:
            with open(self.root / path, "rb") as f:
                f.seek(offset)
                data = f.read(length)
        except FileNotFoundError:
            raise OrbaxFormatError(f"{self.root}: data file {path} is missing") from None
        if len(data) != length:
            raise OrbaxFormatError(f"{self.root / path}: {length} bytes at {offset} "
                                   f"requested, the file ends after {len(data)}")
        return data

    # -- the manifest and its newest root
    def _walk_manifest(self) -> None:
        path = self.root / "manifest.ocdbt"
        try:
            blob = path.read_bytes()
        except FileNotFoundError:
            raise OrbaxFormatError(f"{self.root} holds no manifest.ocdbt") from None
        r = _decode(blob, MANIFEST_MAGIC, str(path))
        r.raw(16)  # the store's uuid
        kind = r.varint()
        if kind != 0:
            raise OrbaxFormatError(f"{path}: manifest kind {kind}; only the single-file "
                                   "manifest (0) is read")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.byte()  # version_tree_arity_log2
        if r.varint() == 1:  # zstd: its level
            r.raw(4)
        files = _data_files(r)
        # the inline version-tree leaf: the newest versions, a field at a time
        n = r.varint()
        generation = r.varints(n)
        height = [r.byte() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # keys, tree bytes and indirect value bytes of each version
        r.raw(8 * n)  # commit times
        # the older versions' version-tree nodes follow; the newest root is
        # always in the inline leaf
        if not n:
            raise OrbaxFormatError(f"{path}: the manifest lists no version")
        newest = max(range(n), key=generation.__getitem__)
        if offset[newest] == _MISSING:
            return  # an empty store
        if file_id[newest] >= len(files):
            raise OrbaxFormatError(f"{path}: root in data file {file_id[newest]} of {len(files)}")
        self.height = height[newest]
        self._walk_node(files[file_id[newest]], offset[newest], length[newest], b"",
                        height[newest])

    def _walk_node(self, path: str, offset: int, length: int, prefix: bytes,
                   height: int) -> None:
        what = f"{self.root / path} [{offset}:{offset + length}]"
        r = _decode(self._read(path, offset, length), BTREE_MAGIC, what)
        if r.byte() != height:
            raise OrbaxFormatError(f"{what}: B-tree node of the wrong height (expected {height})")
        files = _data_files(r)
        n = r.varint()
        if height == 0:
            keys, _ = _prefixed(r, n)
            size, kind = r.varints(n), r.varints(n)
            indirect = [i for i in range(n) if kind[i] == 1]
            file_id, where = r.varints(len(indirect)), r.varints(len(indirect))
            for j, i in enumerate(indirect):
                self._entries[prefix + keys[i]] = (files[file_id[j]], where[j], size[i])
            for i in range(n):
                if kind[i] == 0:
                    self._entries[prefix + keys[i]] = r.raw(size[i])
                elif kind[i] != 1:
                    raise OrbaxFormatError(f"{what}: value kind {kind[i]}")
            r.done()
            return
        keys, (common,) = _prefixed(r, n, extra=1)
        file_id, where, size = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # each subtree's keys, tree bytes and indirect value bytes
        r.done()
        for i in range(n):
            self._walk_node(files[file_id[i]], where[i], size[i], prefix + keys[i][:common[i]],
                            height - 1)

    # -- the store
    def keys(self) -> list[bytes]:
        return sorted(self._entries)

    def __contains__(self, key) -> bool:
        return _key(key) in self._entries

    def read(self, key) -> bytes:
        value = self._entries.get(_key(key))
        if value is None:
            raise KeyError(key)
        return value if isinstance(value, bytes) else self._read(*value)


def _key(key) -> bytes:
    return key.encode() if isinstance(key, str) else key


# -------------------------------------------------------------- zarr v2
def _dtype(spec) -> tuple[np.dtype, bool]:
    """numpy dtype of a ``.zarray`` dtype, and whether it is bfloat16 (read
    as uint16, viewed as ``torch.bfloat16``)."""
    if spec == "bfloat16":
        return np.dtype("<u2"), True
    try:
        dtype = np.dtype(spec)
    except TypeError:
        raise OrbaxFormatError(f"zarr dtype {spec!r} is not read") from None
    if dtype.kind not in "biuf" or dtype.byteorder == ">":
        raise OrbaxFormatError(f"zarr dtype {spec!r} is not read (little-endian bool, "
                               "int, uint, float and bfloat16 are)")
    return dtype, False


def _fill(meta: dict, dtype: np.dtype, name: str):
    """The array's ``fill_value`` (zarr writes NaN and the infinities as
    strings, which numpy parses), or None."""
    fill = meta.get("fill_value")
    if fill is None:
        return None
    try:
        return np.array(fill).astype(dtype)
    except ValueError:
        raise OrbaxFormatError(f"{name}: fill_value {fill!r}") from None


def read_array(store: Ocdbt, name: str):
    """The zarr v2 array ``name`` of ``store``: a numpy array, or a
    ``torch.bfloat16`` tensor for ``bfloat16``."""
    try:
        meta = json.loads(store.read(f"{name}/.zarray"))
    except KeyError:
        raise OrbaxFormatError(f"{store.root}: no array {name!r} ({name}/.zarray)") from None
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}: zarr_format {meta.get('zarr_format')}; 2 is read")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{name}: order {meta['order']!r}; only C order is read")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{name}: filters {meta['filters']}; none are read")
    compressor = meta.get("compressor")
    if (compressor or {}).get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: compressor {compressor}; only zstd is read")
    dtype, bf16 = _dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise OrbaxFormatError(f"{name}: chunks {list(chunks)} for shape {list(shape)}")
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    whole = tuple(grid) == (1,) * len(shape) and chunks == shape
    fill = _fill(meta, dtype, name)
    for index in product(*(range(g) for g in grid)):
        key = f"{name}/" + (sep.join(map(str, index)) if shape else "0")
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        if key not in store:
            if fill is None:
                raise OrbaxFormatError(f"{store.root}: chunk {key} is absent and the array "
                                       "has no fill_value")
            out[region] = fill
            continue
        chunk = out if whole else np.empty(chunks, dtype)
        zstd.decompress_into(store.read(key), chunk)
        if not whole:
            out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# -------------------------------------------------------------- the pytree
#: orbax's empty-value type strings → the value its restore without a target
#: gives (a NamedTuple without rich types restores as None)
_EMPTY = {"Dict": dict, "List": list, "Tuple": tuple, "None": lambda: None,
          "NamedTuple": lambda: None}


def read_tree(arrays_dir) -> dict:
    """The pytree an orbax ``StandardCheckpointHandler`` saved in
    ``arrays_dir``: dicts for dict keys, lists for sequence indices, numpy
    arrays (``torch.bfloat16`` tensors for bfloat16) at the leaves."""
    arrays_dir = Path(arrays_dir)
    try:
        metadata = json.loads((arrays_dir / "_METADATA").read_text())
    except FileNotFoundError:
        raise OrbaxFormatError(f"{arrays_dir} holds no _METADATA") from None
    if not metadata.get("use_ocdbt", False):
        raise OrbaxFormatError(f"{arrays_dir}: use_ocdbt is false; only OCDBT trees are read")
    if metadata.get("use_zarr3", False):
        raise OrbaxFormatError(f"{arrays_dir}: use_zarr3 is true; only zarr v2 is read")
    store = Ocdbt(arrays_dir)
    root: dict = {}
    for entry in metadata["tree_metadata"].values():
        path = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        if value.get("skip_deserialize"):
            if value["value_type"] not in _EMPTY:
                raise OrbaxFormatError(f"{arrays_dir}: skipped value of type "
                                       f"{value['value_type']!r} at {path}")
            leaf = _EMPTY[value["value_type"]]()
        else:
            leaf = read_array(store, ".".join(str(k) for k, _ in path))
        _insert(root, path, leaf)
    return _lists(root)


def _insert(node: dict, path: list, leaf) -> None:
    """Place ``leaf`` at ``path``; a sequence index is kept as an int key
    until :func:`_lists`."""
    for i, (key, key_type) in enumerate(path):
        if key_type not in (1, 2):
            raise OrbaxFormatError(f"key type {key_type} at {path}")
        key = int(key) if key_type == 1 else key
        if i == len(path) - 1:
            node[key] = leaf
        else:
            node = node.setdefault(key, {})


def _lists(node):
    """Turn the dicts keyed by sequence index into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise OrbaxFormatError(f"sequence indices {sorted(out)} are not 0..{len(out) - 1}")
        return [out[i] for i in range(len(out))]
    return out
