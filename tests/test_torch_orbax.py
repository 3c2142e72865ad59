"""The port reads the JAX package's orbax checkpoint directories.

* zstd (``utils/zstd.py``, the system's ``libzstd`` through ctypes) against
  the ``zstandard`` package: random bytes, float32 weights and repetitive
  data at levels 1, 3 and 19, multi-block frames over 128 KiB, frames with
  and without a content size, an empty frame, concatenated frames; a
  corrupt or truncated frame and a missing library raise.
* OCDBT (``runner/orbax_read.py``): every key and value of stores written
  here by tensorstore (no compression, values stored by reference, B-tree
  interior nodes, a version tree of arity 2 over 20 generations) and by
  orbax equal tensorstore's own reading; a corrupt node raises.
* zarr v2: arrays of every dtype the checkpoints hold, over several
  chunks with partial edge chunks and absent chunks, equal tensorstore's;
  F order, filters and other compressors raise.
* Checkpoints: the flagship ``configs/train/refine_net/exp1_x4.yaml`` at
  full width with its Adam state, EDVRNet at full width, a BatchNorm net (DUF) with its
  ``batch_stats``, and a toy tree with ``apply_if_finite``, bfloat16 and
  skipped containers, each saved by the JAX package's
  ``save_checkpoint(..., backend="orbax")``: the port's ``load_checkpoint``
  equals its reading of the JAX pickle of the same state bit for bit, and
  ``read_tree`` equals the JAX package's own ``load_checkpoint``.
* The committed two-process fixture ``tests/data/jax_orbax_2proc``
  (``tests/torch_orbax_fixture.py``) against JAX's reading and
  ``expected.json``; the port's ``tools/serve.py`` and
  ``tools/batch_infer.py`` serve it as they serve a ``.pth`` of its weights.
* The repair: ``find_latest_checkpoint`` finds the newest committed JAX
  orbax directory and skips a half-written one; the port's ``main`` with
  ``loaded_path: auto`` resumes a JAX orbax run (no fresh start, its
  checkpoints kept) and its epoch follows the JAX trainer's own resumed
  epoch within ``tests/test_torch_resume.py``'s tolerances.
"""
import hashlib
import json
import logging
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import zstandard

import jax
import tensorstore as ts

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import main as jax_main
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.config import (
    Cfg as JaxCfg,
    load_config,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner import (
    checkpoint as jax_ckpt,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.optim import (
    Optimizer as JaxOptimizer,
    build_optimizer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.torch_import import (
    variables_from_torch_state_dict,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import main as port_main
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import Cfg
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
    DUFNet,
    EDVRNet,
    RefineNet,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import (
    checkpoint as ckpt_io,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import (
    orbax_read,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import (
    batch_infer as port_batch_infer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import (
    serve as port_serve,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils import zstd

sys.path.insert(0, str(Path(__file__).parent))
from torch_orbax_common import array_record, fill, leaves, write_tree  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "data" / "jax_orbax_2proc"


# ------------------------------------------------------------------ zstd
def _data(kind: str) -> bytes:
    rng = np.random.default_rng(0)
    if kind == "random":  # incompressible: raw blocks, 3 of them
        return rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    if kind == "float32":
        return (rng.standard_normal(100_000) * 0.05).astype(np.float32).tobytes()
    return b"phase-aware cine MRI " * 20_000  # repetitive, 420 kB


def _frame(data: bytes, level: int, with_size: bool) -> bytes:
    if with_size:
        return zstandard.ZstdCompressor(level=level, write_content_size=True).compress(data)
    stream = zstandard.ZstdCompressor(level=level, write_content_size=False).compressobj()
    return stream.compress(data) + stream.flush()


@pytest.mark.parametrize("with_size", [True, False], ids=["size", "no_size"])
@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("kind", ["random", "float32", "repetitive"])
def test_zstd_matches_zstandard(kind, level, with_size):
    data = _data(kind)
    frame = _frame(data, level, with_size)
    want = zstandard.ZstdDecompressor().decompressobj().decompress(frame)
    assert zstd.decompress(frame) == want == data
    out = np.empty(len(data), np.uint8)
    zstd.decompress_into(frame, out)
    assert out.tobytes() == data


@pytest.mark.parametrize("with_size", [True, False], ids=["size", "no_size"])
def test_zstd_empty_and_concatenated_frames(with_size):
    assert zstd.decompress(_frame(b"", 3, with_size)) == b""
    zstd.decompress_into(_frame(b"", 3, with_size), bytearray())
    frames = _frame(b"first frame ", 1, with_size) + _frame(b"second", 19, with_size)
    assert zstd.decompress(frames) == b"first frame second"


@pytest.mark.parametrize("fault", ["flipped", "truncated", "truncated_no_size", "not_zstd",
                                   "wrong_size"])
def test_zstd_corrupt_frame_raises(fault):
    data = _data("float32")
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    if fault == "flipped":  # the frame's content checksum catches it
        frame = bytearray(frame)
        frame[len(frame) // 2] ^= 0x5A
        bad = bytes(frame)
    elif fault == "truncated":
        bad = frame[:-100]
    elif fault == "truncated_no_size":
        bad = _frame(data, 3, False)[:-100]
    elif fault == "not_zstd":
        bad = data[:1000]
    if fault == "wrong_size":
        with pytest.raises(zstd.ZstdError, match="expected"):
            zstd.decompress_into(frame, np.empty(len(data) // 4 + 1, np.float32))
        return
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bad)


def test_zstd_without_the_library_raises(monkeypatch):
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd.ctypes.util, "find_library", lambda name: None)
    with pytest.raises(zstd.ZstdUnavailable, match="libzstd"):
        zstd.decompress(_frame(b"x", 1, True))


def test_crc32c_known_value():
    assert orbax_read.crc32c(b"123456789") == 0xE3069283
    assert orbax_read.crc32c(b"") == 0


# ------------------------------------------------------------------ OCDBT
STORES = {  # tensorstore's ocdbt config → what it exercises
    "uncompressed": ({"compression": None}, 30, 3, 50),
    "by_reference": ({"max_inline_value_bytes": 16}, 30, 3, 300),
    "interior_nodes": ({"max_decoded_node_bytes": 256, "max_inline_value_bytes": 16}, 400, 2, 100),
    "version_tree": ({"version_tree_arity_log2": 1}, 40, 20, 30),
}


def _write_store(root: Path, config: dict, n_keys: int, commits: int, max_len: int) -> Path:
    """``n_keys`` keys written by tensorstore over ``commits`` transactions."""
    rng = np.random.default_rng(n_keys)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}", "config": config}).result()
    keys = [f"net.block{i:04d}.kernel/{'0.' * (i % 4)}0" for i in range(n_keys)]
    for commit in range(commits):
        with ts.Transaction() as txn:
            for i, key in enumerate(keys):
                if i % commits == commit:
                    n = int(rng.integers(0, max_len))
                    kv.with_transaction(txn)[key] = rng.integers(0, 6, n, dtype=np.uint8).tobytes()
    return root


def _tensorstore_items(root: Path) -> dict:
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}"}).result()
    return {k: bytes(kv.read(k).result().value) for k in kv.list().result()}


def _port_items(root: Path) -> dict:
    store = orbax_read.Ocdbt(root)
    return {k: store.read(k) for k in store.keys()}


@pytest.mark.parametrize("name", sorted(STORES))
def test_ocdbt_matches_tensorstore(tmp_path, name):
    root = _write_store(tmp_path / name, *STORES[name])
    want = _tensorstore_items(root)
    assert len(want) == STORES[name][1]
    assert _port_items(root) == want
    store = orbax_read.Ocdbt(root)
    assert store.height >= 1 if name == "interior_nodes" else store.height == 0


def test_ocdbt_emptied_store_reads_empty(tmp_path):
    """A store whose keys were all deleted: its newest root is missing."""
    root = _write_store(tmp_path / "store", *STORES["uncompressed"])
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}"}).result()
    kv.delete_range(ts.KvStore.KeyRange()).result()
    assert _tensorstore_items(root) == {} == _port_items(root)
    assert orbax_read.Ocdbt(root).height is None


@pytest.mark.parametrize("target", ["node", "manifest"])
def test_ocdbt_corrupt_file_raises(tmp_path, target):
    root = _write_store(tmp_path / "store", *STORES["uncompressed"])
    path = root / "manifest.ocdbt" if target == "manifest" else max(
        (root / "d").iterdir(), key=lambda p: p.stat().st_size)
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0x01
    path.write_bytes(bytes(blob))
    with pytest.raises(orbax_read.OrbaxFormatError, match="crc32c mismatch"):
        _port_items(root)


# ------------------------------------------------------------------ zarr v2
ZARR = {  # name → (dtype, shape, chunks)
    "f4_grid": ("<f4", (7, 5, 3), (3, 2, 3)),
    "f8_edge": ("<f8", (10,), (4,)),
    "i4_scalar": ("<i4", (), ()),
    "i8_matrix": ("<i8", (3, 4), (2, 4)),
    "b1_grid": ("|b1", (5, 6), (2, 5)),
    "bf16_grid": ("bfloat16", (9, 4), (4, 3)),
}


def _zarr_spec(root: Path, name: str, metadata: dict | None = None, create: bool = False) -> dict:
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{root}",
                                          "path": f"{name}/"}}
    if create:
        spec.update(create=True, metadata=metadata)
    return spec


def _random(dtype: str, shape, rng):
    if dtype == "|b1":
        return rng.integers(0, 2, shape).astype(bool)
    if dtype in ("<i4", "<i8"):
        return rng.integers(-1000, 1000, shape).astype(np.dtype(dtype))
    values = rng.standard_normal(shape)
    return values.astype(jax.numpy.bfloat16) if dtype == "bfloat16" else values.astype(dtype)


def test_zarr_arrays_match_tensorstore(tmp_path):
    rng = np.random.default_rng(3)
    root = tmp_path / "arrays"
    for name, (dtype, shape, chunks) in ZARR.items():
        metadata = {"dtype": dtype, "shape": list(shape), "chunks": list(chunks),
                    "compressor": {"id": "zstd", "level": 1}, "fill_value": None}
        array = ts.open(_zarr_spec(root, name, metadata, create=True)).result()
        array.write(_random(dtype, shape, rng)).result()
    # fill_value 0: the chunks tensorstore leaves unwritten (all zero) are absent
    metadata = {"dtype": "<f4", "shape": [8, 8], "chunks": [4, 4], "fill_value": 0,
                "compressor": {"id": "zstd", "level": 3}}
    sparse = ts.open(_zarr_spec(root, "sparse", metadata, create=True)).result()
    sparse[4:, :4].write(np.ones((4, 4), np.float32)).result()
    store = orbax_read.Ocdbt(root)
    assert sum(k.startswith(b"sparse/") for k in store.keys()) == 2  # .zarray and one chunk
    assert sum(k.startswith(b"f4_grid/") for k in store.keys()) == 1 + 3 * 3 * 1
    for name in [*ZARR, "sparse"]:
        want = ts.open(_zarr_spec(root, name)).result().read().result()
        got = orbax_read.read_array(store, name)
        if name == "bf16_grid":
            assert got.dtype == torch.bfloat16
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("fault", ["order_F", "filters", "blosc", "absent_chunk"])
def test_zarr_refuses_what_it_does_not_read(tmp_path, fault):
    root = tmp_path / "arrays"
    metadata = {"dtype": "<f4", "shape": [4, 4], "chunks": [2, 4], "fill_value": None,
                "compressor": {"id": "zstd", "level": 1}}
    array = ts.open(_zarr_spec(root, "w", metadata, create=True)).result()
    array.write(np.arange(16, dtype=np.float32).reshape(4, 4)).result()
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}"}).result()
    zarray = json.loads(bytes(kv.read("w/.zarray").result().value))
    if fault == "absent_chunk":
        kv.delete_range(ts.KvStore.KeyRange("w/1.0", "w/1.0\0")).result()
    else:
        zarray.update({"order_F": {"order": "F"}, "filters": {"filters": [{"id": "delta"}]},
                       "blosc": {"compressor": {"id": "blosc"}}}[fault])
        kv["w/.zarray"] = json.dumps(zarray).encode()
    with pytest.raises(orbax_read.OrbaxFormatError,
                       match={"order_F": "order", "filters": "filters", "blosc": "compressor",
                              "absent_chunk": "absent"}[fault]):
        orbax_read.read_array(orbax_read.Ocdbt(root), "w")


# ------------------------------------------------------------- checkpoints
def _seeded_like(tree, seed: int):
    """``tree`` with every float array (Adam's moments) drawn from a numpy
    seed and the int leaves (the counts) set to 7; float scalars (the
    learning rate) kept."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        x = np.asarray(x)
        if x.dtype.kind == "f":
            return rng.standard_normal(x.shape).astype(x.dtype) if x.ndim else x
        return np.full(x.shape, 7, x.dtype)

    return jax.tree.map(leaf, tree)


def _save_both(directory: Path, epoch: int, **state) -> tuple[Path, Path]:
    """The JAX package's orbax directory and pickle of the same state."""
    orbax_dir, pickle_file = directory / f"model_{epoch}.pth", directory / f"pickle_{epoch}.pth"
    jax_ckpt.save_checkpoint(orbax_dir, epoch=epoch, backend="orbax", **state)
    jax_ckpt.save_checkpoint(pickle_file, epoch=epoch, **state)
    return orbax_dir, pickle_file


def _assert_same_reading(got: dict, want: dict) -> None:
    """Two ``load_checkpoint`` results equal bit for bit."""
    assert got.keys() == want.keys()
    assert got["epoch"] == want["epoch"]
    for key in ("monitor", "lr_scheduler", "seed_state"):
        assert got.get(key) == want.get(key), key
    assert got["net"].keys() == want["net"].keys()
    for name, value in want["net"].items():
        assert got["net"][name].dtype == value.dtype and torch.equal(got["net"][name], value), name
    g_opt, w_opt = got.get("optimizer_jax"), want.get("optimizer_jax")
    assert (g_opt is None) == (w_opt is None)
    if w_opt is not None:
        assert {k: v for k, v in g_opt.items() if k != "moments"} == {
            k: v for k, v in w_opt.items() if k != "moments"}
        assert g_opt.get("moments", {}).keys() == w_opt.get("moments", {}).keys()
        for name, (mu, nu) in w_opt.get("moments", {}).items():
            assert torch.equal(g_opt["moments"][name][0], mu), name
            assert torch.equal(g_opt["moments"][name][1], nu), name


def _assert_tree_equal(got, want, path="") -> None:
    """``read_tree``'s tree against orbax's restore: containers and leaves."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        want = np.asarray(want)
        if isinstance(got, torch.Tensor):  # bfloat16
            assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16", path
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_flagship_at_full_width_reads_as_its_pickle(tmp_path):
    cfg = load_config(REPO / "configs" / "train" / "refine_net" / "exp1_x4.yaml")
    net = RefineNet(**cfg.net.kwargs, generator=torch.Generator().manual_seed(0))
    params = variables_from_torch_state_dict("RefineNet", net.state_dict())["params"]
    assert sum(np.size(x) for x in jax.tree.leaves(params)) == 2_890_992
    opt_state = _seeded_like(build_optimizer(cfg.optimizer).init(params), 1)
    monitor = {"mode": "min", "target": "Loss", "saved_freq": 10, "early_stop": float("inf"),
               "best": 0.125, "not_improved_count": 2}
    orbax_dir, pickle_file = _save_both(tmp_path, 5, params=params, opt_state=opt_state,
                                        monitor_state=monitor)
    got = ckpt_io.load_checkpoint(orbax_dir)
    _assert_same_reading(got, ckpt_io.load_checkpoint(pickle_file))
    assert got["epoch"] == 5 and got["optimizer_jax"]["step"] == 7 and got["monitor"] == monitor
    assert got["optimizer_jax"]["lr"] == pytest.approx(1e-4)
    assert len(got["optimizer_jax"]["moments"]) == len(got["net"]) - 1  # the dead PReLU
    assert ckpt_io.load_net_state_dict(orbax_dir).keys() == net.state_dict().keys()


def test_edvr_at_full_width_reads_as_its_pickle(tmp_path):
    """``configs/train/edvr_net/exp1_x4.yaml``'s EDVRNet, the largest net of
    the zoo (82.5 MB of weights, read in 266 zstd chunks), without its Adam
    state, whose 248 MB would double the test's time."""
    cfg = load_config(REPO / "configs" / "train" / "edvr_net" / "exp1_x4.yaml")
    net = EDVRNet(**cfg.net.kwargs, generator=torch.Generator().manual_seed(0))
    params = variables_from_torch_state_dict("EDVRNet", net.state_dict())["params"]
    assert sum(np.size(x) for x in jax.tree.leaves(params)) == 20_630_369
    orbax_dir, pickle_file = _save_both(tmp_path, 1, params=params)
    got = ckpt_io.load_checkpoint(orbax_dir, "EDVRNet")
    _assert_same_reading(got, ckpt_io.load_checkpoint(pickle_file, "EDVRNet"))
    assert got["net"].keys() == net.state_dict().keys()


def test_batch_norm_net_reads_as_its_pickle(tmp_path):
    kwargs = {"in_channels": 1, "out_channels": 1, "num_frames": 3, "size_filter": 3,
              "upscale_factor": 4, "backbone": "_DenseLayer16"}
    net = DUFNet(**kwargs)
    torch.manual_seed(0)
    with torch.no_grad():
        for name, buffer in net.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buffer.copy_(torch.rand_like(buffer) + 0.5)
    variables = variables_from_torch_state_dict("DUFNet", net.state_dict())
    assert "batch_stats" in variables
    opt_state = _seeded_like(JaxOptimizer("Adam", lr=1e-3).init(variables["params"]), 2)
    orbax_dir, pickle_file = _save_both(tmp_path, 3, params=variables["params"],
                                        model_state={"batch_stats": variables["batch_stats"]},
                                        opt_state=opt_state)
    got = ckpt_io.load_checkpoint(orbax_dir, "DUFNet")
    _assert_same_reading(got, ckpt_io.load_checkpoint(pickle_file, "DUFNet"))
    DUFNet(**kwargs).load_state_dict(got["net"], strict=True)
    for name, value in net.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            assert torch.equal(got["net"][name], value), name


def test_guarded_bf16_tree_reads_as_orbax_restores_it(tmp_path):
    """``apply_if_finite`` over ``inject_hyperparams`` with clipping, a
    key holding a dot, a bfloat16 leaf, and the empty containers orbax
    skips (optax's ``EmptyState``, an empty dict, list and tuple)."""
    rng = np.random.default_rng(5)
    params = {"conv.a": {"kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32)},
              "b": {"w": rng.standard_normal((6,)).astype(np.float32)}}
    opt = JaxOptimizer("Adam", lr=2e-4, grad_clip_norm=1.0, skip_nonfinite=3)
    opt_state = _seeded_like(opt.init(params), 4)
    model_state = {"batch_stats": {"bn": {"mean": np.arange(4, dtype=np.float32)}},
                   "extra": {"half": rng.standard_normal((2, 5)).astype(jax.numpy.bfloat16),
                             "empty_dict": {}, "empty_list": [], "empty_tuple": ()}}
    orbax_dir = tmp_path / "model_2.pth"
    jax_ckpt.save_checkpoint(orbax_dir, params=params, opt_state=opt_state,
                             model_state=model_state, epoch=2, backend="orbax")
    tree = orbax_read.read_tree(orbax_dir / "arrays")
    restored = jax_ckpt.load_checkpoint(orbax_dir)
    for part in ("net", "optimizer", "model_state"):
        _assert_tree_equal(tree[part], restored[part], part)
    # the pickle's optax namedtuples read into orbax's form: the same
    # containers, so one structural reading finds Adam, the learning rate
    # and the guard's counters in both
    jax_ckpt.save_checkpoint(tmp_path / "pickle_2.pth", params=params, opt_state=opt_state)
    pickled = ckpt_io._read_jax_payload(tmp_path / "pickle_2.pth")["optimizer"]
    _assert_tree_equal(ckpt_io._as_orbax_tree(pickled), restored["optimizer"], "optimizer")
    for fields in (("count", "mu", "nu"), ("hyperparams",),
                   ("notfinite_count", "last_finite", "total_notfinite")):
        assert ckpt_io._find(tree["optimizer"], *fields) is not None, fields


def test_two_process_fixture_matches_jax_and_expected():
    expected = json.loads((FIXTURE / "expected.json").read_text())
    ckpt = FIXTURE / expected["checkpoint"]
    assert expected["processes"] == ["ocdbt.process_0"]
    assert (ckpt / "arrays" / "ocdbt.process_0" / "manifest.ocdbt").is_file()
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    assert size <= 512 * 1024
    tree = orbax_read.read_tree(ckpt / "arrays")
    restored = jax_ckpt.load_checkpoint(ckpt)
    for part in ("net", "optimizer", "model_state"):
        _assert_tree_equal(tree.get(part) or None, restored.get(part) or None, part)
    got = {f"{part}/{path}": array_record(leaf) for part in ("net", "optimizer", "model_state")
           for path, leaf in leaves(tree.get(part))}
    assert got == expected["arrays"]
    loaded = ckpt_io.load_checkpoint(ckpt)
    assert loaded["epoch"] == expected["epoch"] == restored["epoch"]
    assert loaded["optimizer_jax"]["step"] == int(restored["optimizer"]["count"])
    RefineNet(**expected["net"]).load_state_dict(loaded["net"], strict=True)


def test_serve_and_batch_infer_read_the_fixture(tmp_path):
    """Both tools with the orbax directory give what they give with a
    ``{'net': state_dict}`` ``.pth`` of the same weights, byte for byte."""
    expected = json.loads((FIXTURE / "expected.json").read_text())
    tree = write_tree(tmp_path / "acdc")
    ckpt = FIXTURE / expected["checkpoint"]
    pth = tmp_path / "model.pth"
    torch.save({"net": ckpt_io.load_net_state_dict(ckpt)}, pth)
    outs = {}
    for name, path in (("orbax", ckpt), ("pth", pth)):
        csv_path = tmp_path / f"{name}.csv"
        port_batch_infer.main([str(path), str(tree["videos"]), str(tree["pos_code"]),
                               str(csv_path), "--net-kwargs", json.dumps(expected["net"]),
                               "--device", "cpu"])
        config = tmp_path / f"{name}.yaml"
        config.write_text(json.dumps({"net": {"name": "RefineNet", "kwargs": expected["net"]},
                                      "main": {"loaded_path": str(path)}}))
        served = tmp_path / f"served_{name}"
        assert port_serve.main([str(config), "--in", str(tree["videos"] / "test" / "LR" / "X4"),
                                "--out", str(served), "--pos-code", str(tree["pos_code"]),
                                "--device", "cpu"]) == 1
        outs[name] = (csv_path.read_bytes(), _file_digests(served))
    assert outs["orbax"] == outs["pth"]
    assert len(outs["orbax"][1]) == 1 and outs["orbax"][0].count(b"\n") == 1 + 12


# ----------------------------------------------------------------- repair
def _tiny_state():
    rng = np.random.default_rng(6)
    return {"params": {"w": rng.standard_normal((2, 3)).astype(np.float32)}}


def test_find_latest_checkpoint_takes_the_newest_committed_jax_directory(tmp_path):
    ckpts = tmp_path / "checkpoints"
    for epoch in (1, 2, 3):
        jax_ckpt.save_checkpoint(ckpts / f"model_{epoch}.pth", epoch=epoch, backend="orbax",
                                 **_tiny_state())
    # model_3 as a crash between the meta sidecar and orbax's commit leaves it
    shutil.rmtree(ckpts / "model_3.pth" / "arrays")
    assert jax_ckpt.find_latest_checkpoint(ckpts) == ckpts / "model_2.pth"
    assert ckpt_io.find_latest_checkpoint(ckpts) == ckpts / "model_2.pth"
    assert ckpt_io._peek_epoch(ckpts / "model_2.pth") == 2
    with pytest.raises(FileNotFoundError, match=r"half-written .*arrays/ \(meta\.pkl present\)"):
        ckpt_io.load_checkpoint(ckpts / "model_3.pth")
    # a preemption directory of a later epoch wins, as in the JAX package
    jax_ckpt.save_checkpoint(ckpts / "model_preempted.pth", epoch=2, backend="orbax",
                             **_tiny_state())
    assert ckpt_io.find_latest_checkpoint(ckpts) == ckpts / "model_preempted.pth"
    # the port's own layout still names what it lacks
    port_dir = tmp_path / "port" / "model_4.pth"
    (port_dir / "arrays").mkdir(parents=True)
    torch.save({"epoch": 4}, port_dir / "meta.pt")
    assert ckpt_io.find_latest_checkpoint(port_dir.parent) is None
    with pytest.raises(FileNotFoundError, match=r"arrays/\.metadata never committed"):
        ckpt_io.load_checkpoint(port_dir)


def _run_cfg(tree: dict, saved_dir: Path, num_epochs: int, loaded_path, backend: str) -> dict:
    expected = json.loads((FIXTURE / "expected.json").read_text())
    cfg = fill(expected["train_config"], saved_dir=saved_dir, device="cpu", **tree)
    cfg["main"]["loaded_path"] = loaded_path
    cfg["net"]["kwargs"] = {**cfg["net"]["kwargs"], "num_features": [4, 4]}
    # 6 Adam steps an epoch: at 12 (batch 2) the port's epoch parts from
    # JAX's by 4.1e-5 on the valid loss, whether it resumed from the orbax
    # directory or from JAX's pickle of the same epoch (the two equal bit
    # for bit): the float trajectories part, not the reading
    cfg["dataloader"]["kwargs"]["train_batch_size"] = 4
    cfg["trainer"]["kwargs"].update(num_epochs=num_epochs, checkpoint_backend=backend)
    return cfg


def _file_digests(directory: Path) -> dict:
    return {str(p.relative_to(directory)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(directory.rglob("*")) if p.is_file()}


def test_port_main_auto_resumes_a_jax_orbax_run(tmp_path, caplog):
    tree = {k: v for k, v in write_tree(tmp_path / "acdc").items()
            if k in ("videos", "pos_code", "coordinates")}
    jax_run = tmp_path / "jax"
    jax_main.train_from_config(JaxCfg(_run_cfg(tree, jax_run, 1, None, "orbax")))
    first = jax_run / "checkpoints" / "model_1.pth"
    assert (first / "meta.pkl").is_file() and (first / "arrays").is_dir()
    port_run = tmp_path / "port"
    shutil.copytree(jax_run, port_run)
    before = _file_digests(port_run / "checkpoints")
    # the same first epoch as JAX's pickle, for the port to resume from too
    pickle_run = tmp_path / "jax_pickle"
    jax_main.train_from_config(JaxCfg(_run_cfg(tree, pickle_run, 1, None, "pickle")))
    assert (pickle_run / "checkpoints" / "model_1.pth").is_file()

    # the JAX trainer's own resumed epoch
    resumed = jax_main.train_from_config(JaxCfg(_run_cfg(tree, jax_run, 2, "auto", "orbax")))
    with caplog.at_level(logging.INFO):
        port = port_main.train_from_config(Cfg(_run_cfg(tree, port_run, 2, "auto", "pickle")))
    from_pickle = port_main.train_from_config(Cfg(_run_cfg(tree, pickle_run, 2, "auto", "pickle")))
    assert port.history == from_pickle.history  # the readings resume the same run, bit for bit
    assert any("Auto-resume: found" in r.getMessage() and "model_1.pth" in r.getMessage()
               for r in caplog.records)
    assert port.epoch == resumed.epoch == 3
    want, got = resumed.history, port.history
    for split in ("train", "valid"):
        assert len(got[split]) == len(want[split]) == 1
        for key, tol in (("Loss", 1e-5), ("L1Loss", 1e-5), ("PSNR", 1e-4), ("SSIM", 1e-4)):
            assert got[split][0][key] == pytest.approx(want[split][0][key], rel=tol, abs=1e-7), \
                (split, key)
    # the JAX run's checkpoints are all still there, byte for byte
    after = _file_digests(port_run / "checkpoints")
    assert all(after.get(name) == digest for name, digest in before.items()
               if not name.startswith("model_best.pth"))
    assert (port_run / "checkpoints" / "model_2.pth").is_file()
    assert os.path.isdir(port_run / "checkpoints" / "model_1.pth" / "arrays")
