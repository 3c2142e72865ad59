"""Datasets of the ported paths (ACDC / DSB15 cardiac cine-MRI).

The port's copies of the JAX package's ``SISRDataset`` (one 2D frame in,
one out), ``MISRDataset`` (a window of frames in, its reference frame out),
``VSRDataset`` (a window or a whole sequence in, as many frames out) and
``VSRRefineNetDataset``: items are dicts of channel-last numpy arrays,
(H, W, C) frames and (T, H, W, C) windows with time as the leading axis,
exactly as the JAX package yields them.  Train items run
the config's augments with the ``rng`` the loader hands each item
(``item_rng``), then its transforms; valid and test items run the
transforms only.  One
implementation is registered under both the Acdc and the Dsb15 name.
"""
from __future__ import annotations

import os
import pickle
import threading
from collections import OrderedDict
from pathlib import Path

import numpy as np

from ..config import DATASETS
from ..utils import native_io, nifti
from .transforms import Normalize, compose


def _file_key(path) -> tuple:
    """The key of a process-wide cache entry: the file itself, not the string
    the caller named it by.  Its resolved absolute path (so a relative path
    read after a ``chdir`` reaches the other tree) with the ``st_mtime_ns``
    and ``st_size`` of one ``stat`` (so a file rewritten in place is read
    again).  The JAX package keys its caches by ``str(path)``
    (``..._tpu/data/datasets.py:32-88``); the port deliberately does not."""
    real = os.path.realpath(path)
    st = os.stat(real)
    return real, st.st_mtime_ns, st.st_size


class _VolumeCache:
    """Process-wide LRU of decoded NIfTI volumes, shared by the loader
    threads (a window or an epoch re-reads the same sequence file), keyed by
    :func:`_file_key`."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._cache = OrderedDict()
        # OrderedDict reordering/eviction is not atomic; decode runs outside
        self._lock = threading.Lock()

    def get(self, path: Path) -> np.ndarray:
        key = _file_key(path)
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
        data = _read_volume(key[0])
        with self._lock:
            self._cache[key] = data
            if len(self._cache) > self.capacity:
                self._cache.popitem(last=False)
        return data


def _read_volume(path) -> np.ndarray:
    """A cache miss: the native threaded decoder when it is built
    (``utils/native_io.py``; float32, as the JAX package's datasets read),
    else the Python reader; ``EVSR_NO_NATIVE_IO=1`` switches the native one
    off."""
    if native_io.enabled():
        return native_io.load_volume(path)
    return np.asarray(nifti.load(path).get_data())


_VOLUMES = _VolumeCache()
_PICKLES: dict[tuple, dict] = {}
_PICKLES_LOCK = threading.Lock()


def _load_pickle(path) -> dict:
    """A pickle read once per file (:func:`_file_key`)."""
    key = _file_key(path)
    with _PICKLES_LOCK:
        if key not in _PICKLES:
            with open(key[0], "rb") as f:
                _PICKLES[key] = pickle.load(f)
        return _PICKLES[key]


def _frames(vol: np.ndarray) -> list[np.ndarray]:
    """(H, W, C, T) volume → list of T (H, W, C) frames."""
    return [vol[..., t] for t in range(vol.shape[-1])]


def _window(start: int, end: int, vol: np.ndarray) -> np.ndarray:
    """Frames [start, end) of a (H, W, C, T) volume with circular wrap
    (reference ``acdc_misr_dataset.py:59-68``), in the reference's branch
    order: with ``start < 0`` the tail ``vol[:end]`` takes no modulo (numpy
    clamps an ``end`` past T), so a window longer than the sequence is the
    wrapped start plus the whole sequence; only a nonnegative start with
    ``end > T`` reduces ``end`` mod T."""
    T = vol.shape[-1]
    if start < 0:
        return np.concatenate((vol[..., start:], vol[..., :end]), axis=-1)
    if end > T:
        return np.concatenate((vol[..., start:], vol[..., : end % T]), axis=-1)
    return vol[..., start:end]


class BaseDataset:
    def __init__(self, data_dir, type):
        self.data_dir = Path(data_dir)
        if type not in ("train", "valid", "test"):
            raise ValueError(f"The type should be 'train', 'valid' or 'test'. Got {type}.")
        self.type = type

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError


class _SRDatasetBase(BaseDataset):
    """Shared path-indexing for paired LR/HR trees."""

    glob_pattern = "**/*2d+1d*.nii.gz"

    def __init__(self, data_dir, type, downscale_factor, transforms, augments=None, **kwargs):
        super().__init__(data_dir, type)
        if downscale_factor not in (2, 3, 4):
            raise ValueError(f"The downscale factor should be 2, 3, 4. Got {downscale_factor}.")
        self.downscale_factor = downscale_factor
        self.transforms = compose(transforms)
        self.augments = compose(augments) if augments else None

    def _paired_paths(self):
        lr_paths = sorted(
            (self.data_dir / self.type / "LR" / f"X{self.downscale_factor}").glob(self.glob_pattern)
        )
        hr_paths = sorted((self.data_dir / self.type / "HR").glob(self.glob_pattern))
        return list(zip(lr_paths, hr_paths))

    def _bounds(self, t: int) -> tuple[int, int]:
        """[start, end) of the window around frame ``t`` (reference
        ``acdc_misr_dataset.py:52-58``): ending at ``t`` for
        ``temporal_order: last``, else centred (the extra frame after)."""
        n = self.num_frames
        if self.temporal_order == "last":
            return t - n + 1, t + 1
        return t - (n - 1) // 2, t + ((n - 1) - (n - 1) // 2) + 1

    def _explicit_normalize(self) -> int | None:
        """Index of the pipeline's explicit-stats ``Normalize``, or ``None``:
        image-level-stats normalization (``means: null``) depends on each
        item and cannot move to the device."""
        return next((i for i, t in enumerate(self.transforms.transforms)
                     if isinstance(t, Normalize) and t.means is not None), None)

    def deferrable_normalize(self):
        """(means, stds) of the pipeline's explicit-stats ``Normalize``, or
        ``None``."""
        i = self._explicit_normalize()
        if i is None:
            return None
        t = self.transforms.transforms[i]
        return list(t.means), list(t.stds)

    def defer_normalize(self):
        """Pop the explicit-stats ``Normalize`` off the host pipeline and
        return its (means, stds), so the trainer's ``int_feed`` applies the
        same per-channel ``(x - mean) / (std + 1e-10)`` on the device.
        Items then leave ``__getitem__`` in the source intensity scale."""
        i = self._explicit_normalize()
        if i is None:
            return None
        t = self.transforms.transforms.pop(i)
        return list(t.means), list(t.stds)

    def _apply(self, imgs: list[np.ndarray], rng: np.random.Generator | None) -> list[np.ndarray]:
        """Augment (train only) then transform a tuple of images."""
        rng = rng if rng is not None else np.random.default_rng()
        if self.type == "train" and self.augments is not None:
            imgs = self.augments(*imgs, rng=rng)
            if isinstance(imgs, np.ndarray):
                imgs = [imgs]
        out = self.transforms(*imgs, rng=rng)
        if isinstance(out, np.ndarray):
            out = [out]
        return list(out)


class SISRDataset(_SRDatasetBase):
    """Single-image SR over per-frame 2D NIfTIs (reference ``acdc_sisr_dataset.py``):
    an item is ``{"lr_img", "hr_img", "index"}`` of (H, W, C) frames."""

    glob_pattern = "**/*2d*.nii.gz"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.data = self._paired_paths()

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index, rng=None):
        lr_path, hr_path = self.data[index]
        lr_img, hr_img = self._apply([_VOLUMES.get(lr_path), _VOLUMES.get(hr_path)], rng)
        return {"lr_img": lr_img, "hr_img": hr_img, "index": index}


class MISRDataset(_SRDatasetBase):
    """Multi-image SR (reference ``acdc_misr_dataset.py``): one item per
    (sequence, frame t), ``{"lr_imgs": (T, h, w, C) window around t,
    "hr_img": the window's reference HR frame, "index"}``; the window and
    its HR twin go through the augments and transforms together."""

    def __init__(self, *args, num_frames=5, temporal_order="middle", **kwargs):
        super().__init__(*args, **kwargs)
        if temporal_order not in ("last", "middle"):
            raise ValueError(f"temporal_order must be 'last' or 'middle'; got {temporal_order}.")
        self.num_frames = num_frames
        self.temporal_order = temporal_order
        self.data = []
        for lr_path, hr_path in self._paired_paths():
            T = nifti.read_header(lr_path)["shape"][-1]
            self.data.extend((lr_path, hr_path, t) for t in range(T))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index, rng=None):
        lr_path, hr_path, t = self.data[index]
        start, end = self._bounds(t)
        lr = _window(start, end, _VOLUMES.get(lr_path))
        hr = _window(start, end, _VOLUMES.get(hr_path))
        imgs = self._apply(_frames(lr) + _frames(hr), rng)
        half = len(imgs) // 2
        n = self.num_frames
        ref = n // 2 if n % 2 == 1 else n // 2 - 1
        return {"lr_imgs": np.stack(imgs[:half]), "hr_img": imgs[half + ref], "index": index}


class VSRDataset(_SRDatasetBase):
    """Video SR (reference ``acdc_vsr_dataset.py``): training items are
    per-(sequence, t) windows of ``num_frames`` around t (``_bounds``, with
    the circular wrap of ``_window``), valid and test items whole
    sequences; ``{"lr_imgs": (T, h, w, C), "hr_imgs": (T, H, W, C),
    "index"}``."""

    def __init__(self, *args, num_frames=5, temporal_order="last", **kwargs):
        super().__init__(*args, **kwargs)
        if temporal_order not in ("last", "middle"):
            raise ValueError(f"temporal_order must be 'last' or 'middle'; got {temporal_order}.")
        self.num_frames = num_frames
        self.temporal_order = temporal_order
        pairs = self._paired_paths()
        if self.type == "train":
            self.data = []
            for lr_path, hr_path in pairs:
                T = nifti.read_header(lr_path)["shape"][-1]
                self.data.extend((lr_path, hr_path, t) for t in range(T))
        else:
            self.data = pairs

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index, rng=None):
        if self.type == "train":
            lr_path, hr_path, t = self.data[index]
            start, end = self._bounds(t)
            lr = _window(start, end, _VOLUMES.get(lr_path))
            hr = _window(start, end, _VOLUMES.get(hr_path))
        else:
            lr_path, hr_path = self.data[index]
            lr, hr = _VOLUMES.get(lr_path), _VOLUMES.get(hr_path)
        imgs = self._apply(_frames(lr) + _frames(hr), rng)
        half = len(imgs) // 2
        return {"lr_imgs": np.stack(imgs[:half]), "hr_imgs": np.stack(imgs[half:]),
                "index": index}


class VSRRefineNetDataset(_SRDatasetBase):
    """RefineNet VSR: phase codes + ×3 circular tiling + warm-up margins.

    Train: LR window ``[t-num_frames+1-U, t+1+U)`` on the tiled sequence, HR
    window ``[t-num_frames+1, t+1)``; pos_code follows LR.  Valid/test: LR =
    one full cycle + U margin each side, HR = one full cycle.
    """

    def __init__(self, *args, pos_code_path, num_frames=5, num_updated_frames=0, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_frames = num_frames
        self.num_updated_frames = num_updated_frames
        self.pos_code_path = pos_code_path
        pairs = self._paired_paths()
        if self.type == "train":
            self.data = []
            for lr_path, hr_path in pairs:
                T = nifti.read_header(lr_path)["shape"][-1]
                self.data.extend((lr_path, hr_path, t) for t in range(T))
        else:
            self.data = pairs

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index, rng=None):
        if self.type == "train":
            lr_path, hr_path, t = self.data[index]
        else:
            lr_path, hr_path = self.data[index]
            t = None
        lr_vol, hr_vol = _VOLUMES.get(lr_path), _VOLUMES.get(hr_path)

        imgs = self._apply(_frames(lr_vol) + _frames(hr_vol), rng)
        half = len(imgs) // 2
        lr_imgs, hr_imgs = imgs[:half], imgs[half:]

        # Phase code: per-patient (T,) array, exempt from normalization.
        pos_codes = _load_pickle(self.pos_code_path)
        patient = lr_path.parts[-1].split(".")[0].split("_")[0]
        pos_code = np.asarray(pos_codes[patient], np.float32)

        # ×3 circular tiling of the cardiac cycle.
        lr_imgs, hr_imgs = lr_imgs * 3, hr_imgs * 3
        pos_code = np.tile(pos_code, 3)[:, None]  # (3T, 1)
        T = len(lr_imgs) // 3
        U = self.num_updated_frames

        if self.type == "train":
            tt = t + T
            start, end = tt - self.num_frames + 1, tt + 1
            lr_sel = lr_imgs[start - U : end + U]
            hr_sel = hr_imgs[start:end]
            pos_sel = pos_code[start - U : end + U]
        else:
            lr_sel = lr_imgs[T - U : 2 * T + U]
            hr_sel = hr_imgs[:T]
            pos_sel = pos_code[T - U : 2 * T + U]

        return {
            "lr_imgs": np.stack(lr_sel),
            "hr_imgs": np.stack(hr_sel),
            "pos_code": pos_sel.astype(np.float32),
            "index": index,
        }


for _workload, _cls in (("SISRDataset", SISRDataset), ("MISRDataset", MISRDataset),
                       ("VSRDataset", VSRDataset), ("VSRRefineNetDataset", VSRRefineNetDataset)):
    DATASETS.add(f"Acdc{_workload}", _cls)
    DATASETS.add(f"Dsb15{_workload}", _cls)
