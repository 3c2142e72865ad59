"""Datasets of the RefineNet path (ACDC / DSB15 cardiac cine-MRI).

The port's copy of the JAX package's ``VSRRefineNetDataset``: items are dicts
of channel-last numpy arrays with time as the leading axis, (T, H, W, C),
exactly as the JAX package yields them.  Train items run the config's
augments with the ``rng`` the loader hands each item (``item_rng``), then its
transforms; valid and test items run the transforms only.  One
implementation is registered under both the Acdc and the Dsb15 name.
"""
from __future__ import annotations

import pickle
import threading
from collections import OrderedDict
from pathlib import Path

import numpy as np

from ..config import DATASETS
from ..utils import nifti
from .transforms import Normalize, compose


class _VolumeCache:
    """Process-wide LRU of decoded NIfTI volumes, shared by the loader
    threads (a window or an epoch re-reads the same sequence file)."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._cache = OrderedDict()
        # OrderedDict reordering/eviction is not atomic; decode runs outside
        self._lock = threading.Lock()

    def get(self, path: Path) -> np.ndarray:
        key = str(path)
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
        data = np.asarray(nifti.load(path).get_data())
        with self._lock:
            self._cache[key] = data
            if len(self._cache) > self.capacity:
                self._cache.popitem(last=False)
        return data


_VOLUMES = _VolumeCache()
_PICKLES: dict[str, dict] = {}
_PICKLES_LOCK = threading.Lock()


def _load_pickle(path) -> dict:
    key = str(path)
    with _PICKLES_LOCK:
        if key not in _PICKLES:
            with open(key, "rb") as f:
                _PICKLES[key] = pickle.load(f)
        return _PICKLES[key]


def _frames(vol: np.ndarray) -> list[np.ndarray]:
    """(H, W, C, T) volume → list of T (H, W, C) frames."""
    return [vol[..., t] for t in range(vol.shape[-1])]


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


DATASETS.add("AcdcVSRRefineNetDataset", VSRRefineNetDataset)
DATASETS.add("Dsb15VSRRefineNetDataset", VSRRefineNetDataset)
