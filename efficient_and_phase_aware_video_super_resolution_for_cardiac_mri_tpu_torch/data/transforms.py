"""Host-side data transforms (numpy, channel-last).

The port's copy of ``Compose`` / ``ToTensor`` / ``Normalize`` and of the
train augments ``RandomCrop`` / ``RandomHorizontalFlip`` /
``RandomVerticalFlip`` / ``RandomCropPatch`` from the JAX package.
``ToTensor`` keeps the reference name but yields float32 numpy arrays: the
loader collates numpy batches and the engines move each batch to the device
once.  Randomness comes only from the ``rng`` Generator passed per call (the
loader's per-item ``item_rng``), so an augmented batch is a pure function of
(epoch seed, item index), exactly as in the JAX package.
"""
from __future__ import annotations

import numpy as np

from ..config import TRANSFORMS


def compose(transforms=None) -> "Compose":
    """Build a :class:`Compose` from a config list."""
    if transforms is None:
        return Compose([ToTensor()])
    built = []
    for t in transforms:
        cls = TRANSFORMS.get(t["name"])
        kwargs = t.get("kwargs")
        built.append(cls(**kwargs) if kwargs else cls())
    return Compose(built)


def _check_arrays(imgs):
    if not all(isinstance(img, np.ndarray) for img in imgs):
        raise TypeError("every image entering this transform must be a numpy.ndarray")


def _check_ndim(imgs):
    _check_arrays(imgs)
    if not all(img.ndim == 3 for img in imgs) and not all(img.ndim == 4 for img in imgs):
        raise ValueError("every image must be rank 3 (2D: H, W, C) or rank 4 (3D: H, W, D, C)")


def _rng(kwargs) -> np.random.Generator:
    rng = kwargs.get("rng")
    return rng if rng is not None else np.random.default_rng()


def _crop_coords(rng, shape, size):
    if any(i - j < 0 for i, j in zip(shape, size)):
        raise ValueError(
            f"The image ({shape}) is smaller than the cropped size ({size}). "
            "Please use a smaller cropped size."
        )
    starts = [int(rng.integers(0, s - t + 1)) for s, t in zip(shape, size)]
    return [(s, s + t) for s, t in zip(starts, size)]


def _check_crop_rank(imgs, size):
    ndim = imgs[0].ndim
    if ndim - 1 != len(size):
        raise ValueError(
            f"The dimensions of the cropped size should be the same as the image "
            f"({ndim - 1}). Got {len(size)}"
        )


class BaseTransform:
    def __call__(self, *imgs, **kwargs):
        raise NotImplementedError

    def __repr__(self):
        return self.__class__.__name__


@TRANSFORMS.register()
class Compose(BaseTransform):
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, *imgs, **kwargs):
        for transform in self.transforms:
            imgs = transform(*imgs, **kwargs)
        if len(imgs) == 1:
            imgs = imgs[0]
        return imgs

    def __repr__(self):
        inner = "\n".join(f"    {t!r}" for t in self.transforms)
        return f"{self.__class__.__name__}(\n{inner}\n)"


@TRANSFORMS.register()
class ToTensor(BaseTransform):
    """Convert to float32 numpy (the device transfer happens per batch)."""

    def __call__(self, *imgs, dtypes=None, **kwargs):
        _check_arrays(imgs)
        if dtypes:
            if len(dtypes) != len(imgs):
                raise ValueError("The number of the dtypes should be the same as the images.")
            return tuple(np.asarray(img, dtype=d) for img, d in zip(imgs, dtypes))
        return tuple(np.asarray(img, dtype=np.float32) for img in imgs)


@TRANSFORMS.register()
class Normalize(BaseTransform):
    """Per-channel (x - mean) / (std + 1e-10); image-level stats when means/stds
    are omitted; ``normalize_tags`` exempts images."""

    def __init__(self, means=None, stds=None):
        if (means is None) != (stds is None):
            raise ValueError("Both the means and the standard deviations should have values or None.")
        if means is not None and len(means) != len(stds):
            raise ValueError("The number of the means should be the same as the standard deviations.")
        self.means = means
        self.stds = stds

    def __call__(self, *imgs, normalize_tags=None, **kwargs):
        _check_arrays(imgs)
        if normalize_tags:
            if len(normalize_tags) != len(imgs):
                raise ValueError("The number of the tags should be the same as the images.")
            if not all(tag in (True, False) for tag in normalize_tags):
                raise ValueError("normalize_tags must be booleans (True to normalize, False to pass through).")
        else:
            normalize_tags = [None] * len(imgs)

        out = []
        for img, tag in zip(imgs, normalize_tags):
            if tag is False:
                out.append(img)
                continue
            if self.means is None:
                axis = tuple(range(img.ndim - 1))
                means, stds = img.mean(axis=axis), img.std(axis=axis)
            else:
                means, stds = self.means, self.stds
            img = np.asarray(img, np.float32).copy()
            for c, mean, std in zip(range(img.shape[-1]), means, stds):
                img[..., c] = (img[..., c] - mean) / (std + 1e-10)
            out.append(img)
        return tuple(out)


@TRANSFORMS.register()
class RandomCrop(BaseTransform):
    """The same random crop of every image (reference ``transforms.py:171-227``)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, *imgs, **kwargs):
        _check_ndim(imgs)
        _check_crop_rank(imgs, self.size)
        coords = _crop_coords(_rng(kwargs), imgs[0].shape[:-1], self.size)
        slices = tuple(slice(a, b) for a, b in coords)
        return tuple(img[slices] for img in imgs)


@TRANSFORMS.register()
class RandomHorizontalFlip(BaseTransform):
    """``np.flip`` over axis 1 with probability ``prob``
    (reference ``transforms.py:321-345``)."""

    def __init__(self, prob=0.5):
        self.prob = max(0.0, min(prob, 1.0))

    def __call__(self, *imgs, **kwargs):
        _check_ndim(imgs)
        if _rng(kwargs).random() < self.prob:
            imgs = tuple(np.flip(img, 1) for img in imgs)
        return imgs


@TRANSFORMS.register()
class RandomVerticalFlip(BaseTransform):
    """``np.flip`` over axis 0 with probability ``prob``
    (reference ``transforms.py:348-372``)."""

    def __init__(self, prob=0.5):
        self.prob = max(0.0, min(prob, 1.0))

    def __call__(self, *imgs, **kwargs):
        _check_ndim(imgs)
        if _rng(kwargs).random() < self.prob:
            imgs = tuple(np.flip(img, 0) for img in imgs)
        return imgs


@TRANSFORMS.register()
class RandomCropPatch(BaseTransform):
    """SR-paired crop: the first half of the tuple is LR, the second HR; the
    HR crop is the LR crop scaled by ``ratio`` (reference
    ``transforms.py:375-450``).  In 3D the depth axis is not scaled."""

    def __init__(self, size, ratio):
        self.size = size
        self.ratio = ratio

    def __call__(self, *imgs, **kwargs):
        _check_ndim(imgs)
        _check_crop_rank(imgs, self.size)
        if len(imgs) % 2 == 1:
            raise ValueError("The number of the LR images should be the same as the HR images")
        lr_imgs, hr_imgs = imgs[: len(imgs) // 2], imgs[len(imgs) // 2 :]
        if not all(
            j // i == self.ratio
            for lr, hr in zip(lr_imgs, hr_imgs)
            for i, j in zip(lr.shape[:-1], hr.shape[:-1])
        ):
            raise ValueError(
                f"The ratio between the HR images and the LR images should be {self.ratio}."
            )
        coords = _crop_coords(_rng(kwargs), lr_imgs[0].shape[:-1], self.size)
        r = self.ratio
        lr_slices = tuple(slice(a, b) for a, b in coords)
        # H and W scale by the ratio; a third (depth) axis does not
        hr_slices = tuple(slice(a * r, b * r) if axis < 2 else slice(a, b)
                          for axis, (a, b) in enumerate(coords))
        return tuple([img[lr_slices] for img in lr_imgs] + [img[hr_slices] for img in hr_imgs])
