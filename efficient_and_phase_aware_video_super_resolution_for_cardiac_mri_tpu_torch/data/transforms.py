"""Host-side data transforms of the test path (numpy, channel-last).

The port's copy of ``Compose`` / ``ToTensor`` / ``Normalize`` from the JAX
package.  ``ToTensor`` keeps the reference name but yields float32 numpy
arrays: the loader collates numpy batches and the predictor moves each batch
to the device once.
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
