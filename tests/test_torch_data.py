"""The PyTorch port's data path against the JAX package's, on one tree.

``VSRRefineNetDataset`` items and ``Dataloader`` batches must be exactly
equal (same numpy arithmetic on the same files), and the port's own copies
of the numpy-only helpers (NIfTI I/O, stats, per-item RNG) must give the
same values as the JAX package's.
"""
import numpy as np
import pytest

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.data import (
    Dataloader as JaxDataloader,
    VSRRefineNetDataset as JaxDataset,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils import (
    get_stats as jax_get_stats,
    item_rng as jax_item_rng,
    nifti as jax_nifti,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import (
    DATASETS,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import (
    Dataloader,
    VSRRefineNetDataset,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils import (
    get_stats,
    item_rng,
    nifti,
)
from fixtures import make_acdc_tree

TRANSFORMS = [
    {"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
    {"name": "ToTensor"},
]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_acdc_tree(tmp_path_factory.mktemp("acdc"), patients_per_split=2, slices=2,
                          frames=6, hr_size=(24, 24))


def _kwargs(tree, split):
    return dict(
        data_dir=tree["videos_dir"], type=split, downscale_factor=4, transforms=TRANSFORMS,
        num_frames=3, num_updated_frames=2, pos_code_path=str(tree["pos_code_path"]),
    )


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        va, vb = np.asarray(a[key]), np.asarray(b[key])
        assert va.dtype == vb.dtype and va.shape == vb.shape, key
        np.testing.assert_array_equal(va, vb, err_msg=key)


@pytest.mark.parametrize("split", ["train", "test"])
def test_items_equal_jax(tree, split):
    port, ref = VSRRefineNetDataset(**_kwargs(tree, split)), JaxDataset(**_kwargs(tree, split))
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        _assert_same(port[i], ref[i])
    if split == "test":
        item = port[0]
        assert item["lr_imgs"].shape == (6 + 2 * 2, 6, 6, 1)
        assert item["hr_imgs"].shape == (6, 24, 24, 1)


@pytest.mark.parametrize("shuffle,num_workers", [(False, 0), (True, 3)])
def test_batches_equal_jax(tree, shuffle, num_workers):
    port = Dataloader(VSRRefineNetDataset(**_kwargs(tree, "train")), batch_size=4,
                      shuffle=shuffle, num_workers=num_workers)
    ref = JaxDataloader(JaxDataset(**_kwargs(tree, "train")), batch_size=4,
                        shuffle=shuffle, num_workers=num_workers)
    port.set_epoch(7)
    ref.set_epoch(7)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == len(ref)
    for a, b in zip(got, want):
        _assert_same(a, b)


def test_registered_under_both_dataset_names():
    assert DATASETS.get("AcdcVSRRefineNetDataset") is VSRRefineNetDataset
    assert DATASETS.get("Dsb15VSRRefineNetDataset") is VSRRefineNetDataset


def test_numpy_helpers_equal_jax(tree, tmp_path):
    path = sorted((tree["videos_dir"] / "test" / "HR").rglob("*.nii.gz"))[0]
    np.testing.assert_array_equal(nifti.load(path).get_data(), jax_nifti.load(path).get_data())
    vol = np.arange(24, dtype=np.float32).reshape(2, 3, 1, 4)
    nifti.save(vol, tmp_path / "port.nii.gz")
    jax_nifti.save(vol, tmp_path / "jax.nii.gz")
    assert (tmp_path / "port.nii.gz").read_bytes() == (tmp_path / "jax.nii.gz").read_bytes()
    for name in ("acdc", "dsb15"):
        assert get_stats(name) == jax_get_stats(name)
    np.testing.assert_array_equal(item_rng(3, 9).random(5), jax_item_rng(3, 9).random(5))
