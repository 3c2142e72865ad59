"""The PyTorch port's data path against the JAX package's, on one tree.

``VSRRefineNetDataset`` items and ``Dataloader`` batches must be exactly
equal (same numpy arithmetic on the same files), the train split with
``exp1_x4.yaml``'s augments too (flips and ``RandomCropPatch`` at ratio 4,
drawn from each item's ``item_rng``), and the port's own copies of the
numpy-only helpers (NIfTI I/O, stats, per-item RNG) must give the same
values as the JAX package's.
"""
import numpy as np
import pytest

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.data import (
    Dataloader as JaxDataloader,
    VSRRefineNetDataset as JaxDataset,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.data import (
    transforms as jax_transforms,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils import (
    get_stats as jax_get_stats,
    item_rng as jax_item_rng,
    nifti as jax_nifti,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.seeding import (
    seed_everything as jax_seed_everything,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import (
    DATASETS,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import (
    Dataloader,
    VSRRefineNetDataset,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import (
    transforms,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils import (
    get_stats,
    item_rng,
    nifti,
    seed_everything,
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


AUGMENTS = [  # configs/train/refine_net/exp1_x4.yaml, with a crop that fits the tree
    {"name": "RandomHorizontalFlip"},
    {"name": "RandomVerticalFlip"},
    {"name": "RandomCropPatch", "kwargs": {"size": [4, 4], "ratio": 4}},
]


def _kwargs(tree, split, augments=None):
    return dict(
        data_dir=tree["videos_dir"], type=split, downscale_factor=4, transforms=TRANSFORMS,
        augments=augments, num_frames=3, num_updated_frames=2,
        pos_code_path=str(tree["pos_code_path"]),
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


def test_augmented_train_batches_equal_jax_over_two_epochs(tree):
    """Shuffle on, the epoch seeds of ``seed_everything('vsr', 2)``: every
    batch of both epochs is the JAX loader's, flips and crops included."""
    port = Dataloader(VSRRefineNetDataset(**_kwargs(tree, "train", AUGMENTS)), batch_size=4,
                      shuffle=True, num_workers=2)
    ref = JaxDataloader(JaxDataset(**_kwargs(tree, "train", AUGMENTS)), batch_size=4,
                        shuffle=True, num_workers=2)
    seeds = seed_everything("vsr", 2).np_random_seeds
    assert seeds == jax_seed_everything("vsr", 2).np_random_seeds
    epochs = []
    for seed in seeds:
        port.set_epoch(seed)
        ref.set_epoch(seed)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            _assert_same(a, b)
            assert a["lr_imgs"].shape == (4, 3 + 2 * 2, 4, 4, 1)
            assert a["hr_imgs"].shape == (4, 3, 16, 16, 1)
        epochs.append(np.concatenate([b["lr_imgs"] for b in got]))
    assert not np.array_equal(epochs[0], epochs[1])  # the epochs draw differently


@pytest.mark.parametrize("name,kwargs", [
    ("RandomHorizontalFlip", {"prob": 0.5}),
    ("RandomVerticalFlip", {"prob": 0.5}),
    ("RandomCrop", {"size": [3, 4]}),
    ("RandomCropPatch", {"size": [3, 4], "ratio": 2}),
])
def test_augments_equal_jax_on_2d_and_3d(name, kwargs):
    rng = np.random.default_rng(0)
    for spatial in ((6, 8), (6, 8, 5)):
        lr = rng.standard_normal((*spatial, 1)).astype(np.float32)
        hr_spatial = tuple(2 * n for n in spatial)  # the ratio check covers every axis
        hr = rng.standard_normal((*hr_spatial, 1)).astype(np.float32)
        if name == "RandomCrop" and len(spatial) == 3:
            kwargs = {"size": [3, 4, 2]}
        if name == "RandomCropPatch" and len(spatial) == 3:
            kwargs = {"size": [3, 4, 2], "ratio": 2}
        imgs = (lr, hr) if name == "RandomCropPatch" else (lr, lr + 1)
        for seed in range(4):
            got = getattr(transforms, name)(**kwargs)(*imgs, rng=np.random.default_rng(seed))
            want = getattr(jax_transforms, name)(**kwargs)(*imgs, rng=np.random.default_rng(seed))
            assert len(got) == len(want) == 2
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
