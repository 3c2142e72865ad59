"""The PyTorch port's data path against the JAX package's, on one tree.

``VSRRefineNetDataset`` items and ``Dataloader`` batches must be exactly
equal (same numpy arithmetic on the same files), the train split with
``exp1_x4.yaml``'s augments too (flips and ``RandomCropPatch`` at ratio 4,
drawn from each item's ``item_rng``), and the port's own copies of the
numpy-only helpers (NIfTI I/O, stats, per-item RNG) must give the same
values as the JAX package's.  The port's process-wide volume and pickle
caches serve the file a relative path names in the current working
directory, and a file rewritten in place anew.
"""
import os

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
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import (
    TRANSFORMS as TRANSFORM_REGISTRY,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import (
    Dataloader,
    VSRRefineNetDataset,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import (
    datasets as port_datasets,
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


# -------------------------------------------------- the path-keyed caches
# Two trees of different frame sizes and counts under two roots with the same
# ./data/... layout, as the YAML tests lay theirs out: a process that reads
# one and then changes into the other must be served the other.
REL_VIDEOS = "./data/acdc_preprocessed/videos"
REL_POS_CODE = "./data/acdc_preprocessed/position_code.pkl"
REL_COORDS = "./data/acdc_cropped/coordinates.pkl"


def _same_layout_roots(tmp_path):
    roots = []
    for name, hr_size, frames in (("a", (24, 24), 6), ("b", (16, 16), 8)):
        root = tmp_path / name
        tree = make_acdc_tree(root / "fixture", patients_per_split=1, slices=1, frames=frames,
                              hr_size=hr_size, splits=("test",))
        (root / "data" / "acdc_preprocessed").mkdir(parents=True)
        (root / "data" / "acdc_preprocessed" / "videos").symlink_to(tree["videos_dir"])
        (root / "data" / "acdc_preprocessed" / "position_code.pkl").symlink_to(
            tree["pos_code_path"])
        (root / "data" / "acdc_cropped").mkdir(parents=True)
        (root / "data" / "acdc_cropped" / "coordinates.pkl").symlink_to(tree["coordinates_path"])
        roots.append(root)
    return roots


def _relative_item() -> dict:
    ds = VSRRefineNetDataset(data_dir=REL_VIDEOS, type="test", downscale_factor=4,
                             transforms=TRANSFORMS, num_frames=3, num_updated_frames=2,
                             pos_code_path=REL_POS_CODE)
    return ds[0]


def _as_a_fresh_process(monkeypatch, fn):
    """``fn()`` with the port's caches empty, as a fresh process reads."""
    with monkeypatch.context() as m:
        m.setattr(port_datasets, "_VOLUMES", port_datasets._VolumeCache())
        m.setattr(port_datasets, "_PICKLES", {})
        return fn()


def test_caches_follow_the_working_directory(tmp_path, monkeypatch):
    root_a, root_b = _same_layout_roots(tmp_path)
    monkeypatch.chdir(root_a)
    first = _relative_item()
    coords_a = port_datasets._load_pickle(REL_COORDS)
    monkeypatch.chdir(root_b)
    second = _relative_item()
    coords_b = port_datasets._load_pickle(REL_COORDS)
    assert first["hr_imgs"].shape == (6, 24, 24, 1)
    assert second["hr_imgs"].shape == (8, 16, 16, 1)
    _assert_same(second, _as_a_fresh_process(monkeypatch, _relative_item))
    assert coords_b == _as_a_fresh_process(
        monkeypatch, lambda: port_datasets._load_pickle(REL_COORDS))
    assert coords_b != coords_a


def test_a_volume_rewritten_in_place_is_read_anew(tmp_path, monkeypatch):
    root, _ = _same_layout_roots(tmp_path)
    monkeypatch.chdir(root)
    before = _relative_item()
    for path in sorted((root / "fixture" / "videos" / "test").rglob("*.nii.gz")):
        st = os.stat(path)
        nifti.save(255 - nifti.load(path).get_data(), path)
        # a later mtime whatever the file system's timestamp resolution
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    after = _relative_item()
    _assert_same(after, _as_a_fresh_process(monkeypatch, _relative_item))
    assert not np.array_equal(after["hr_imgs"], before["hr_imgs"])


# ------------------------------------------------ RandomElasticDeformation
def _elastic_inputs(kind, rng):
    if kind == "2d":  # an (H, W, C) tuple of two images
        return [rng.random((20, 24, 2)).astype(np.float32) for _ in range(2)]
    if kind == "3d":  # an (H, W, D, C) tuple
        return [rng.random((12, 14, 5, 1)).astype(np.float32) for _ in range(2)]
    # an LR/HR pair at ×3: one deformation, scaled to each image's grid
    return [rng.random((10, 12, 1)).astype(np.float32), rng.random((30, 36, 1)).astype(np.float32)]


@pytest.mark.parametrize("kind", ["2d", "3d", "lr_hr"])
@pytest.mark.parametrize("kwargs", [{"prob": 1.0}, {"prob": 1.0, "do_z_deformation": True,
                                                    "num_ctrl_points": 3, "sigma": 2}],
                         ids=["default", "z"])
def test_random_elastic_deformation_equals_jax(kind, kwargs):
    """The same ``rng`` gives the same deformed tuple as the JAX package's
    (both numpy and scipy: equal element for element), orders 3 and 0."""
    imgs = _elastic_inputs(kind, np.random.default_rng(7))
    port = transforms.RandomElasticDeformation(**kwargs)
    jax = jax_transforms.RandomElasticDeformation(**kwargs)
    for orders in (None, [0, 3]):
        got = port(*imgs, rng=np.random.default_rng(3), elastic_deformation_orders=orders)
        want = jax(*imgs, rng=np.random.default_rng(3), elastic_deformation_orders=orders)
        assert len(got) == len(want) == 2
        for g, w, img in zip(got, want, imgs):
            np.testing.assert_array_equal(g, w)
            assert g.shape == img.shape and g.dtype == img.dtype
        assert not np.array_equal(got[0], imgs[0])  # prob 1: deformed


def test_random_elastic_deformation_prob_and_refusals():
    imgs = _elastic_inputs("2d", np.random.default_rng(0))
    never = transforms.RandomElasticDeformation(prob=0.0)
    assert never(*imgs, rng=np.random.default_rng(0)) == tuple(imgs)
    t = transforms.RandomElasticDeformation(prob=1.0)
    with pytest.raises(ValueError, match="order"):
        t(*imgs, rng=np.random.default_rng(0), elastic_deformation_orders=[2, 3])
    with pytest.raises(ValueError, match="rank"):
        t(imgs[0][..., 0], rng=np.random.default_rng(0))
    assert TRANSFORM_REGISTRY.get("RandomElasticDeformation") is transforms.RandomElasticDeformation
