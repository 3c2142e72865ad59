"""The port's phase-code tools against OpenCV and the JAX package.

The JAX package's ``tools/cardiac_cropping.py`` and
``tools/gen_positional_encoding.py`` call OpenCV; the port's are numpy
(``tools/imgproc.py``), since the machine with the card has none.  Here,
where ``cv2`` exists, it is the oracle:

* the numpy blur (float32 and uint8), Otsu threshold and morphology equal
  ``cv2`` element for element on seeded images;
* ``find_bbox`` and ``phase_code`` equal the JAX tools' on the phantom of
  ``tools/gen_synthetic_data`` (size 96) and on ``make_acdc_tree`` trees;
* both CLIs write ``coordinates.pkl`` and ``position_code.pkl`` equal to
  the JAX CLIs'.
"""
import pickle

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.tools import (  # noqa: E402
    cardiac_cropping as jax_crop,
    gen_positional_encoding as jax_code,
    gen_synthetic_data,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils import (  # noqa: E402
    nifti,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import (  # noqa: E402
    cardiac_cropping as port_crop,
    gen_positional_encoding as port_code,
    imgproc,
)
from fixtures import make_acdc_tree  # noqa: E402
from gray_frames import gif_frames  # noqa: E402

# (H, W): odd and even widths (the float blur's last column), single rows
# and columns (OpenCV then runs one pass), and the phantom's size
SHAPES = [(1, 1), (1, 6), (7, 1), (2, 2), (3, 5), (12, 9), (17, 24), (48, 33), (96, 96),
          (61, 130)]


def _images(dtype, seed):
    rng = np.random.default_rng(seed)
    for h, w in SHAPES:
        if dtype == np.uint8:
            yield rng.integers(0, 256, (h, w)).astype(np.uint8)
            # a motion-diff-like image: mostly small values
            yield np.clip(rng.exponential(6.0, (h, w)), 0, 255).astype(np.uint8)
        else:
            yield (rng.standard_normal((h, w)) * 60 + 100).astype(np.float32)
            yield rng.uniform(0, 255, (h, w)).round().astype(np.float32)  # integer-valued
            yield (rng.standard_normal((h, w)) * 1e-3).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["float32", "uint8"])
def test_blur_equals_cv2(dtype):
    for img in _images(dtype, seed=0):
        want = cv2.GaussianBlur(img, (5, 5), 0)
        got = imgproc.gaussian_blur_5x5(img)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=str(img.shape))


def test_blur_of_a_strided_view_equals_cv2():
    """``find_bbox`` blurs ``data[..., t]`` of a Fortran-ordered volume."""
    vol = np.asfortranarray(np.random.default_rng(1).uniform(0, 255, (20, 15, 1, 4)),
                            dtype=np.float32)
    img = vol[..., 2].squeeze()
    np.testing.assert_array_equal(imgproc.gaussian_blur_5x5(img), cv2.GaussianBlur(img, (5, 5), 0))


def test_otsu_equals_cv2():
    rng = np.random.default_rng(2)
    images = list(_images(np.uint8, seed=3)) + [
        np.zeros((9, 9), np.uint8),  # one value: no split
        np.array([[0, 255], [255, 0]], np.uint8),
        rng.choice([3, 7, 200], size=(31, 17)).astype(np.uint8),  # few values: ties
        np.clip(rng.normal(128, 1, (40, 40)), 0, 255).astype(np.uint8),
    ]
    for img in images:
        t_want, mask_want = cv2.threshold(img, 0, 1, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        t_got, mask_got = imgproc.threshold_otsu(img)
        assert t_got == t_want, img.shape
        np.testing.assert_array_equal(mask_got, mask_want)


@pytest.mark.parametrize("op", ["erode", "dilate", "close", "open"])
def test_morphology_equals_cv2(op):
    rng = np.random.default_rng(4)
    kernel = cv2.getStructuringElement(cv2.MORPH_RECT, (5, 5))
    ours = {"erode": imgproc.erode, "dilate": imgproc.dilate, "close": imgproc.morph_close,
            "open": imgproc.morph_open}[op]
    for h, w in SHAPES:
        for density in (0.1, 0.5, 0.9):
            mask = (rng.uniform(size=(h, w)) < density).astype(np.uint8)
            if op == "erode":
                want = cv2.erode(mask, kernel)
            elif op == "dilate":
                want = cv2.dilate(mask, kernel)
            else:
                want = cv2.morphologyEx(
                    mask, {"close": cv2.MORPH_CLOSE, "open": cv2.MORPH_OPEN}[op], kernel)
            np.testing.assert_array_equal(ours(mask), want, err_msg=f"{(h, w)} {density}")


@pytest.fixture(scope="module")
def phantom(tmp_path_factory):
    """The JAX package's synthetic phantom through its real offline
    pipeline (its CLIs write the oracle pickles)."""
    root = tmp_path_factory.mktemp("phantom")
    return gen_synthetic_data.main(root, patients_train=1, patients_test=1, size=96, slices=2,
                                   frames=12, factors=(4,), seed=0)


@pytest.fixture(scope="module")
def acdc_tree(tmp_path_factory):
    return make_acdc_tree(tmp_path_factory.mktemp("acdc_codes"), patients_per_split=1,
                          slices=2, frames=10, hr_size=(48, 40), factors=(4,))


def _sequences(videos_dir):
    for path in sorted(videos_dir.rglob("*2d+1d*.nii.gz")):
        yield path, np.asarray(nifti.load(path).get_data(), np.float32)


@pytest.mark.parametrize("tree", ["phantom", "acdc_tree"])
def test_find_bbox_and_phase_code_equal_jax(tree, request):
    videos = request.getfixturevalue(tree)[
        "videos_dir"]
    n = 0
    for path, data in _sequences(videos):
        bbox = port_crop.find_bbox(data)
        assert bbox == jax_crop.find_bbox(data), path
        if bbox[1] - bbox[0] < 2 or bbox[3] - bbox[2] < 2:
            bbox = (0, data.shape[0], 0, data.shape[1])
        np.testing.assert_array_equal(port_code.phase_code(data, bbox),
                                      jax_code.phase_code(data, bbox), err_msg=str(path))
        n += 1
    assert n >= 4


def test_clis_write_the_jax_pickles(phantom, tmp_path):
    videos = phantom["videos_dir"]
    port_crop.main(videos, tmp_path / "cropped")
    port_code.main(videos, tmp_path / "cropped" / "coordinates.pkl", tmp_path / "pre")
    with open(phantom["coordinates_path"], "rb") as f:
        want_coords = pickle.load(f)
    with open(tmp_path / "cropped" / "coordinates.pkl", "rb") as f:
        assert pickle.load(f) == want_coords
    assert len(want_coords) == 2
    got = (tmp_path / "pre" / "position_code.pkl").read_bytes()
    assert got == phantom["pos_code_path"].read_bytes()
    # the cropped GIFs too, frame for frame
    jax_gifs = sorted(p.relative_to(phantom["coordinates_path"].parent)
                      for p in phantom["coordinates_path"].parent.rglob("*.gif"))
    assert jax_gifs
    for rel in jax_gifs:
        a = gif_frames(phantom["coordinates_path"].parent / rel)
        b = gif_frames(tmp_path / "cropped" / rel)
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)), rel
