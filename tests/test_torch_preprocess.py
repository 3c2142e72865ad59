"""The port's offline data pipeline against the JAX package's, on the CPU.

* ``ops/resize.resize_bicubic_np`` and ``ops/kspace`` (``Downscale`` at ×2,
  ×3 and ×4 and its three steps) equal JAX's element for element: both are
  the same numpy arithmetic on the same matrices, so no tolerance is
  stated.
* ``tools/acdc_preprocess`` and ``tools/dsb15_preprocess`` write trees
  byte-equal to the JAX tools', file for file, from the same raw phantoms
  (48 px, 5 frames; DSB15 series of 30 frames with a malformed series
  between two good ones, which keeps its number).
* ``tools/gen_synthetic_data`` (raw tree, ``acdc_preprocess``,
  ``cardiac_cropping``, ``gen_positional_encoding``) writes every file
  byte-equal to the JAX tool's for the same arguments, except the cropped
  GIFs, whose encoders differ: they decode to the same frames.
* ``tools/dsb15_dicom2nifty`` runs the same ``dcm2niix`` command lines as
  the JAX tool's into the same tree (a fake ``dcm2niix`` on ``PATH``, as in
  ``tests/test_dicom2nifty.py``), and names the program when it is missing.

About 6 s in one process (pytest's count, the JAX tools' imports
excluded).
"""
import filecmp
import os
import pickle
import stat
import sys
from pathlib import Path

import numpy as np
import pytest

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.ops import kspace as jax_kspace
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.ops import resize as jax_resize
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.tools import (
    acdc_preprocess as jax_acdc,
    dsb15_dicom2nifty as jax_dicom,
    dsb15_preprocess as jax_dsb15,
    gen_synthetic_data as jax_gen,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import kspace, resize
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import (
    acdc_preprocess,
    dsb15_dicom2nifty,
    dsb15_preprocess,
    gen_synthetic_data,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils import nifti

sys.path.insert(0, str(Path(__file__).parent))
from gray_frames import gif_frames  # noqa: E402
from test_dicom2nifty import _make_dsb15_dicom_tree  # noqa: E402


def _files(root: Path) -> list:
    return sorted(p.relative_to(root) for p in Path(root).rglob("*") if p.is_file())


def _assert_trees_equal(a: Path, b: Path, gifs_by_frame: bool = False) -> int:
    """Every file of ``a`` is in ``b`` and nothing else; equal bytes (GIFs:
    equal decoded frames when ``gifs_by_frame``); returns the file count."""
    files = _files(a)
    assert files and _files(b) == files
    for rel in files:
        if gifs_by_frame and rel.suffix == ".gif":
            fa, fb = gif_frames(a / rel), gif_frames(b / rel)
            assert len(fa) == len(fb) and all(np.array_equal(x, y) for x, y in zip(fa, fb)), rel
        else:
            assert filecmp.cmp(a / rel, b / rel, shallow=False), rel
    return len(files)


# ------------------------------------------------------------ resize, k-space
@pytest.mark.parametrize("factor", [2, 3, 4])
def test_resize_bicubic_np_equals_jax(factor):
    rng = np.random.default_rng(factor)
    for shape in [(48, 36, 1), (37, 53), (24, 24, 2, 3)]:
        x = (rng.random(shape) * 255).astype(np.float32)
        out = (shape[0] // factor, shape[1] // factor)
        for align in (False, True):
            got = resize.resize_bicubic_np(x, out, align)
            np.testing.assert_array_equal(got, jax_resize.resize_bicubic_np(x, out, align))
            assert got.shape == out + shape[2:] and got.dtype == np.float32


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_downscale_equals_jax(factor):
    rng = np.random.default_rng(10 + factor)
    imgs = [np.round(rng.random((48, 36, 1)) * 255).astype(np.float32) for _ in range(3)]
    got, want = kspace.Downscale(factor)(*imgs), jax_kspace.Downscale(factor)(*imgs)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.shape == (48 // factor, 36 // factor, 1) and g.min() >= 0 and g.max() <= 255
    k = kspace.img_to_kspace(imgs[0])
    np.testing.assert_array_equal(k, jax_kspace.img_to_kspace(imgs[0]))
    np.testing.assert_array_equal(kspace.truncate_kspace(k, factor),
                                  jax_kspace.truncate_kspace(k, factor))
    np.testing.assert_array_equal(kspace.kspace_to_img(k), jax_kspace.kspace_to_img(k))
    with pytest.raises(ValueError, match="rank"):
        kspace.Downscale(factor)(imgs[0][..., 0])
    with pytest.raises(TypeError):
        kspace.Downscale(factor)([1.0])


def test_normalize_and_crop_equal_jax():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 1000, (50, 61, 2, 3)).astype(np.int16)
    np.testing.assert_array_equal(acdc_preprocess.normalize_int16(data),
                                  jax_acdc.normalize_int16(data))
    as_float = data.astype(np.float32)
    np.testing.assert_array_equal(acdc_preprocess.normalize_int16(as_float), as_float)
    for h, w in [(50, 61), (48, 48), (37, 13)]:
        assert acdc_preprocess.crop_multiple(h, w) == jax_acdc.crop_multiple(h, w)


# ------------------------------------------------------------ the two trees
def test_acdc_trees_are_byte_equal(tmp_path):
    raw = jax_gen.main(tmp_path / "phantom", patients_train=3, patients_test=1, size=48,
                       slices=2, frames=5, seed=1, raw_only=True)["raw_dir"]
    acdc_preprocess.main(raw, tmp_path / "port")
    jax_acdc.main(raw, tmp_path / "jax")
    n = _assert_trees_equal(tmp_path / "jax", tmp_path / "port")
    # 4 patients x 2 slices: a sequence + 5 frames, HR and 3 LR factors
    assert n == 4 * 2 * (1 + 5) * 4
    assert {p.parts[1] for p in _files(tmp_path / "port")} == {"train", "valid", "test"}


def test_dsb15_trees_are_byte_equal(tmp_path):
    raw = gen_synthetic_data.gen_dsb15_raw_tree(
        tmp_path / "phantom", {"train": 1, "valid": 1, "test": 1}, size=48, slices=2, frames=30,
        seed=2)
    assert {p.parts[0] for p in _files(raw)} == {"train", "valid", "test"}
    # a malformed series between the two good ones: too short, skipped, but
    # it keeps its position, so the second good series is sequence03
    short = np.zeros((48, 48, 1, 29), np.int16)
    nifti.save(short, raw / "train" / "1" / "sax_01b" / "sax_01b.nii.gz")
    dsb15_preprocess.main(raw, tmp_path / "port", factors=(2, 4))
    jax_dsb15.main(raw, tmp_path / "jax", factors=(2, 4))
    n = _assert_trees_equal(tmp_path / "jax", tmp_path / "port")
    assert n == 3 * 2 * (1 + 30) * 3
    names = {p.name for p in _files(tmp_path / "port" / "videos" / "train" / "HR")}
    assert names == {"1_2d+1d_sequence01.nii.gz", "1_2d+1d_sequence03.nii.gz"}


# ------------------------------------------------------------- the phantom
def test_gen_synthetic_data_equals_jax(tmp_path):
    kwargs = dict(patients_train=2, patients_test=1, size=48, slices=1, frames=5,
                  factors=(2, 4), seed=0)
    got = gen_synthetic_data.main(tmp_path / "port", **kwargs)
    want = jax_gen.main(tmp_path / "jax", **kwargs)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].relative_to(tmp_path / "port") == want[key].relative_to(tmp_path / "jax")
    n = _assert_trees_equal(tmp_path / "jax", tmp_path / "port", gifs_by_frame=True)
    assert len([p for p in _files(tmp_path / "port") if p.suffix == ".gif"]) == 3
    assert n == 3 + 3 * (1 + 5) * 3 + 1 + 3 + 1  # raw, preprocessed, pos code, GIFs, coordinates
    with open(got["pos_code_path"], "rb") as f:
        assert sorted(pickle.load(f)) == ["patient001", "patient002", "patient003"]
    with pytest.raises(ValueError, match="multiple of 12"):
        gen_synthetic_data.main(tmp_path / "bad", size=50)


def test_gen_synthetic_data_dsb15_layout(tmp_path):
    """``--layout dsb15``: the phantoms as sax series, preprocessed by
    ``dsb15_preprocess``, with the phase codes and boxes of the port's
    tools; the same phantoms as the ACDC layout's."""
    argv = [str(tmp_path / "d"), "--patients-train", "1", "--patients-test", "1", "--size", "48",
            "--slices", "2", "--frames", "30", "--factors", "4", "--layout", "dsb15"]
    a = gen_synthetic_data._parse_args(argv)
    out = gen_synthetic_data.main(a.out_dir, a.patients_train, a.patients_test, a.size, a.slices,
                                  a.frames, tuple(a.factors), a.seed, a.raw_only, a.layout)
    videos = sorted(p.relative_to(out["videos_dir"]) for p in out["videos_dir"].rglob("*.nii.gz"))
    assert [str(p) for p in videos if p.parts[0] == "test"] == [
        "test/HR/701/701_2d+1d_sequence01.nii.gz", "test/HR/701/701_2d+1d_sequence02.nii.gz",
        "test/LR/X4/701/701_2d+1d_sequence01.nii.gz", "test/LR/X4/701/701_2d+1d_sequence02.nii.gz"]
    with open(out["pos_code_path"], "rb") as f:
        codes = pickle.load(f)
    with open(out["coordinates_path"], "rb") as f:
        coords = pickle.load(f)
    assert sorted(codes) == sorted(coords) == ["1", "701"] and codes["701"].shape == (30,)
    acdc = jax_gen.phantom_volume(np.random.default_rng(0), size=48, slices=2, frames=30)
    series = nifti.load(out["raw_dir"] / "train" / "1" / "sax_02" / "sax_02.nii.gz").get_data()
    np.testing.assert_array_equal(series, acdc[:, :, 1:2])


# ------------------------------------------------------------ dcm2niix CLI
@pytest.fixture
def fake_dcm2niix(tmp_path, monkeypatch):
    """A ``dcm2niix`` on ``PATH`` that records its arguments and writes a
    file into its ``-o`` directory."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    capture = tmp_path / "calls.txt"
    script = bin_dir / "dcm2niix"
    script.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{capture}"\n'
        'out=""; prev=""\n'
        'for a in "$@"; do if [ "$prev" = "-o" ]; then out="$a"; fi; prev="$a"; done\n'
        '[ -n "$out" ] && touch "$out/sax.nii.gz"\n'
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    return capture


def test_dicom2nifty_runs_the_jax_command_lines(tmp_path, fake_dcm2niix):
    data = _make_dsb15_dicom_tree(tmp_path)
    argv = [str(data), str(tmp_path / "port")]
    args = dsb15_dicom2nifty._parse_args(argv)
    dsb15_dicom2nifty.main(args.data_dir, args.output_dir)
    port_calls = fake_dcm2niix.read_text().splitlines()
    fake_dcm2niix.unlink()
    jax_dicom.main(data, tmp_path / "jax")
    jax_calls = fake_dcm2niix.read_text().splitlines()
    assert len(port_calls) == 8  # 4 patients x 2 sax series; 2ch and loose files skipped
    assert port_calls == [c.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
                          for c in jax_calls]
    assert all("-t y -s n -m y -b y -ba n -z y -f %d" in c for c in port_calls)
    _assert_trees_equal(tmp_path / "jax", tmp_path / "port")
    assert (tmp_path / "port" / "valid" / "501" / "sax_5" / "sax.nii.gz").exists()
    assert not (tmp_path / "port" / "validate").exists()


def test_dicom2nifty_without_the_program_says_so(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="dcm2niix not found"):
        dsb15_dicom2nifty.main(tmp_path, tmp_path / "out")
    assert not (tmp_path / "out").exists()
