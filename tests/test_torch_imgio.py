"""The port's PNG and GIF writers (``utils/imgio.py``) against imageio.

imageio is the oracle here (the machine with the card has none): it
decodes each file to exactly the frames written, at odd sizes (1×1, 1×N,
37×53), with frames that use all 256 levels, long runs, and enough
pixels to fill and clear the LZW code table several times; and the port's
predictor and ``cardiac_cropping`` writers give files that decode to the
same frames as the JAX package's imageio-written ones.  Bytes are not
compared with imageio's: the encoders differ.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner import (
    predictors as jax_predictors,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.tools import (
    cardiac_cropping as jax_cropping,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils import imgio

sys.path.insert(0, str(Path(__file__).parent))
from gray_frames import gif_frames, png_frame  # noqa: E402


def _frames(kind: str, shape, n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    h, w = shape
    if kind == "noise":
        return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]
    if kind == "all_levels":  # every gray level in every frame
        base = np.resize(np.arange(256, dtype=np.uint8), h * w).reshape(shape)
        return [np.roll(base, k) for k in range(n)]
    if kind == "flat":  # long runs: the longest LZW strings
        return [np.full(shape, 17 * k, np.uint8) for k in range(n)]
    if kind == "few_levels":
        return [(rng.integers(0, 3, shape) * 127).astype(np.uint8) for _ in range(n)]
    raise ValueError(kind)


SHAPES = [(1, 1), (1, 300), (37, 53), (64, 64), (255, 257)]
KINDS = ["noise", "all_levels", "flat", "few_levels"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_imageio_decodes_the_frames_written(tmp_path, shape, kind):
    frames = _frames(kind, shape, 3)
    imgio.write_gif(tmp_path / "a.gif", frames)
    got = gif_frames(tmp_path / "a.gif")
    assert len(got) == 3 and all(np.array_equal(g, f) for g, f in zip(got, frames))
    assert imgio.gif_frame_count(tmp_path / "a.gif") == 3
    assert (tmp_path / "a.gif").read_bytes()[:6] == b"GIF89a"
    imgio.write_png(tmp_path / "a.png", frames[0])
    assert (tmp_path / "a.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert np.array_equal(png_frame(tmp_path / "a.png"), frames[0])


def test_every_lzw_code_width_boundary_round_trips(tmp_path):
    """One-row images of every length up to 1300 and around the table's
    clear: the code width changes and the final code land on every
    position relative to them."""
    rng = np.random.default_rng(1)
    for n in list(range(1, 1300, 3)) + [3838, 3839, 3840, 3841, 3842, 8000]:
        frame = rng.integers(0, 256, (1, n), dtype=np.uint8)
        imgio.write_gif(tmp_path / "r.gif", [frame])
        got = gif_frames(tmp_path / "r.gif")
        assert len(got) == 1 and np.array_equal(got[0], frame), n


def test_writers_refuse_what_they_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        imgio.write_png(tmp_path / "x.png", np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        imgio.write_gif(tmp_path / "x.gif", [np.zeros((2, 2, 3), np.uint8)])
    with pytest.raises(ValueError, match="at least one"):
        imgio.write_gif(tmp_path / "x.gif", [])
    with pytest.raises(ValueError, match="every frame"):
        imgio.write_gif(tmp_path / "x.gif", [np.zeros((2, 2), np.uint8), np.zeros((2, 3), np.uint8)])
    (tmp_path / "x.gif").write_bytes(b"GIF89a" + bytes(7) + b"\x2c")
    with pytest.raises(ValueError, match="ends inside"):
        imgio.gif_frame_count(tmp_path / "x.gif")
    (tmp_path / "y.gif").write_bytes(b"\x89PNG")
    with pytest.raises(ValueError, match="not a GIF"):
        imgio.gif_frame_count(tmp_path / "y.gif")
    # an (H, W, 1) frame is the (H, W) one
    one = np.arange(6, dtype=np.uint8).reshape(2, 3, 1)
    imgio.write_png(tmp_path / "c.png", one)
    assert np.array_equal(png_frame(tmp_path / "c.png"), one[..., 0])


# imageio (through Pillow) refuses to write the "noise" frames as a GIF
# ("No packer found from P to L"): the JAX package's writer cannot be the
# oracle there, and the decoder test above holds the port on them
@pytest.mark.parametrize("kind", ["all_levels", "flat", "few_levels"])
def test_export_writers_decode_as_the_jax_packages(tmp_path, kind):
    """``imgio.write_gif``/``write_png`` (the port's predictors' and
    ``cardiac_cropping``'s writers) against the JAX package's predictor and
    cardiac_cropping writers, on the same uint8 frames (30 frames of an odd
    37×53 slice)."""
    frames = _frames(kind, (37, 53), 30, seed=2)
    if kind == "flat":  # imageio merges equal consecutive frames; keep them apart
        frames = [f + np.uint8(k % 2) for k, f in enumerate(frames)]
    imgio.write_gif(tmp_path / "port.gif", frames)
    for name, jax_fn in (("pred", jax_predictors._dump_video), ("crop", jax_cropping.dump_video)):
        jax_fn(tmp_path / f"{name}_jax.gif", frames)
        a, b = gif_frames(tmp_path / "port.gif"), gif_frames(tmp_path / f"{name}_jax.gif")
        assert len(a) == len(b) == 30 and all(np.array_equal(x, y) for x, y in zip(a, b)), name
    imgio.write_png(tmp_path / "port.png", frames[3])
    jax_predictors._dump_image(tmp_path / "jax.png", frames[3])
    assert np.array_equal(png_frame(tmp_path / "port.png"), png_frame(tmp_path / "jax.png"))
