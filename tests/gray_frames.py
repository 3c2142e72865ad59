"""The frames of an 8-bit grayscale GIF or PNG, as imageio decodes them.

imageio returns a grayscale GIF written by imageio (the JAX package's
exports) as RGB frames, and one written by the port's ``utils/imgio.py``
(one global gray palette) as gray frames; both are compared here as
(H, W) uint8 arrays, after checking that an RGB frame's three channels are
equal.
"""
import numpy as np

import imageio.v2 as imageio


def _gray(frame) -> np.ndarray:
    frame = np.asarray(frame)
    if frame.ndim == 3:
        assert frame.shape[-1] in (3, 4), frame.shape
        assert np.array_equal(frame[..., 0], frame[..., 1]) and \
            np.array_equal(frame[..., 0], frame[..., 2]), "an RGB frame that is not gray"
        frame = frame[..., 0]
    assert frame.ndim == 2 and frame.dtype == np.uint8, (frame.shape, frame.dtype)
    return frame


def gif_frames(path) -> list:
    return [_gray(f) for f in imageio.mimread(path)]


def png_frame(path) -> np.ndarray:
    return _gray(imageio.imread(path))
