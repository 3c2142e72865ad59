"""TensorBoard loggers of the trainers (reference ``src/callbacks/loggers/*``).

The port's copy of the JAX package's ``FrameLogger`` and ``VSRLogger``:
per-key train/valid scalar pairs and an HR|SR panel of the last batch,
written with tensorboardX's ``SummaryWriter``, or, where tensorboardX is not
installed, with ``torch.utils.tensorboard``'s (which needs the tensorboard
package); both write the same event files.  The writer is imported when a
logger is built, so a run whose config has no ``logger:`` section needs
neither, and one that has it fails at once where neither imports.  Each
logger is registered under both the Acdc and the Dsb15 name.  The ``dummy_input`` /
``net`` kwargs are accepted for config compatibility and ignored (graph
plotting is disabled in the reference too, ``base_logger.py:13-18``).
"""
from __future__ import annotations

import numpy as np

from ..config import LOGGERS


def _normalize_each(img: np.ndarray) -> np.ndarray:
    lo, hi = img.min(), img.max()
    return (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)


def make_grid(imgs: np.ndarray, pad: int = 2, pad_value: float = 1.0) -> np.ndarray:
    """Stack (B, H, W, C) images vertically (nrow=1), each min-max normalized,
    with padding: the torchvision ``make_grid(nrow=1, normalize=True,
    scale_each=True, pad_value=1)`` call of the reference loggers."""
    imgs = np.asarray(imgs, np.float32)
    B, H, W, C = imgs.shape
    grid = np.full((B * (H + pad) + pad, W + 2 * pad, C), pad_value, np.float32)
    for b in range(B):
        top = pad + b * (H + pad)
        grid[top : top + H, pad : pad + W] = _normalize_each(imgs[b])
    return grid


class _Logger:
    """Reference ``base_logger.py:5-59``; a subclass picks the (HR, SR) frames
    of the panel."""

    def __init__(self, log_dir, net=None, dummy_input=None):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(str(log_dir))

    def _frames(self, batch, outputs) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def write(self, epoch, train_log, train_batch, train_outputs, valid_log, valid_batch,
              valid_outputs):
        for key in train_log:
            self.writer.add_scalars(
                key, {"train": float(train_log[key]), "valid": float(valid_log[key])}, epoch
            )
        # an epoch can yield no batches (fewer items than the batch size with
        # drop_last): skip the image panels, not the run
        if train_batch is None or valid_batch is None or train_outputs is None or valid_outputs is None:
            return
        self.writer.add_image("train", self._panel(*self._frames(train_batch, train_outputs)))
        self.writer.add_image("valid", self._panel(*self._frames(valid_batch, valid_outputs)))

    def close(self):
        self.writer.close()

    @staticmethod
    def _panel(hr: np.ndarray, sr: np.ndarray) -> np.ndarray:
        """HR|SR side-by-side panel, (C, H, W) for add_image."""
        grid = np.concatenate([make_grid(hr), make_grid(np.asarray(sr))], axis=1)
        return np.clip(grid, 0, 1).transpose(2, 0, 1)


class FrameLogger(_Logger):
    """HR vs SR of the last batch of (B, H, W, C) frames: the reference's
    byte-identical single-frame loggers (``acdc_sisr_logger.py``,
    ``acdc_sisr_srfb_logger.py:23-26``, ``acdc_misr_logger.py``, where the
    HR frame is the window's reference frame); the SRFB trainer's display
    hook has already picked the last step."""

    def _frames(self, batch, outputs):
        return batch["hr_img"], outputs


class VSRLogger(_Logger):
    """Reference ``acdc_vsr_logger.py:22-30``; sequences are (B, T, H, W, C)
    arrays, so the last frame is ``[:, -1]``."""

    def _frames(self, batch, outputs):
        return batch["hr_imgs"][:, -1], outputs[:, -1]


for _workload, _cls in (("SISR", FrameLogger), ("SISRSRFB", FrameLogger), ("MISR", FrameLogger),
                       ("VSR", VSRLogger)):
    LOGGERS.add(f"Acdc{_workload}Logger", _cls)
    LOGGERS.add(f"Dsb15{_workload}Logger", _cls)
