"""The one traffic generator: seeded cine-MRI phantoms written as an ACDC tree.

Every traffic mix is a JSON file of parameters under ``traffic/``; this
module reads any of them.  A sequence is one short-axis slice over one
cardiac cycle: an elliptic torso with an intensity gradient and a texture,
a dark myocardial ring and a bright blood pool whose radius follows a
raised-cosine cycle with end-systole at 0.4·T, and Gaussian noise; values
rounded to integers in [0, 255] and stored as float32, as the preprocessed
ACDC trees store them.  The sizes (frames, HR side, scale, number of
sequences) are the traffic file's and never depend on the seed; the seed
moves only the geometry, the texture and the noise.  The volumes are drawn
on the run's device from a ``torch.Generator`` in a few large calls.

Parameters of a traffic file:

* ``layout``: ``inbox`` (LR volumes only, ``<root>/<patient>/<patient>_2d+
  1d_sequenceNN.nii.gz``, what a serving daemon watches) or ``train``
  (``<root>/videos/train/{HR,LR/X<scale>}/<patient>/...`` plus
  ``<root>/position_code.pkl``, what the trainers' datasets read);
* ``patients``, ``sequences_per_patient``, ``frames``, ``hr_size``,
  ``scale``.
"""
from __future__ import annotations

import math
import pickle
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from . import nifti


def end_systole(frames: int) -> int:
    return max(1, int(round(0.4 * frames)))


def _texture(gen, n, size, device):
    """Mid-frequency speckle in [-1, 1]: white noise blurred (sigma 1 px)."""
    x = torch.randn(n, 1, size, size, generator=gen, device=device)
    r = torch.arange(-3, 4, device=device, dtype=torch.float32)
    k = torch.exp(-0.5 * r ** 2)
    k = k / k.sum()
    x = F.conv2d(F.pad(x, (3, 3, 0, 0), mode="reflect"), k.view(1, 1, 1, 7))
    x = F.conv2d(F.pad(x, (0, 0, 3, 3), mode="reflect"), k.view(1, 1, 7, 1))[:, 0]
    return x / x.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-6)


def sequences(gen: torch.Generator, n: int, frames: int, hr_size: int, stride: int,
              device) -> torch.Tensor:
    """``n`` phantom sequences (n, T, hr_size / stride, hr_size / stride): the
    HR grid sampled every ``stride`` pixels (stride 1 is the HR frame)."""
    size = hr_size
    u = torch.rand(n, 8, generator=gen, device=device)
    grid = torch.arange(0, size, stride, device=device, dtype=torch.float32)
    yy, xx = grid[None, :, None], grid[None, None, :]
    torso_cy = size / 2 + (u[:, 0] * 4 - 2)
    torso_cx = size / 2 + (u[:, 1] * 4 - 2)
    torso_ay = 0.42 * size * (0.95 + 0.1 * u[:, 2])
    torso_ax = 0.45 * size * (0.95 + 0.1 * u[:, 3])
    angle = u[:, 4] * 2 * math.pi
    cy = torso_cy + (u[:, 5] * 0.08 - 0.04) * size
    cx = torso_cx + (u[:, 6] * 0.08 - 0.04) * size
    r_pool0 = 0.14 * size * (0.9 + 0.2 * u[:, 7])
    r_myo0 = r_pool0 + 0.06 * size
    v = lambda a: a[:, None, None]  # noqa: E731
    tex = _texture(gen, n, size, device)[:, ::stride, ::stride]
    d_heart = torch.sqrt((yy - v(cy)) ** 2 + (xx - v(cx)) ** 2)
    d_torso = torch.sqrt(((yy - v(torso_cy)) / v(torso_ay)) ** 2
                         + ((xx - v(torso_cx)) / v(torso_ax)) ** 2)
    torso = torch.sigmoid(4 * (1 - d_torso) * v(torch.minimum(torso_ay, torso_ax)) / 2)
    gradient = 25.0 * (v(torch.cos(angle)) * (xx - size / 2) / size
                       + v(torch.sin(angle)) * (yy - size / 2) / size)
    tissue = 102.0 + gradient + 18.0 * tex
    t = torch.arange(frames, device=device, dtype=torch.float32)
    t_es = end_systole(frames)
    contraction = torch.where(t <= t_es, (1 - torch.cos(math.pi * t / t_es)) / 2,
                              (1 + torch.cos(math.pi * (t - t_es) / max(1, frames - t_es))) / 2)
    r_pool = r_pool0[:, None] * (1 - 0.45 * contraction[None, :])  # (n, T)
    r_myo = torch.sqrt(r_pool ** 2 + (r_myo0 ** 2 - r_pool0 ** 2)[:, None])
    dh = d_heart[:, None]
    pool = torch.sigmoid(4 * (r_pool[:, :, None, None] - dh))
    myo = torch.sigmoid(4 * (r_myo[:, :, None, None] - dh)) - pool
    img = (8.0 + torso[:, None] * tissue[:, None]
           + myo * (60.0 + 10.0 * tex[:, None] - tissue[:, None])
           + pool * (225.0 + 12.0 * tex[:, None] - tissue[:, None]))
    img = img + 2.0 * torch.randn(img.shape, generator=gen, device=device)
    return img.clamp(0, 255).round()


def _names(traffic: dict):
    """(patient, file name) of every sequence, in the tree's sorted order."""
    out = []
    for p in range(traffic["patients"]):
        patient = f"patient{p + 1:03d}"
        for s in range(traffic["sequences_per_patient"]):
            out.append((patient, f"{patient}_2d+1d_sequence{s + 1:02d}.nii.gz"))
    return out


def write_tree(traffic: dict, seed: int, root: Path, device, chunk: int = 32) -> dict:
    """Draw the traffic's sequences from ``seed`` and write its tree under
    ``root`` → what was written: the names, the LR (and HR) volumes as
    (H, W, T) float32 host arrays, the bytes written."""
    root = Path(root)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    names = _names(traffic)
    T, hr, scale = traffic["frames"], traffic["hr_size"], traffic["scale"]
    train = traffic["layout"] == "train"
    lr_all, hr_all, written = [], [], 0
    for start in range(0, len(names), chunk):
        part = names[start:start + chunk]
        vols = sequences(gen, len(part), T, hr, 1 if train else scale, device)
        vols = vols.permute(0, 2, 3, 1).contiguous()  # (n, H, W, T)
        hr_np = vols.cpu().numpy() if train else None
        lr_np = hr_np[:, ::scale, ::scale] if train else vols.cpu().numpy()
        items = []
        for i, (patient, name) in enumerate(part):
            lr = np.ascontiguousarray(lr_np[i])
            lr_all.append(lr)
            if train:
                hr_all.append(hr_np[i])
                base = root / "videos" / "train"
                items.append((base / "HR" / patient / name, hr_np[i][:, :, None]))
                items.append((base / "LR" / f"X{scale}" / patient / name, lr[:, :, None]))
            else:
                items.append((root / patient / name, lr[:, :, None]))
        written += nifti.write_many(items)
    if train:
        from ..reference.phase_code import cosine_code

        code = cosine_code(T, end_systole(T))
        with open(root / "position_code.pkl", "wb") as f:
            pickle.dump({p: code for p in sorted({p for p, _ in names})}, f)
    return {"names": names, "lr": lr_all, "hr": hr_all, "bytes": written}
