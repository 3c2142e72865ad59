"""The PyTorch port's losses and metrics against the JAX package's.

Random denormalized pairs (integers in [0, 255], made with numpy from a
seed) go through both; every value must agree at rtol 1e-5 (float32 sums
taken in another order).
"""
import pickle

import numpy as np
import pytest
import torch

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import (
    losses as jax_losses,
    metrics as jax_metrics,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.ops.pixel_shuffle import (
    pixel_shuffle as jax_pixel_shuffle,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import (
    losses,
    metrics,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops.pixel_shuffle import (
    pixel_shuffle,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.common import (
    denorm_uint8,
)

RTOL = 1e-5


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 12, size=shape), 0, 255).round().astype(np.float32)
    return a, b


@pytest.fixture(scope="module")
def coordinates_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("coords") / "coordinates.pkl"
    with open(path, "wb") as f:
        pickle.dump({"patient001": (5, 27, 3, 30), "patient002": (0, 12, 20, 21)}, f)
    return str(path)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=RTOL, atol=0)


def test_l1_loss_matches_jax():
    a, b = _pair((2, 24, 20, 1))
    got = losses.L1Loss()(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, jax_losses.L1Loss()(a, b))
    per_frame = losses.L1Loss()(torch.from_numpy(a), torch.from_numpy(b), dim=(1, 2, 3))
    for i in range(2):
        _close(per_frame[i], jax_losses.L1Loss()(a[i], b[i]))


@pytest.mark.parametrize("size_average", [True, False])
def test_psnr_matches_jax(size_average):
    a, b = _pair((3, 24, 20, 1), seed=1)
    got = metrics.PSNR(size_average=size_average)(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, jax_metrics.PSNR(size_average=size_average)(a, b))


@pytest.mark.parametrize("shape,dim", [((3, 24, 20, 1), 2), ((2, 14, 16, 13, 1), 3)])
def test_ssim_matches_jax(shape, dim):
    a, b = _pair(shape, seed=2)
    for size_average in (True, False):
        got = metrics.SSIM(dim=dim, size_average=size_average)(torch.from_numpy(a), torch.from_numpy(b))
        want = jax_metrics.SSIM(dim=dim, size_average=size_average)(a, b)
        _close(got, want)


def test_reference_gaussian_kernel_is_copied_exactly():
    for dim in (2, 3):
        np.testing.assert_array_equal(
            metrics._reference_gaussian_kernel(dim), jax_metrics._reference_gaussian_kernel(dim)
        )


@pytest.mark.parametrize("patient", ["patient001", "patient002"])
def test_cardiac_metrics_match_jax(coordinates_path, patient):
    a, b = _pair((2, 32, 32, 1), seed=3)
    for port_cls, jax_cls in (
        (metrics.CardiacPSNR, jax_metrics.CardiacPSNR),
        (metrics.CardiacSSIM, jax_metrics.CardiacSSIM),
    ):
        port_fn, jax_fn = port_cls(coordinates_path), jax_cls(coordinates_path)
        np.testing.assert_array_equal(port_fn.mask_for(patient, (32, 32)), jax_fn.mask_for(patient, (32, 32)))
        got = port_fn(torch.from_numpy(a), torch.from_numpy(b), name=patient)
        _close(got, jax_fn(a, b, name=patient))


def test_denorm_and_pixel_shuffle_match_jax():
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.common import (
        denorm_uint8 as jax_denorm,
    )

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 6, 5, 1)).astype(np.float32) * 3
    np.testing.assert_array_equal(
        denorm_uint8(torch.from_numpy(x), 54.089, 48.084).numpy(), np.asarray(jax_denorm(x, 54.089, 48.084))
    )
    y = rng.standard_normal((2, 3, 5, 4, 2 * 16)).astype(np.float32)
    np.testing.assert_array_equal(pixel_shuffle(torch.from_numpy(y), 4).numpy(),
                                  np.asarray(jax_pixel_shuffle(y, 4)))
