"""An autouse fixture for the port's test files that change directory and
then run the JAX package as their oracle.

The JAX package keys its process-wide volume and pickle caches by the path
string (``..._tpu/data/datasets.py:32-88``), so after a chdir into a tree
with the same relative ``./data`` layout as an earlier one it would read the
earlier tree.  The fixture empties both caches before and after each test,
so no test reads another's tree and none leaves its own behind for a later
file in the same process (xdist ``--dist loadfile``).  Import it into the
test module::

    from jax_data_caches import empty_jax_data_caches  # noqa: F401
"""
import pytest

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.data import datasets


def _empty() -> None:
    with datasets._VOLUMES._lock:
        datasets._VOLUMES._cache.clear()
    with datasets._PICKLES_LOCK:
        datasets._PICKLES.clear()


@pytest.fixture(autouse=True)
def empty_jax_data_caches():
    _empty()
    yield
    _empty()
