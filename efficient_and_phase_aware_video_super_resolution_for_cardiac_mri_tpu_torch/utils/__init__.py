from . import nifti
from .jax_weights import state_dict_from_jax_params
from .seeding import item_rng
from .stats import DATASET_STATS, denormalize, get_stats

__all__ = [
    "nifti",
    "state_dict_from_jax_params",
    "item_rng",
    "DATASET_STATS",
    "denormalize",
    "get_stats",
]
