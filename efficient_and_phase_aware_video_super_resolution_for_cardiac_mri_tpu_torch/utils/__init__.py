from . import nifti
from .jax_weights import state_dict_from_jax_params
from .seeding import SeedState, epoch_rng, item_rng, seed_everything
from .stats import DATASET_STATS, denormalize, get_stats

__all__ = [
    "nifti",
    "state_dict_from_jax_params",
    "SeedState",
    "epoch_rng",
    "item_rng",
    "seed_everything",
    "DATASET_STATS",
    "denormalize",
    "get_stats",
]
