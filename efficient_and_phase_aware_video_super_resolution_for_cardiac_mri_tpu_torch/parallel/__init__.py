"""Multi-device runs of the port over ``torch.distributed`` (the JAX
package's ``parallel/``): one rank per device, a (data, model) mesh."""
from .distributed import initialize as distributed_initialize
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SPATIAL_AXIS,
    Mesh,
    all_reduce_mean,
    batch_slice,
    check_devices,
    is_sharded,
    make_mesh,
    partition,
)

__all__ = [
    "distributed_initialize",
    "DATA_AXIS",
    "MODEL_AXIS",
    "SPATIAL_AXIS",
    "Mesh",
    "all_reduce_mean",
    "batch_slice",
    "check_devices",
    "is_sharded",
    "make_mesh",
    "partition",
]
