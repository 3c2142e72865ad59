"""Multi-device runs of the port over ``torch.distributed`` (the JAX
package's ``parallel/``): one rank per device, a (data, spatial) or
(data, model) mesh."""
from .distributed import initialize as distributed_initialize
from .halo import SpatialAxis, gather_rows, set_spatial_axis, shard_spatially
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SPATIAL_AXIS,
    Mesh,
    all_reduce_mean,
    batch_slice,
    check_axes,
    check_devices,
    is_sharded,
    make_mesh,
    pad_height_to_multiple,
    partition,
    spatial_rows,
    spatial_step,
    take_rows,
)

__all__ = [
    "distributed_initialize",
    "DATA_AXIS",
    "MODEL_AXIS",
    "SPATIAL_AXIS",
    "Mesh",
    "SpatialAxis",
    "all_reduce_mean",
    "batch_slice",
    "check_axes",
    "check_devices",
    "gather_rows",
    "is_sharded",
    "make_mesh",
    "pad_height_to_multiple",
    "partition",
    "set_spatial_axis",
    "shard_spatially",
    "spatial_rows",
    "spatial_step",
    "take_rows",
]
