"""The device mesh of the port: (data, spatial) or (data, model) over the world group.

The JAX package lays its devices out as a named mesh with a ``data``
axis and an optional ``model`` or ``spatial`` axis (its
``parallel/mesh.py``), and GSPMD inserts the collectives.  Here every
device is a rank and the axes are process groups:

* ``data``: each rank takes its contiguous slice of the global batch
  (:func:`batch_slice`, which ``data/loader.py`` applies); the gradients are averaged
  over the data ranks by DDP, BatchNorm reduces its statistics over them
  (``models/common.py``), and the logged values are averaged over them.
  A global batch that the data size does not divide is computed whole on
  every rank, with the JAX package's one-time warning: averaging unequal
  local means would give another step.
* ``spatial``: the height of a frame sharded over the ranks of one
  ``spatial_group`` (:func:`spatial_rows`), every conv exchanging its halo
  rows with the neighbours (``parallel/halo.py``).  The ranks of a group
  take the same items; DDP averages the gradients over every rank (data ×
  spatial), and with equal shards the mean of the ranks' local means is the
  global mean.  A height that the spatial size does not divide is computed
  whole on every rank of the group, with the JAX package's one-time
  warning, and so is one whose bands would not fit the net's pad and
  pyramid (TOFlow, FRVSR, EDVR: :func:`spatial_step`); ``pad_h``
  edge-extends a height to a multiple of the spatial size
  (:func:`pad_height_to_multiple`).  A training BatchNorm reduces its
  statistics over the ranks that hold the step's other rows and other
  items, and no further (:meth:`Mesh.statistics_group`): a replicated
  item or batch is counted once.  Every net of the zoo takes the axis;
  a warp or a deformable conv whose flow or offsets are unbounded reads
  the frame gathered whole (``parallel/halo.gather_frame``).
* ``model``: ZeRO-3, as the JAX package's ``param_spec`` /
  ``gather_for_compute`` do it: every parameter and its optimizer state
  are stored sharded over the model ranks (FSDP2 ``fully_shard`` on a 2-D
  device mesh, the data axis replicated) and gathered whole for the
  step.  Torch's conv weights are OIHW, so FSDP2's dim-0 shard is the
  out-feature axis that JAX shards on HWIO's last.  The ranks of one model
  group hold the same data.

``spatial`` and ``model`` exclude each other, as in the JAX package.  Ranks
are laid out with the second axis fastest, as there: rank = data_index ·
spatial + spatial_index, or data_index · model + model_index.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from .halo import SpatialAxis, set_spatial_axis, shard_spatially

DATA_AXIS = "data"
MODEL_AXIS = "model"
SPATIAL_AXIS = "spatial"

LOG = logging.getLogger(__name__)


@dataclass
class Mesh:
    """A (data, spatial) or (data, model) mesh over the default process group."""

    data: int
    model: int
    rank: int
    device: torch.device
    #: the group of the ranks that hold the same parameter shard (one per
    #: model index; every rank under a spatial axis): gradients, BatchNorm
    #: statistics and the trainer's logs reduce here
    data_group: object = None
    #: the ranks that share one frame's rows (``parallel/halo.py``)
    spatial: int = 1
    spatial_group: object = field(default=None, repr=False)
    #: under a spatial axis, the ranks of this spatial index: they hold
    #: other items and the same rows (None with one data index)
    item_group: object = field(default=None, repr=False)
    #: FSDP2's 2-D device mesh, when the mesh has a model axis
    device_mesh: object = None
    #: the hosts the ranks run on (``parallel.num_processes`` of a
    #: multi-host run)
    hosts: int = 1
    #: a gloo group over every rank for host-side collectives
    #: (``torch.distributed.checkpoint``, Python objects): a CPU backend
    #: under NCCL, and apart from the step's collectives, so that an
    #: asynchronous save's background thread never interleaves with them
    host_group: object = field(default=None, repr=False)
    #: the default group's backend (``nccl`` or ``gloo``), kept for the
    #: record after a run's own group is gone
    backend: str | None = None

    @property
    def shape(self) -> dict:
        out = {DATA_AXIS: self.data}
        if self.spatial > 1:
            out[SPATIAL_AXIS] = self.spatial
        if self.model > 1:
            out[MODEL_AXIS] = self.model
        return out

    @property
    def size(self) -> int:
        return self.data * self.spatial * self.model

    @property
    def data_index(self) -> int:
        return self.rank // (self.spatial * self.model)

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def replicas(self) -> int:
        """The ranks of ``data_group``."""
        return self.data * self.spatial

    @property
    def spatial_axis(self) -> SpatialAxis | None:
        """This rank's place on the spatial axis (None without one)."""
        if self.spatial == 1:
            return None
        return SpatialAxis(self.spatial_group, self.spatial, self.spatial_index)

    @property
    def is_lead(self) -> bool:
        return self.rank == 0

    def statistics_group(self, items_split: bool, rows_split: bool):
        """The group whose ranks' training BatchNorm statistics together
        make the global batch's: the ranks that hold the step's other
        items (when the batch is split over ``data``) and its other rows
        (when the height is split over ``spatial``); None when this rank
        holds the whole batch.  A rank holding a copy is left out, so that
        every item is counted once, as the JAX package's replicated arrays
        are (the unbiased running variance reads the count)."""
        if items_split and (rows_split or self.spatial == 1):
            return self.data_group
        if rows_split:
            return self.spatial_group
        return self.item_group if items_split else None


def check_devices(n: int, device: torch.device | str) -> None:
    """The JAX package's refusal of a mesh larger than the visible devices,
    on the card (the CPU takes any number of ranks)."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    visible = torch.cuda.device_count()
    if n > visible:
        raise ValueError(
            f"parallel.num_devices={n} but only {visible} device(s) are visible "
            f"({device.type}). Lower num_devices; a config with device: 'cpu' runs "
            "its ranks on the CPU.")


def check_axes(n: int, spatial_parallel: int = 1, model_parallel: int = 1) -> None:
    """The JAX package's refusals of a mesh's axes (its ``make_mesh``)."""
    sp, mp = int(spatial_parallel or 1), int(model_parallel or 1)
    if sp > 1 and mp > 1:
        raise ValueError(
            "spatial_parallel and model_parallel cannot be combined: XLA's "
            "SPMD partitioner miscompiles convs whose spatially-sharded "
            "operands are partially replicated over a third axis (the JAX "
            "package's parallel/mesh.py docstring has the measurements).")
    if n % (sp * mp):
        raise ValueError(f"{n} devices not divisible by spatial_parallel={sp} x model_parallel={mp}.")


def make_mesh(num_devices: int | None = None, model_parallel: int = 1,
              spatial_parallel: int = 1, device: torch.device | str | None = None,
              hosts: int = 1) -> Mesh:
    """The mesh over the default process group: ``data`` takes what is
    left, data = n / (spatial · model).  ``num_devices`` must equal the
    world size; on the card with NCCL it may not exceed the visible devices
    (with gloo several ranks may share one card, for correctness checks
    only)."""
    sp, mp = int(spatial_parallel or 1), int(model_parallel or 1)
    if sp > 1 and mp > 1:
        check_axes(sp * mp, sp, mp)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized (parallel/distributed.py)")
    world = dist.get_world_size()
    n = int(num_devices or world)
    device = torch.device(device) if device is not None else torch.device("cpu")
    if dist.get_backend() == "nccl":
        check_devices(n, device)
    if n != world:
        raise ValueError(f"parallel.num_devices={n} but the process group has {world} ranks.")
    check_axes(n, sp, mp)
    rank = dist.get_rank()
    host_group = dist.new_group(backend="gloo")
    backend = dist.get_backend()
    if mp == 1:
        spatial_group = item_group = None
        if sp > 1:
            # every rank makes every group, in the same order
            for d in range(n // sp):
                group = dist.new_group(list(range(d * sp, (d + 1) * sp)))
                if rank // sp == d:
                    spatial_group = group
            if n // sp > 1:
                for s in range(sp):
                    group = dist.new_group(list(range(s, n, sp)))
                    if rank % sp == s:
                        item_group = group
        return Mesh(data=n // sp, model=1, rank=rank, device=device, data_group=dist.group.WORLD,
                    spatial=sp, spatial_group=spatial_group, item_group=item_group, hosts=hosts,
                    host_group=host_group, backend=backend)
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(device.type, (n // mp, mp), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(data=n // mp, model=mp, rank=rank, device=device,
                data_group=device_mesh.get_group(DATA_AXIS), device_mesh=device_mesh, hosts=hosts,
                host_group=host_group, backend=backend)


def batch_slice(batch_size: int, mesh: Mesh | None) -> slice:
    """This rank's contiguous slice of a global batch of ``batch_size``;
    the whole batch when the data size does not divide it (warned once
    for a batch of more than one item, as the JAX package's
    ``shard_batch`` warns)."""
    if mesh is None or mesh.data == 1:
        return slice(None)
    if batch_size % mesh.data:
        if batch_size > 1:
            _warn_once(
                ("data", batch_size),
                f"batch {batch_size} is not divisible by the data axis ({mesh.data}); "
                "replicating it over 'data' "
                "(no data parallelism for this step). Set drop_last or pick a divisible "
                "batch size.")
        return slice(None)
    local = batch_size // mesh.data
    return slice(mesh.data_index * local, (mesh.data_index + 1) * local)


def is_sharded(batch_size: int, mesh: Mesh | None) -> bool:
    """Whether a global batch of ``batch_size`` splits over the data axis."""
    return mesh is not None and mesh.data > 1 and batch_size % mesh.data == 0


def _spatial_key(key) -> bool:
    """Batch keys whose arrays of rank >= 4 are channels-last images with
    the height at ``ndim - 3`` (the JAX package's ``_spatial_key``)."""
    return isinstance(key, str) and ("img" in key or key in ("lr", "hr", "pos", "pos_code"))


def pad_height_to_multiple(arr: np.ndarray, multiple: int) -> np.ndarray:
    """The ``pad_h`` contract (the JAX package's): edge-extend the height
    axis (``ndim - 3``, channels-last) at the bottom to the next multiple
    of ``multiple``; callers crop the outputs back to the true height."""
    arr = np.asarray(arr)
    h_axis = arr.ndim - 3
    pad = -arr.shape[h_axis] % multiple
    if not pad:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[h_axis] = (0, pad)
    return np.pad(arr, widths, mode="edge")


def spatial_rows(shape: tuple, mesh: Mesh | None) -> slice | None:
    """This rank's rows of a channels-last array of ``shape`` (height at
    ``ndim - 3``) over the spatial axis; None without a spatial axis, and,
    warned once, when the spatial size does not divide the height: the
    item is then computed whole on every rank of the group."""
    if mesh is None or mesh.spatial == 1:
        return None
    height = shape[len(shape) - 3]
    if height % mesh.spatial:
        _warn_once(
            ("spatial", tuple(shape)),
            f"height {height} of a {tuple(shape)} array is not divisible by "
            f"spatial_parallel={mesh.spatial}; replicating it over the spatial axis (no "
            "latency win for this item). Pad or bucket H to a multiple to shard.")
        return None
    local = height // mesh.spatial
    return slice(mesh.spatial_index * local, (mesh.spatial_index + 1) * local)


def spatial_step(net: torch.nn.Module, shape: tuple, mesh: Mesh | None) -> tuple:
    """For an item whose LR image array has ``shape``: this rank's rows of
    it and the spatial axis, ``net`` given that axis for the item's
    forward (and its backward's recompute); (None, None) without a spatial
    axis, and with the net's axis off when the height is not divisible
    (:func:`spatial_rows`) or does not give the net the bands its pad and
    pyramid need (a module's ``band_misfit``; warned once a shape): the
    item is then computed whole on every rank of the group, as the JAX
    package's GSPMD runs any height."""
    if mesh is None or mesh.spatial == 1:
        return None, None
    rows = spatial_rows(shape, mesh)
    height = shape[len(shape) - 3]
    for module in net.modules() if rows is not None else ():
        misfit = hasattr(module, "band_misfit") and module.band_misfit(height, mesh.spatial)
        if misfit:
            _warn_once(
                ("spatial", tuple(shape)),
                f"{type(module).__name__} on spatial_parallel={mesh.spatial}: {misfit}; "
                f"replicating the {tuple(shape)} array over the spatial axis (no latency win "
                "for this item). Pick a height that gives such bands to shard.")
            rows = None
            break
    axis = mesh.spatial_axis if rows is not None else None
    set_spatial_axis(net, axis)
    return rows, axis


def take_rows(arr, rows: slice):
    """``arr``'s ``rows`` of its height axis (``ndim - 3``)."""
    return arr[(slice(None),) * (arr.ndim - 3) + (rows,)]


_WARNED: set = set()


def _warn_once(key, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        LOG.warning(msg)


def partition(net: torch.nn.Module, mesh: Mesh | None, compute_dtype: torch.dtype | None = None):
    """The module the step runs: the net itself without a mesh; DDP over
    the data ranks for a data-only mesh (every rank under a spatial axis,
    the net given its halo axis first; ignoring the net's
    ``unused_parameters``, which get no gradient); for a model axis the net sharded
    in place by FSDP2 over the (data, model) device mesh (replicated over
    data, ZeRO-3 over model), with ``compute_dtype`` as its parameter
    dtype for the step (``MixedPrecisionPolicy``: gathered in that dtype,
    gradients reduced and kept in fp32)."""
    if mesh is None:
        return net
    shard_spatially(net, mesh.spatial_axis)
    if mesh.model > 1:
        from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

        policy = MixedPrecisionPolicy()
        if compute_dtype is not None:
            policy = MixedPrecisionPolicy(param_dtype=compute_dtype, reduce_dtype=torch.float32,
                                          output_dtype=torch.float32)
        return fully_shard(net, mesh=mesh.device_mesh, mp_policy=policy)
    import inspect

    from torch.nn.parallel import DistributedDataParallel as DDP

    kwargs = {"process_group": mesh.data_group}
    if mesh.device.type == "cuda":
        kwargs["device_ids"] = [mesh.device]
    # a parameter the net never uses gets no gradient: DDP must not wait for it
    DDP._set_params_and_buffers_to_ignore_for_model(net, list(getattr(net, "unused_parameters", ())))
    # every rank starts from the same seeded weights and BatchNorm reduces
    # over the data ranks, so the buffers agree without a per-step broadcast
    if "forward_sync_buffers" in inspect.signature(DDP.__init__).parameters:
        kwargs["forward_sync_buffers"] = False
    else:
        kwargs["broadcast_buffers"] = False
    return DDP(net, **kwargs)


def all_reduce_mean(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``t`` averaged over ``data_group`` (the data ranks; every rank under
    a spatial axis), in place, returned."""
    if mesh is not None and mesh.replicas > 1:
        dist.all_reduce(t, group=mesh.data_group)
        t /= mesh.replicas
    return t
