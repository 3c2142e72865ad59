"""The device mesh of the port: (data, model) over the world group.

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
* ``model``: ZeRO-3, as the JAX package's ``param_spec`` /
  ``gather_for_compute`` do it: every parameter and its optimizer state
  are stored sharded over the model ranks (FSDP2 ``fully_shard`` on a 2-D
  device mesh, the data axis replicated) and gathered whole for the
  step.  Torch's conv weights are OIHW, so FSDP2's dim-0 shard is the
  out-feature axis that JAX shards on HWIO's last.  The ranks of one model
  group hold the same data.
* ``spatial`` (the height axis with halo exchange) and ``pad_h`` are not
  ported (ROADMAP item 10b): PyTorch has no GSPMD to insert the halos.

Ranks are laid out (data, model) with the model axis fastest, as in the
JAX package: rank = data_index · model + model_index.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SPATIAL_AXIS = "spatial"

LOG = logging.getLogger(__name__)

_SPATIAL_MSG = ("the spatial axis (height sharded with a halo exchange) and pad_h are not "
                "ported to PyTorch yet (ROADMAP queue 1, item 10b)")


@dataclass
class Mesh:
    """A (data, model) mesh over the default process group."""

    data: int
    model: int
    rank: int
    device: torch.device
    #: the group of the ranks that hold the same parameter shard (one per
    #: model index): gradients, BatchNorm statistics and logs reduce here
    data_group: object = None
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
        if self.model > 1:
            out[MODEL_AXIS] = self.model
        return out

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def is_lead(self) -> bool:
        return self.rank == 0


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


def make_mesh(num_devices: int | None = None, model_parallel: int = 1,
              spatial_parallel: int = 1, device: torch.device | str | None = None,
              hosts: int = 1) -> Mesh:
    """The mesh over the default process group: ``data`` takes what is
    left, data = n / model.  ``num_devices`` must equal the world size;
    on the card with NCCL it may not exceed the visible devices (with gloo
    several ranks may share one card, for correctness checks only)."""
    if spatial_parallel and int(spatial_parallel) > 1:
        raise NotImplementedError(f"spatial_parallel={spatial_parallel}: {_SPATIAL_MSG}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized (parallel/distributed.py)")
    world = dist.get_world_size()
    n = int(num_devices or world)
    device = torch.device(device) if device is not None else torch.device("cpu")
    if dist.get_backend() == "nccl":
        check_devices(n, device)
    if n != world:
        raise ValueError(f"parallel.num_devices={n} but the process group has {world} ranks.")
    mp = int(model_parallel or 1)
    if n % mp:
        raise ValueError(f"{n} devices not divisible by spatial_parallel=1 x model_parallel={mp}.")
    rank = dist.get_rank()
    host_group = dist.new_group(backend="gloo")
    backend = dist.get_backend()
    if mp == 1:
        return Mesh(data=n, model=1, rank=rank, device=device, data_group=dist.group.WORLD,
                    hosts=hosts, host_group=host_group, backend=backend)
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


_WARNED: set = set()


def _warn_once(key, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        LOG.warning(msg)


def partition(net: torch.nn.Module, mesh: Mesh | None, compute_dtype: torch.dtype | None = None):
    """The module the step runs: the net itself without a mesh; DDP over
    the data ranks for a data-only mesh (ignoring the net's
    ``unused_parameters``, which get no gradient); for a model axis the net sharded
    in place by FSDP2 over the (data, model) device mesh (replicated over
    data, ZeRO-3 over model), with ``compute_dtype`` as its parameter
    dtype for the step (``MixedPrecisionPolicy``: gathered in that dtype,
    gradients reduced and kept in fp32)."""
    if mesh is None:
        return net
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
    """``t`` averaged over the data ranks (in place, returned)."""
    if mesh is not None and mesh.data > 1:
        dist.all_reduce(t, group=mesh.data_group)
        t /= mesh.data
    return t
