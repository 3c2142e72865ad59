"""Process groups: one process per device, over ``torch.distributed``.

The JAX package drives every device of a host from one process and joins
hosts with ``jax.distributed.initialize`` (its ``parallel/distributed.py``).
The port runs one process (a rank) per device instead: NCCL joins the
ranks on the card, gloo on the CPU (the counterpart of the JAX package's
virtual CPU mesh).  A run gets its ranks in one of three ways:

* ``python -m <torch pkg>.main CONFIG`` with ``parallel: {num_devices: N}``
  spawns N ranks itself (``main.py``), each calling :func:`initialize`
  with the spawned address, world size and rank;
* under ``torchrun``, or with ``WORLD_SIZE`` and ``RANK`` set, the process
  joins that group (``init_method='env://'``);
* ``parallel: {multi_host: true, coordinator_address, num_processes,
  process_id}``: a JAX process is a host, so each host spawns its local
  ranks and rank = ``process_id · local_devices + local_rank`` over
  ``tcp://coordinator_address``.

As in the JAX package, ``require=True`` (an explicit ``multi_host: true``)
makes a missing coordinator an error and any failed initialization raises
rather than degrading: a worker that fell back to one process would see
rank 0, pass every lead-only guard and race the real lead's writes.
"""
from __future__ import annotations

import logging
import os
import pickle
import socket

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

#: the environment a launcher (``torchrun``) sets for a process of a group
_CLUSTER_ENV_VARS = ("WORLD_SIZE", "RANK")


#: the refusal of ``multi_host: true`` with nothing to join
NO_COORDINATOR = ("parallel.multi_host: true, but neither parallel.coordinator_address nor a "
                  f"launcher's environment ({', '.join(_CLUSTER_ENV_VARS)}) is set — nothing to "
                  "coordinate against.")


def cluster_env_present() -> bool:
    return all(os.environ.get(v) for v in _CLUSTER_ENV_VARS)


def backend_for(device: torch.device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: torch.device | str = "cpu",
    backend: str | None = None,
    require: bool = False,
) -> bool:
    """Join (or create) the default process group; returns whether more
    than one rank is running.

    ``coordinator_address`` (``host:port``) with ``num_processes`` (the
    world size) and ``process_id`` (this rank) joins over TCP; without an
    address, the launcher's environment (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``) is used when present.  Nothing to
    join is ``False``, or a ``ValueError`` with ``require``.  ``backend``
    is :func:`backend_for` the device unless given (gloo lets several
    ranks share one card, for correctness checks)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and not cluster_env_present():
        if require:
            raise ValueError(NO_COORDINATOR)
        return False
    backend = backend or backend_for(device)
    try:
        if coordinator_address is None:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=int(num_processes), rank=int(process_id))
    except Exception as e:
        raise RuntimeError(
            "torch.distributed.init_process_group failed; refusing to continue as "
            "one process (a degraded worker would race the lead's writes to the "
            f"shared saved_dir): {e}"
        ) from e
    logger.info("torch.distributed initialized (%s): rank %d of %d.", backend,
                dist.get_rank(), dist.get_world_size())
    return dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_local_batch_slice(global_batch_size: int) -> tuple[int, int]:
    """(local_batch_size, offset) for this rank's shard of a global batch."""
    n = world_size()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes.")
    local = global_batch_size // n
    return local, rank() * local


def free_port() -> int:
    """A TCP port on localhost nobody listens on now."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn(target, args: tuple, *, world: int, local: int | None = None, first: int = 0,
          address: str | None = None, device: torch.device | str = "cpu",
          backend: str | None = None):
    """Run ``target(*args)`` in ``local`` new processes (``spawn``, never
    ``fork``: the caller may hold JAX or CUDA state), ranks ``first`` …
    ``first + local - 1`` of a group of ``world`` at ``address``
    (``host:port``; a free local port by default) over ``backend`` (by
    default NCCL for a CUDA ``device``, gloo for the CPU), and return rank 0's
    result (None on a host without rank 0).  Each rank gets
    ``LOCAL_RANK``, its share of the CPU threads (unless
    ``OMP_NUM_THREADS`` is set), and the caller's log level (warnings
    only, past rank 0)."""
    import tempfile

    import torch.multiprocessing as mp

    local = world if local is None else local
    address = address or f"localhost:{free_port()}"
    level = logging.getLogger().getEffectiveLevel()
    with tempfile.TemporaryDirectory() as tmp:
        # rank 0's result travels by file: a pipe would block its writer once
        # full, while the caller waits in join()
        plan = {"address": address, "world": world, "local": local, "first": first,
                "device": str(device), "backend": backend, "level": level,
                "result": os.path.join(tmp, "result.pkl")}
        mp.start_processes(_rank_entry, args=(target, args, plan), nprocs=local,
                           start_method="spawn", join=True)
        if first != 0:
            return None
        with open(plan["result"], "rb") as f:
            return pickle.load(f)


def _rank_entry(local_rank: int, target, args: tuple, plan: dict) -> None:
    rank = plan["first"] + local_rank
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(message)s",
                        level=plan["level"] if rank == 0 else max(plan["level"], logging.WARNING),
                        datefmt="%Y-%m-%d %H:%M:%S")
    if "OMP_NUM_THREADS" not in os.environ:  # the caller's choice stands
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // plan["local"]))
    os.environ["LOCAL_RANK"] = str(local_rank)
    initialize(plan["address"], plan["world"], rank, device=plan["device"],
               backend=plan["backend"], require=True)
    try:
        out = target(*args)
        if rank == 0:
            with open(plan["result"], "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def local_device(device: torch.device | str) -> torch.device:
    """This rank's device: on the card ``cuda:LOCAL_RANK`` (or the rank),
    modulo the visible devices (gloo ranks may share a card), made
    current; the CPU as given."""
    device = torch.device(device)
    if device.type != "cuda" or not dist.is_initialized():
        return device
    index = int(os.environ.get("LOCAL_RANK", dist.get_rank())) % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)
