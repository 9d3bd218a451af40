"""The ('data', 'edge') grid of ranks, the port of
``feedback_gnn_tpu/parallel/mesh.py``.

* ``data``: Monte-Carlo batch sharding, pure data parallelism (the
  throughput axis);
* ``edge``: Tanner-graph CN/edge partitioning; per-VN reductions sum over
  it (parallel/shard.py).

One process per rank, as ``torchrun`` starts them (or the CLIs' own
spawn, parallel/launch.py).  Rank ``r`` sits at data index ``r // edge`` and
edge index ``r % edge``.  Its device is ``cuda:(LOCAL_RANK % cards)``, or the
CPU when asked for.

The backend is chosen, never fallen back to: NCCL when every rank of the
host has a card of its own, Gloo when ranks share a card (NCCL refuses two
ranks on one device) and on the CPU.  The kernels run on the card either
way; Gloo carries the all-reduces of CUDA tensors through the host.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import resolve_device

__all__ = ["Mesh", "make_mesh", "init_distributed", "choose_backend", "rank_device"]

DEFAULT_TIMEOUT_S = 60.0


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when asked for, else the card
    ``LOCAL_RANK % device_count`` (raises when there is no card)."""
    if device is not None and torch.device(device).type == "cpu":
        return resolve_device("cpu")
    resolve_device("cuda")
    return resolve_device(f"cuda:{_env_int('LOCAL_RANK', 0) % torch.cuda.device_count()}")


def choose_backend(device: torch.device) -> str:
    """NCCL when this host's ranks each have a card of their own, else Gloo."""
    if device.type != "cuda":
        return "gloo"
    local_ranks = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def init_distributed(backend: str | None = None, timeout_s: float = DEFAULT_TIMEOUT_S,
                     device=None, init_method: str = "env://") -> int:
    """Join the process group that ``torchrun`` describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR/PORT) or ``init_method`` names, and return this
    rank.  Idempotent: a joined process returns its rank.  ``backend`` None
    chooses by ``choose_backend``; the choice is printed by rank 0."""
    if dist.is_initialized():
        return dist.get_rank()
    dev = rank_device(device)
    backend = backend or choose_backend(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    if init_method != "env://":
        kwargs.update(rank=_env_int("RANK", 0), world_size=_env_int("WORLD_SIZE", 1))
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    if dist.get_rank() == 0:
        print(f"torch.distributed: backend {backend}, world {dist.get_world_size()}, "
              f"device {dev}", flush=True)
    return dist.get_rank()


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid and its groups.  ``data_group`` holds
    the ranks of every data index at this edge index (the whole group when
    ``edge`` is 1, even of one rank; None when ``data`` is 1 and ``edge``
    is not), ``edge_group`` the ranks of every edge index at this data
    index (None when ``edge`` is 1, as the JAX package then passes no edge
    axis)."""

    data: int
    edge: int
    rank: int
    data_index: int
    edge_index: int
    data_group: object
    edge_group: object
    device: torch.device
    backend: str


def make_mesh(data: int | None = None, edge: int = 1, device=None) -> Mesh:
    """The ('data', 'edge') grid over the joined process group: every rank
    calls it with the same arguments (each builds every group, as
    ``new_group`` requires).  ``data`` None uses every rank."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    world = dist.get_world_size()
    if data is None:
        data = world // edge
    if data * edge != world:
        raise ValueError(f"a data={data} x edge={edge} grid needs {data * edge} ranks, "
                         f"the group has {world}")
    rank = dist.get_rank()
    d, e = divmod(rank, edge)
    columns = rows = None
    if edge > 1 and data > 1:
        columns = [dist.new_group([i * edge + c for i in range(data)]) for c in range(edge)]
        rows = [dist.new_group([r * edge + j for j in range(edge)]) for r in range(data)]
    world_group = dist.group.WORLD
    data_group = world_group if edge == 1 else (columns[e] if columns else None)
    edge_group = None if edge == 1 else (rows[d] if rows else world_group)
    return Mesh(data=data, edge=edge, rank=rank, data_index=d, edge_index=e,
                data_group=data_group, edge_group=edge_group, device=rank_device(device),
                backend=dist.get_backend())
