"""The ("data", "model") device mesh of one process, and its collectives.

Counterpart of `rag_serving_system_tpu/parallel/mesh.py:17-36`. The JAX
package is single-controller: one process builds a `jax.sharding.Mesh` over
every visible device and GSPMD places the collectives. Here the mesh is a
(dp, tp) grid of `torch.device`s in one process, and the collectives are
explicit functions: copies between devices, and sums in a fixed order.

- "data" (dp rows of the grid): a batch's rows split over the data groups,
  and the decode pool's slots.
- "model" (tp columns): the attention heads and the MLP width of each layer
  (`tp.py`), and the prefix pool's KV heads.
- both axes, data-major: the corpus's row shards (`sharded_topk.py`).

Unlike a JAX mesh, `devices` may name one device more than once: several
mesh positions then share that device, each with its own slices. That is how
the CPU tests stand in for eight devices and how one card stands in for a
mesh; it proves the mesh's arithmetic and its routes, not a multi-card time.

A mesh may also span processes, as a JAX mesh over `jax.devices()` does after
`jax.distributed.initialize`: `initialize` joins the processes in a
`torch.distributed` group (gloo, over TCP), `make_global_mesh` builds the
grid of every process's positions, each with its owning rank, and
`process_allgather` is the one collective that crosses the process boundary
(a host tensor, gathered in rank order). A process addresses only its own
positions. The engine serves over a one-process mesh only; the sharded
top-k (`sharded_topk.py`) runs over either.
"""

from __future__ import annotations

import datetime
from typing import Sequence

import torch
import torch.distributed as dist

from rag_serving_system_torch import device as _device


def _indexed(device) -> torch.device:
    """`device` with its index: "cuda" names the current CUDA device, as a
    tensor's `.device` does."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A (dp, tp) grid of devices with axes ("data", "model"); position
    (g, m) is data group g, model position m. `owners` (a grid of ranks,
    default all 0) names the process that holds each position, and `rank`
    is this process's; a position's device is a device of its owner."""

    axis_names = ("data", "model")

    def __init__(self, grid: Sequence[Sequence[torch.device]],
                 owners: Sequence[Sequence[int]] | None = None, rank: int = 0):
        if not grid or not grid[0]:
            raise ValueError("a mesh needs at least one position; the device list is empty")
        self.grid = [[_indexed(d) for d in row] for row in grid]
        self.shape = {"data": len(self.grid), "model": len(self.grid[0])}
        if any(len(row) != self.shape["model"] for row in self.grid):
            raise ValueError("every data group needs the same number of model positions")
        self.owners = ([[0] * self.shape["model"] for _ in self.grid] if owners is None
                       else [list(row) for row in owners])
        self.rank = rank

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def devices(self) -> list[torch.device]:
        """Every position's device, data-major (the corpus shard order)."""
        return [d for row in self.grid for d in row]

    @property
    def lead(self) -> torch.device:
        """Position (0, 0)'s device: where a batch is staged and where
        results are gathered."""
        return self.grid[0][0]

    @property
    def process_count(self) -> int:
        return len({r for row in self.owners for r in row})

    @property
    def addressable(self) -> list[bool]:
        """Whether this process holds each position, data-major."""
        return [r == self.rank for row in self.owners for r in row]

    @property
    def local_lead(self) -> torch.device:
        """The device of this process's first position (`lead` on a mesh of
        one process): where its results are merged."""
        return next(d for d, mine in zip(self.devices, self.addressable) if mine)

    def device(self, g: int, m: int) -> torch.device:
        return self.grid[g][m]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def _grid_shape(mesh_shape: str, n: int) -> tuple[int, int]:
    if mesh_shape:
        dp, tp = (int(x) for x in mesh_shape.split(","))
    else:
        dp, tp = n, 1
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} devices")
    return dp, tp


def make_mesh(mesh_shape: str = "", devices=None) -> Mesh:
    """A ("data", "model") mesh. `mesh_shape` is "dp,tp", e.g. "4,2"; empty
    puts every device on the data axis. `devices` defaults to the device
    that `device.resolve_device()` names (TORCH_DEVICE): on CUDA every
    visible CUDA device, on the CPU one position. `devices` may repeat one
    device (see the module docstring)."""
    if devices is None:
        dev = _device.resolve_device()
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    dp, tp = _grid_shape(mesh_shape, len(devices))
    return Mesh([devices[g * tp:(g + 1) * tp] for g in range(dp)])


# the processes: counterparts of jax.distributed and multihost_utils

def initialize(coordinator_address: str, num_processes: int, process_id: int,
               timeout_s: float = 120.0) -> None:
    """Join this process to the others, as `jax.distributed.initialize`
    does: a gloo group over TCP at `coordinator_address` ("host:port", which
    process 0 serves). Every wait in the group, this one and each
    collective, gives up after `timeout_s`. Gloo moves host tensors, so two
    processes may share one card (NCCL refuses two ranks on one GPU)."""
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the group `initialize` joined."""
    dist.destroy_process_group()


def make_global_mesh(mesh_shape: str, local_devices: Sequence) -> Mesh:
    """The mesh over every process's positions, as a JAX mesh over
    `jax.devices()` after `jax.distributed.initialize`: each process passes
    its own devices (the same count in every process), and the grid holds
    them data-major in rank order, each position owned by the process that
    passed it. Call it in every process of the group."""
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, [str(_indexed(d)) for d in local_devices])
    if len({len(n) for n in names}) != 1:
        raise ValueError(f"every process needs the same number of positions: {names}")
    devices = [torch.device(d) for per_rank in names for d in per_rank]
    owners = [r for r, per_rank in enumerate(names) for _ in per_rank]
    dp, tp = _grid_shape(mesh_shape, len(devices))
    return Mesh([devices[g * tp:(g + 1) * tp] for g in range(dp)],
                owners=[owners[g * tp:(g + 1) * tp] for g in range(dp)],
                rank=dist.get_rank())


def process_allgather(tensor: torch.Tensor) -> torch.Tensor:
    """Every process's `tensor` on the host, concatenated on axis 0 in rank
    order (`multihost_utils.process_allgather(..., tiled=True)`). Every
    process passes the same shape and dtype. Outside a group: the tensor
    alone, on the host."""
    host = tensor.detach().cpu().contiguous()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return host
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, host)
    return torch.cat(parts)


def mesh_axis_sizes(mesh: Mesh) -> tuple[int, int]:
    return mesh.shape["data"], mesh.shape["model"]


def gather_to(tensors: Sequence[torch.Tensor], device) -> list[torch.Tensor]:
    """Gather to a position: each tensor copied to `device` (no copy for one
    already there)."""
    return [t.to(device) for t in tensors]


def all_reduce(partials: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of the model positions' partials, on `device`: added in
    position order, so every position that calls this on the same partials
    holds the same bits."""
    acc = partials[0].to(device)
    for p in partials[1:]:
        acc = acc + p.to(device)
    return acc
