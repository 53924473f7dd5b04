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
"""

from __future__ import annotations

from typing import Sequence

import torch


def _indexed(device) -> torch.device:
    """`device` with its index: "cuda" names the current CUDA device, as a
    tensor's `.device` does."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A (dp, tp) grid of devices with axes ("data", "model"); position
    (g, m) is data group g, model position m."""

    axis_names = ("data", "model")

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.grid = [[_indexed(d) for d in row] for row in grid]
        self.shape = {"data": len(self.grid), "model": len(self.grid[0])}
        if any(len(row) != self.shape["model"] for row in self.grid):
            raise ValueError("every data group needs the same number of model positions")

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

    def device(self, g: int, m: int) -> torch.device:
        return self.grid[g][m]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def make_mesh(mesh_shape: str = "", devices=None) -> Mesh:
    """A ("data", "model") mesh. `mesh_shape` is "dp,tp", e.g. "4,2"; empty
    puts every device on the data axis. `devices` defaults to every visible
    CUDA device, and may repeat one device (see the module docstring)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = len(devices)
    if mesh_shape:
        dp, tp = (int(x) for x in mesh_shape.split(","))
    else:
        dp, tp = n, 1
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} devices")
    return Mesh([devices[g * tp:(g + 1) * tp] for g in range(dp)])


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
