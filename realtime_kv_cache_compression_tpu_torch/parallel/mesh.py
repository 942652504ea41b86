"""Rank meshes over a `torch.distributed` world.

Port of the JAX package's `parallel/mesh.py`. A JAX mesh names the axes
of one process's device grid; here the world's ranks (one process each)
are laid out row-major on a (data, model) grid, and each axis carries the
process group of the ranks that share this rank's other coordinate:
  data  — batch / data parallelism;
  model — tensor parallelism over heads, MLP hidden and vocab;
  pipe  — pipeline stages, contiguous layer ranges (`pipeline.py`).
A one-rank axis carries no group (None): the collectives of
`comm.py` then issue nothing. Every rank must build the same
meshes in the same order (`torch.distributed.new_group` is collective).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a grid of ranks: `shape` and `coords` by axis
    name (in `axis_names` order), and per axis the group of the ranks
    that differ from this one only along it (None on a one-rank axis)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[object]]

    def group(self, axis: str):
        return self.groups[axis]


def world_size() -> int:
    """Ranks in the default group; 1 when none is initialised."""
    return dist.get_world_size() if dist.is_initialized() else 1


def grid_mesh(axis_names: Tuple[str, ...], sizes: Tuple[int, ...]) -> Mesh:
    """A mesh of the world's ranks, row-major over `sizes` (whose product
    must be the world size)."""
    n = world_size()
    total = 1
    for size in sizes:
        total *= size
    if total != n:
        raise ValueError(f"mesh {'x'.join(map(str, sizes))} != {n} ranks")
    rank = dist.get_rank() if dist.is_initialized() else 0
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    coords = [rank // strides[i] % sizes[i] for i in range(len(sizes))]
    groups = {}
    for axis, (name, size) in enumerate(zip(axis_names, sizes)):
        groups[name] = None
        if size == 1:
            continue
        # One group per line of ranks along this axis; every rank creates
        # every group, in the same order, and keeps its own.
        lines = {}
        for r in range(n):
            key = tuple(r // strides[i] % sizes[i]
                        for i in range(len(sizes)) if i != axis)
            lines.setdefault(key, []).append(r)
        for ranks in lines.values():
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = g
    return Mesh(axis_names=tuple(axis_names),
                shape=dict(zip(axis_names, sizes)),
                coords=dict(zip(axis_names, coords)), groups=groups)


def create_mesh(data: Optional[int] = None,
                model: Optional[int] = None) -> Mesh:
    """A (data, model) mesh over the world's ranks.

    Defaults: every rank on the model axis when both are unset; otherwise
    the unset one is the world size over the set one.
    """
    n = world_size()
    if data is None and model is None:
        data, model = 1, n
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    return grid_mesh((DATA_AXIS, MODEL_AXIS), (data, model))


def single_device_mesh() -> Mesh:
    """A 1 x 1 mesh: no group on either axis (this rank alone)."""
    return Mesh(axis_names=(DATA_AXIS, MODEL_AXIS),
                shape={DATA_AXIS: 1, MODEL_AXIS: 1},
                coords={DATA_AXIS: 0, MODEL_AXIS: 0},
                groups={DATA_AXIS: None, MODEL_AXIS: None})


def create_pipe_mesh(n: Optional[int] = None) -> Mesh:
    """A one-axis `pipe` mesh over the world's n ranks (default: all of
    them); rank r is stage r."""
    return grid_mesh((PIPE_AXIS,), (world_size() if n is None else n,))
