"""The (data, model) mesh of the ranks (the port of the JAX package's
``core/mesh.py``, there a ``jax.sharding.Mesh`` of devices).

Rank r sits at (d, m) = divmod(r, n_model): the row-major layout of JAX
``make_mesh``'s ``reshape(n_data, n_model)``. A rank's data group holds
the ranks of its model column (the same m, every d): the batch is split
over it. Its model group holds the ranks of its data row (the same d,
every m): a tensor- or spatially-sharded layer is split over it. Every
rank makes every group, in one order (``dist.new_group`` is a collective
of the whole world), and keeps its own two. A group of one rank is a real
group too: its collectives are the identity (an all-gather a copy), and a
mesh of one rank still runs them, as the data-parallel path does.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass
class Mesh:
    n_data: int
    n_model: int
    d: int            # this rank's place on the data axis
    m: int            # and on the model axis
    data_group: object
    model_group: object
    world_group: object  # every rank of the mesh

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}


def make_mesh(n_data: int, n_model: int) -> Mesh:
    """The mesh of ``n_data * n_model`` ranks, the world of the default
    process group (which must hold exactly that many), seen from this
    process's rank. Every rank of the world calls it."""
    world = dist.get_world_size()
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} "
                         f"ranks, the group has {world}")
    d, m = divmod(dist.get_rank(), n_model)
    data_group = model_group = None
    for col in range(n_model):  # the data groups, one a model column
        g = dist.new_group([row * n_model + col for row in range(n_data)])
        if col == m:
            data_group = g
    for row in range(n_data):  # the model groups, one a data row
        g = dist.new_group([row * n_model + col for col in range(n_model)])
        if row == d:
            model_group = g
    return Mesh(n_data, n_model, d, m, data_group, model_group, dist.group.WORLD)


def data_axis_size(mesh: Mesh | None) -> int:
    return 1 if mesh is None else mesh.n_data
