"""Hybrid topology of the port (``paddle_tpu/distributed/topology.py``;
parity: python/paddle/distributed/fleet/base/topology.py,
CommunicateTopology:52 and HybridCommunicateGroup:134).

The reference lays its devices on a ``jax.sharding.Mesh`` with the axes
``AXES`` and lets XLA's partitioner emit the collectives over them. The
port lays the world's ranks on the same grid, in the same order (rank r
sits at ``np.unravel_index(r, dims)`` of ``(dp, pp, sdp, mp, sep)``), and
builds one ``torch.distributed`` process group per slice of each axis:
every rank calls ``new_group`` for every slice, in the same order, and
keeps the :class:`~paddle_tpu_torch.distributed.collective.Group` of the
slices it sits in. Two more kinds of group have no axis of their own:
``"data"``, the ranks that differ only in their ``dp`` and ``sdp``
coordinates (the batch is split over them and the gradients averaged over
them, as the reference's ``P(("dp", "sdp"))`` batch spec has it), and
``"pp_ends"``, the first and the last stage of each pipeline (they both
hold GPT's tied word table, whose gradient is their sum). At a sequence
degree above 1 a third, ``"data_sep"``, holds the ranks that differ only in
their ``dp``, ``sdp`` and ``sep`` coordinates: each ``sep`` rank holds other
tokens of the same rows, so a replicated parameter's gradient is summed
over ``sep`` and averaged over the data axes in one all-reduce over it.
The expert group of a mixture of experts is the ``dp`` group, as the
reference's default ``expert_axis="dp"`` has it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .collective import Group, new_group
from .env import get_rank, get_world_size

AXES = ("dp", "pp", "sdp", "mp", "sep")


class CommunicateTopology:
    """The rank grid: ``dims`` along ``hybrid_group_names``, ranks in C
    order."""

    def __init__(self, hybrid_group_names: Sequence[str] = AXES, dims: Sequence[int] = (1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    def world_size(self):
        return int(np.prod(self._dims))

    def get_coord(self, rank):
        """The grid coordinates of ``rank``, one per axis."""
        return tuple(int(c) for c in np.unravel_index(rank, self._dims))

    def get_comm_list(self, axis_name):
        """Every slice along ``axis_name`` (or along several axes at once, a
        tuple, the first the slowest): lists of ranks that differ only in
        those coordinates, in rank order."""
        names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        axes = [self._parallel_names.index(a) for a in names]
        grid = np.moveaxis(np.arange(self.world_size()).reshape(self._dims), axes,
                           list(range(-len(axes), 0)))
        size = int(np.prod([self._dims[a] for a in axes]))
        return [[int(r) for r in row] for row in grid.reshape(-1, size)]


class HybridCommunicateGroup:
    """The world's ranks on the hybrid grid, with one process group per
    axis for this rank, and the paddle fleet accessors
    (fleet/base/topology.py:169-260). The degrees' product must be the
    world size."""

    def __init__(self, dp_degree=1, mp_degree=1, pp_degree=1, sharding_degree=1, sep_degree=1):
        self.dims = (int(dp_degree), int(pp_degree), int(sharding_degree), int(mp_degree),
                     int(sep_degree))
        world = get_world_size()
        if int(np.prod(self.dims)) != world:
            raise ValueError(f"hybrid degrees {dict(zip(AXES, self.dims))} multiply to "
                             f"{int(np.prod(self.dims))}, but the world has {world} ranks")
        self.topo = CommunicateTopology(AXES, self.dims)
        self.global_rank = get_rank()
        self.coord = self.topo.get_coord(self.global_rank)
        self._groups = {}
        slices = [(axis, self.topo.get_comm_list(axis)) for axis in AXES]
        slices.append(("data", self.topo.get_comm_list(("dp", "sdp"))))
        slices.append(("pp_ends", [sorted({r[0], r[-1]}) for r in self.topo.get_comm_list("pp")]))
        if self.dims[4] > 1:
            slices.append(("data_sep", self.topo.get_comm_list(("dp", "sdp", "sep"))))
        for name, lists in slices:
            for ranks in lists:  # every rank, every slice, same order
                group = new_group(ranks, axis_name=name)
                if self.global_rank in ranks:
                    self._groups[name] = group

    def group(self, axis) -> Group:
        """This rank's group along ``axis`` (or ``"data"``, ``"pp_ends"``,
        ``"data_sep"``)."""
        return self._groups[axis]

    def get_pp_ends_group(self):
        """The first and the last stage of this rank's pipeline, or None on
        a stage between them."""
        return self._groups.get("pp_ends")

    def get_data_sharding_group(self):
        """The ranks over which the batch is split: ``dp`` x ``sdp``."""
        return self._groups["data"]

    def get_data_sep_group(self):
        """The ranks over which a replicated parameter's gradient is summed:
        ``dp`` x ``sdp`` x ``sep`` (the data group at sep 1)."""
        return self._groups.get("data_sep", self._groups["data"])

    # -- paddle fleet accessors ---------------------------------------------
    def get_data_parallel_world_size(self):
        return self.dims[0]

    def get_pipe_parallel_world_size(self):
        return self.dims[1]

    def get_sharding_parallel_world_size(self):
        return self.dims[2]

    def get_model_parallel_world_size(self):
        return self.dims[3]

    def get_sep_parallel_world_size(self):
        return self.dims[4]

    def get_data_parallel_rank(self):
        return self.coord[0]

    def get_pipe_parallel_rank(self):
        return self.coord[1]

    def get_sharding_parallel_rank(self):
        return self.coord[2]

    def get_model_parallel_rank(self):
        return self.coord[3]

    def get_sep_parallel_rank(self):
        return self.coord[4]

    def get_data_parallel_group(self):
        return self._groups["dp"]

    def get_pipe_parallel_group(self):
        return self._groups["pp"]

    def get_sharding_parallel_group(self):
        return self._groups["sdp"]

    def get_model_parallel_group(self):
        return self._groups["mp"]

    def get_sep_parallel_group(self):
        return self._groups["sep"]


def build_mesh(dp=1, mp=1, pp=1, sdp=1, sep=1) -> HybridCommunicateGroup:
    """The world's ranks on the grid of these degrees (the reference returns
    its device mesh)."""
    return HybridCommunicateGroup(dp, mp, pp, sdp, sep)
