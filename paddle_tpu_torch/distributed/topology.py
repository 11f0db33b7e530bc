"""Hybrid-parallel topology (counterpart of
``paddle_tpu/distributed/topology.py``, itself a copy of the reference
framework's ``fleet/base/topology.py``): the axis order ``["data",
"pipe", "sharding", "sep", "model"]`` laid out row-major over the ranks,
one group per axis, and the fused data x sep group over which the
gradients of a sequence-parallel step are summed.

The reference's topology is a device mesh whose axes XLA names.  Here it
is a :class:`~.process_mesh.ProcessMesh` of ``torch.distributed`` ranks:
describing it needs no process group, and the groups are made (on every
rank, in one order) the first time one is asked for, over the mesh's
``backend`` (``"gloo"`` or ``"nccl"``, given by the caller).  A group
accessor returns this rank's :class:`~.process_mesh.AxisComm` on the
axis.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np

from .process_mesh import AxisComm, ProcessMesh

__all__ = ["AXES", "CommunicateTopology", "HybridCommunicateGroup",
           "create_hybrid_group", "get_hybrid_communicate_group",
           "set_hybrid_communicate_group"]

_HCG: Optional["HybridCommunicateGroup"] = None

AXES = ["data", "pipe", "sharding", "sep", "model"]


class CommunicateTopology:
    """The rank grid (reference: ``CommunicateTopology``)."""

    def __init__(self, hybrid_group_names=None, dims=None):
        self._parallel_names = list(hybrid_group_names or AXES)
        self._dims = list(dims or [1] * len(self._parallel_names))
        self.coordinate = None
        self._world = np.arange(int(np.prod(self._dims))).reshape(self._dims)

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return int(self._world.size)

    def get_rank(self, **kwargs) -> int:
        coords = tuple(kwargs[n] for n in self._parallel_names)
        return int(self._world[coords])

    def get_coord(self, rank) -> Dict[str, int]:
        coords = np.argwhere(self._world == rank)[0]
        return dict(zip(self._parallel_names, (int(c) for c in coords)))

    def get_axis_list(self, axis_name, index) -> List[int]:
        axis = self._parallel_names.index(axis_name)
        sl = [slice(None)] * len(self._dims)
        sl[axis] = index
        return self._world[tuple(sl)].reshape(-1).tolist()

    def get_comm_list(self, axis_name) -> List[List[int]]:
        """Every rank group along ``axis_name``."""
        axis = self._parallel_names.index(axis_name)
        moved = np.moveaxis(self._world, axis, -1)
        return moved.reshape(-1, self._dims[axis]).tolist()


class HybridCommunicateGroup:
    """The groups of a topology (reference: ``HybridCommunicateGroup``),
    over ranks joined in one world."""

    def __init__(self, topology: CommunicateTopology,
                 backend: Optional[str] = None):
        self._topo = topology
        names = topology.get_hybrid_group_names()
        self._dims = {n: topology.get_dim(n) for n in names}
        self._mesh = ProcessMesh(shape=[self._dims[n] for n in names],
                                 dim_names=names, backend=backend)
        self._comms: Optional[Dict[str, AxisComm]] = None
        self._dp_sep: Optional[AxisComm] = None

    @property
    def topology(self) -> CommunicateTopology:
        return self._topo

    @property
    def mesh(self) -> ProcessMesh:
        return self._mesh

    @property
    def global_rank(self) -> int:
        import torch.distributed as dist
        return dist.get_rank() if dist.is_initialized() else 0

    def _bind(self) -> Dict[str, AxisComm]:
        """Every axis group and the fused data x sep group (collectively,
        on first use)."""
        if self._comms is not None:
            return self._comms
        import torch.distributed as dist
        comms = self._mesh.bind()
        rank = dist.get_rank()
        names = self._topo.get_hybrid_group_names()
        d, s = names.index("data"), names.index("sep")
        world = self._topo._world
        rest = [i for i in range(len(names)) if i not in (d, s)]
        for other in itertools.product(*(range(world.shape[i])
                                         for i in rest)):
            idx = [slice(None)] * len(names)
            for i, v in zip(rest, other):
                idx[i] = v
            ranks = [int(r) for r in world[tuple(idx)].reshape(-1)]
            group = dist.new_group(ranks, backend=self._mesh.backend)
            if rank in ranks:
                self._dp_sep = AxisComm("data_sep", len(ranks),
                                        ranks.index(rank), group,
                                        self._mesh.backend, ranks)
        self._comms = comms
        return comms

    def get_parallel_mode(self) -> str:
        if self._dims.get("model", 1) > 1 and self._dims.get("pipe", 1) > 1:
            return "hybrid"
        if self._dims.get("model", 1) > 1:
            return "tensor"
        if self._dims.get("pipe", 1) > 1:
            return "pipeline"
        if self._dims.get("sharding", 1) > 1:
            return "sharding"
        return "data"

    def _coord(self, name: str) -> int:
        return self._topo.get_coord(self.global_rank)[name]

    # -- per-axis accessors --------------------------------------------------
    def get_data_parallel_world_size(self) -> int:
        return self._dims.get("data", 1)

    def get_data_parallel_rank(self) -> int:
        return self._coord("data")

    def get_model_parallel_world_size(self) -> int:
        return self._dims.get("model", 1)

    def get_model_parallel_rank(self) -> int:
        return self._coord("model")

    def get_pipe_parallel_world_size(self) -> int:
        return self._dims.get("pipe", 1)

    def get_stage_id(self) -> int:
        return self._coord("pipe")

    def get_sharding_parallel_world_size(self) -> int:
        return self._dims.get("sharding", 1)

    def get_sharding_parallel_rank(self) -> int:
        return self._coord("sharding")

    def get_sep_parallel_world_size(self) -> int:
        return self._dims.get("sep", 1)

    def get_sep_parallel_rank(self) -> int:
        return self._coord("sep")

    def get_data_parallel_group(self) -> AxisComm:
        return self._bind()["data"]

    def get_model_parallel_group(self) -> AxisComm:
        return self._bind()["model"]

    def get_pipe_parallel_group(self) -> AxisComm:
        return self._bind()["pipe"]

    def get_sharding_parallel_group(self) -> AxisComm:
        return self._bind()["sharding"]

    def get_sep_parallel_group(self) -> AxisComm:
        return self._bind()["sep"]

    def get_dp_sep_parallel_group(self) -> AxisComm:
        self._bind()
        return self._dp_sep

    def get_check_parallel_group(self, sharding=False) -> AxisComm:
        return self._bind()["model"]

    def get_rank_from_stage(self, stage_id, **kwargs) -> int:
        return self._topo.get_rank(data=0, pipe=stage_id, sharding=0, sep=0,
                                   model=0)


def create_hybrid_group(dp=1, pp=1, sharding=1, sep=1, mp=1,
                        backend: Optional[str] = None
                        ) -> HybridCommunicateGroup:
    """The hybrid group of these degrees, made current; ``backend`` the
    groups' (``"gloo"`` or ``"nccl"``), needed once a group is used."""
    topo = CommunicateTopology(AXES, [dp, pp, sharding, sep, mp])
    hcg = HybridCommunicateGroup(topo, backend=backend)
    set_hybrid_communicate_group(hcg)
    return hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _HCG


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]):
    global _HCG
    _HCG = hcg
