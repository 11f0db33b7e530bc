"""A mesh of ``torch.distributed`` ranks with named axes (counterpart of
``paddle_tpu/distributed/process_mesh.py`` ``ProcessMesh`` and
``as_jax_mesh``).

The reference's mesh is a grid of devices that one controller drives.
The port's is a grid of ranks, one process each, laid out row-major over
``shape`` (rank ``r`` sits at ``np.unravel_index(r, shape)``, as the
reference lays devices out).  Describing a mesh needs no process group:
``ProcessMesh(shape, dim_names, backend=...)`` only records it, so an
engine can validate a mesh before any rank exists.  :meth:`ProcessMesh.
bind` then creates, collectively on every rank and in the same order, one
data group per axis (the ranks that share every other coordinate) over
the mesh's ``backend`` — ``"gloo"`` or ``"nccl"``, always given by the
caller — and returns this rank's :class:`AxisComm` per axis.  The
world's default group, made by :func:`init_world`, is the gloo control
group on host tensors.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import collective as C

__all__ = ["ProcessMesh", "AxisComm", "init_world", "as_mesh"]

_BACKENDS = ("gloo", "nccl")


def init_world(rank: int, world_size: int, init_method: str) -> None:
    """Join the world: the default process group, gloo, the control group
    of every mesh.  Its address (``file://<path>`` as ``launch.run_world``
    gives it, or ``tcp://localhost:<port>``), rank and size are given
    explicitly: nothing on the machine announces a cluster."""
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world_size)


class AxisComm:
    """This rank's view of one mesh axis: the axis ``name``, its ``size``,
    this rank's ``index`` along it, the global ``ranks`` of its group in
    axis order, and the collectives over the axis's data group."""

    def __init__(self, name: str, size: int, index: int, group,
                 backend: str, ranks: Sequence[int]):
        self.name = name
        self.size = int(size)
        self.index = int(index)
        self.group = group
        self.backend = backend
        self.ranks = [int(r) for r in ranks]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return C.all_reduce(t, self.group)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        return C.all_reduce_max(t, self.group)

    def all_gather(self, t: torch.Tensor, dim: int = 0,
                   op: str = "all_gather") -> torch.Tensor:
        return C.all_gather(t, dim, self.group, self.size, op)

    def all_gather_rows(self, out: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
        """Every rank's 1-D ``t`` into the rows of ``out`` [size, n]."""
        return C.all_gather_rows(out, t, self.group,
                                 "%s_gather" % self.name)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        return C.all_to_all(t, self.group)

    def reduce_scatter(self, flat: torch.Tensor,
                       op: str = "reduce_scatter") -> torch.Tensor:
        """``flat`` [size, cols] summed over the axis; this rank's row."""
        return C.reduce_scatter(flat, self.group, op)

    def shift(self, t: torch.Tensor, op: str = "shift") -> torch.Tensor:
        """``t`` to the next rank of the axis; the previous rank's back."""
        return C.shift(t, self.group, self.ranks, self.index, op)

    def __repr__(self):
        return ("AxisComm(%r, size=%d, index=%d, backend=%r)"
                % (self.name, self.size, self.index, self.backend))


class ProcessMesh:
    """``shape`` ranks laid out row-major under ``dim_names``; ``backend``
    the data groups' backend (``"gloo"`` or ``"nccl"``; needed only to
    :meth:`bind`)."""

    def __init__(self, shape: Sequence[int],
                 dim_names: Optional[Sequence[str]] = None,
                 backend: Optional[str] = None):
        self._shape = [int(s) for s in shape]
        if dim_names is None:
            dim_names = ["d%d" % i for i in range(len(self._shape))]
        if len(dim_names) != len(self._shape):
            raise ValueError("ProcessMesh: %d dim_names for a %d-D shape"
                             % (len(dim_names), len(self._shape)))
        if backend is not None and backend not in _BACKENDS:
            raise ValueError("ProcessMesh backend must be one of %s; got %r"
                             % (_BACKENDS, backend))
        self._dim_names = list(dim_names)
        self.backend = backend
        self._comms: Optional[Dict[str, AxisComm]] = None

    @property
    def shape(self) -> List[int]:
        return list(self._shape)

    @property
    def dim_names(self) -> List[str]:
        return list(self._dim_names)

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def size(self) -> int:
        return int(np.prod(self._shape)) if self._shape else 1

    def axis_sizes(self) -> Dict[str, int]:
        """``{axis name: size}`` (the reference's ``jax_mesh.shape``)."""
        return dict(zip(self._dim_names, self._shape))

    def get_dim_size(self, name: str) -> int:
        return self.axis_sizes()[name]

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s coordinate along each axis."""
        idx = np.unravel_index(int(rank), self._shape)
        return {n: int(i) for n, i in zip(self._dim_names, idx)}

    def bind(self) -> Dict[str, AxisComm]:
        """Create the per-axis data groups (collectively: every rank of the
        world calls this for the same mesh, in the same order) and return
        this rank's :class:`AxisComm` per axis.  Idempotent per mesh."""
        if self._comms is not None:
            return self._comms
        if self.backend is None:
            raise ValueError(
                "ProcessMesh.bind needs the data groups' backend: construct "
                "the mesh with backend='nccl' (one card per rank) or "
                "backend='gloo' (ranks sharing one card, or the CPU)")
        if not dist.is_initialized():
            raise RuntimeError(
                "a %s mesh needs %d torch.distributed ranks, and this "
                "process joined no world: start every rank with "
                "paddle_tpu_torch.distributed.launch (or call "
                "process_mesh.init_world) first" % (self._shape, self.size))
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(
                "mesh %s holds %d ranks but the world has %d"
                % (dict(zip(self._dim_names, self._shape)), self.size, world))
        rank = dist.get_rank()
        grid = np.arange(self.size).reshape(self._shape)
        comms = {}
        for ax, name in enumerate(self._dim_names):
            other = [range(s) for i, s in enumerate(self._shape) if i != ax]
            mine = None
            # every rank creates every group, in one order
            for rest in itertools.product(*other):
                idx = list(rest)
                idx.insert(ax, slice(None))
                ranks = [int(r) for r in grid[tuple(idx)].reshape(-1)]
                group = dist.new_group(ranks, backend=self.backend)
                if rank in ranks:
                    mine = AxisComm(name, self._shape[ax],
                                    ranks.index(rank), group, self.backend,
                                    ranks)
            comms[name] = mine
        self._comms = comms
        return comms

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and other._shape == self._shape
                and other._dim_names == self._dim_names)

    def __hash__(self):
        return hash((tuple(self._shape), tuple(self._dim_names)))

    def __repr__(self):
        return ("ProcessMesh(shape=%s, dim_names=%s, backend=%r)"
                % (self._shape, self._dim_names, self.backend))


def as_mesh(mesh) -> ProcessMesh:
    """The counterpart of ``as_jax_mesh``: a :class:`ProcessMesh` as it
    is; anything else raises."""
    if isinstance(mesh, ProcessMesh):
        return mesh
    raise TypeError("expected a paddle_tpu_torch ProcessMesh, got %r"
                    % type(mesh).__name__)
