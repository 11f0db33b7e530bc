"""Memory-efficient array redistribution between meshes (counterpart of
``paddle_tpu/jit/redistribute.py``; arXiv:2112.01075).

Moving a placed parameter and optimizer tree from one mesh to another
(dp 4 -> dp 2 after losing ranks, an fsdp x tp reshape) never stages a
whole array: each rank's peak is bounded by its largest destination
slice, and only the bytes whose owner changes move at all.

Three layers, as in the reference:

1. **Plan arithmetic** (host integers, copied from the reference): a
   layout is a ``{rank: box}`` map (``box`` = per-dim ``(start, stop)``);
   :func:`plan_leaf` counts, per destination rank, the bytes already
   there (``adopted``) and the bytes that travel (``moved``); the full
   gather equivalent is ``n_dst_ranks x nbytes``.  The port's layouts
   come from a placement: :class:`Placed` (a rank's slice, its
   ``PartitionSpec`` in the port's layout and its ``ProcessMesh``) and
   :func:`spec_boxes`.
2. **Apply** (:func:`redistribute_array` / :func:`redistribute_tree`):
   every rank of the world takes part.  Each destination slice is
   ADOPTED (its rank already holds exactly that box: the tensor is kept,
   zero copies) or ASSEMBLED from the overlapping source boxes only: the
   piece a rank holds itself is copied locally, every other piece is
   sent by one holder of its box (the destination itself when it holds
   it, else the first rank that does) over point-to-point transfers of
   the world's group (``collective.exchange``, op ``redistribute``).  So
   the bytes on the wire are the plan's ``moved_bytes``, and no buffer a
   rank stages is larger than one destination slice.
3. **Live reshape** (:func:`live_reshape`): re-place a sharded
   :class:`~paddle_tpu_torch.jit.train_step.TrainStep`'s parameters and
   optimizer state (the fp32 ``master`` leaf with the moments) onto
   another mesh in place — the optimizer's state dicts keep their
   identity, each leaf swapped for its new slice — then rebuild the step
   there, which finds every state leaf at its new shape.  The new mesh is
   the first ``size`` ranks of the world; the ranks outside it hand over
   their slices and get None back.

``redistribute_bytes_total{kind=moved|full_gather_equiv}`` records every
apply.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["LeafPlan", "RedistributionPlan", "Placed", "normalize_index",
           "box_nelems", "box_overlap", "spec_box", "spec_boxes",
           "is_owner", "plan_leaf", "redistribute_array",
           "redistribute_tree", "live_reshape"]

Box = Tuple[Tuple[int, int], ...]


# ---------------------------------------------------------------------------
# plan arithmetic (host integers)
# ---------------------------------------------------------------------------
def normalize_index(index, shape) -> Box:
    """An index (a tuple of slices, possibly fewer than ndim, with None
    endpoints) as concrete per-dim ``(start, stop)`` pairs."""
    index = tuple(index)
    out = []
    for d, n in enumerate(shape):
        if d < len(index):
            s = index[d]
            start = 0 if s.start is None else int(s.start)
            stop = int(n) if s.stop is None else int(s.stop)
        else:
            start, stop = 0, int(n)
        out.append((start, stop))
    return tuple(out)


def box_nelems(box: Box) -> int:
    n = 1
    for start, stop in box:
        n *= max(0, stop - start)
    return n


def box_overlap(a: Box, b: Box) -> Optional[Box]:
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


@dataclass
class LeafPlan:
    """Byte accounting for one array's move between two layouts (the
    reference's fields): ``moved_bytes`` every destination byte whose
    source lives on another rank, ``adopted_bytes`` the bytes each
    destination rank already holds, ``full_gather_equiv_bytes`` every
    destination rank materializing the whole array, and
    ``max_dst_shard_bytes`` the largest staging buffer any rank allocates
    (an adopted slice stages nothing)."""
    key: str
    shape: Tuple[int, ...]
    itemsize: int
    nbytes: int
    n_dst_devices: int
    moved_bytes: int
    adopted_bytes: int
    full_gather_equiv_bytes: int
    max_dst_shard_bytes: int

    @property
    def unchanged(self) -> bool:
        return self.moved_bytes == 0


def plan_leaf(key: str, shape, itemsize: int,
              src_map: Dict[Any, Box], dst_map: Dict[Any, Box]
              ) -> LeafPlan:
    """Decompose ``dst_map`` against ``src_map`` (keys: hashable ranks or
    devices, comparable across the two maps)."""
    shape = tuple(int(s) for s in shape)
    itemsize = int(itemsize)
    nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize if shape \
        else itemsize
    moved = adopted = 0
    max_dst = 0
    for dev, box in dst_map.items():
        want = box_nelems(box) * itemsize
        local_box = src_map.get(dev)
        local = 0
        if local_box is not None:
            ov = box_overlap(box, local_box)
            if ov is not None:
                local = box_nelems(ov) * itemsize
        if local_box != box:
            max_dst = max(max_dst, want)
        adopted += local
        moved += want - local
    return LeafPlan(key=key, shape=shape, itemsize=itemsize,
                    nbytes=nbytes, n_dst_devices=len(dst_map),
                    moved_bytes=moved, adopted_bytes=adopted,
                    full_gather_equiv_bytes=len(dst_map) * nbytes,
                    max_dst_shard_bytes=max_dst)


@dataclass
class RedistributionPlan:
    """Tree-level rollup of :class:`LeafPlan` accounting.  An apply also
    records what this rank did: ``rank_sent_bytes`` (the payload it
    sent) and ``rank_host_staged_bytes`` (each leaf's host memory that
    its exchange staged: what ``collective.exchange`` copied through the
    host, a CUDA tensor on gloo)."""
    leaves: List[LeafPlan] = field(default_factory=list)
    # key -> (src_map, dst_map) of each leaf an apply planned
    maps: Dict[str, tuple] = field(default_factory=dict)
    rank_sent_bytes: int = 0
    rank_host_staged_bytes: Dict[str, int] = field(default_factory=dict)

    def add(self, leaf: LeafPlan) -> None:
        self.leaves.append(leaf)

    @property
    def moved_bytes(self) -> int:
        return sum(p.moved_bytes for p in self.leaves)

    @property
    def adopted_bytes(self) -> int:
        return sum(p.adopted_bytes for p in self.leaves)

    @property
    def full_gather_equiv_bytes(self) -> int:
        return sum(p.full_gather_equiv_bytes for p in self.leaves)

    @property
    def per_chip_peak_bytes(self) -> int:
        """Largest buffer any one rank stages: leaves move one at a
        time, so the peak is the largest destination slice."""
        return max((p.max_dst_shard_bytes for p in self.leaves),
                   default=0)

    @property
    def full_gather_peak_bytes(self) -> int:
        return max((p.nbytes for p in self.leaves), default=0)

    def summary(self) -> Dict[str, Any]:
        fg = self.full_gather_equiv_bytes
        return {
            "leaves": len(self.leaves),
            "moved_bytes": self.moved_bytes,
            "adopted_bytes": self.adopted_bytes,
            "full_gather_equiv_bytes": fg,
            "moved_over_full_gather": (self.moved_bytes / fg) if fg
            else 0.0,
            "per_chip_peak_bytes": self.per_chip_peak_bytes,
            "full_gather_peak_bytes": self.full_gather_peak_bytes,
        }


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------
class Placed:
    """This rank's slice ``local`` of a value laid out over ``mesh`` (a
    ``ProcessMesh``) by ``spec`` (a ``PartitionSpec`` in the port's
    layout; ``P()`` = the whole value on every rank)."""

    __slots__ = ("local", "spec", "mesh")

    def __init__(self, local, spec, mesh):
        self.local = local
        self.spec = tuple(spec)
        self.mesh = mesh

    @property
    def shape(self) -> Tuple[int, ...]:
        """The whole value's shape."""
        return global_shape(tuple(self.local.shape), self.spec,
                            self.mesh.axis_sizes())

    def __repr__(self):
        return "Placed(%s of %s, spec=%s)" % (tuple(self.local.shape),
                                              self.shape, self.spec)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def global_shape(local_shape, spec, sizes: Dict[str, int]
                 ) -> Tuple[int, ...]:
    """The whole shape of a slice of ``local_shape`` under ``spec``."""
    shape = list(local_shape)
    for dim, entry in enumerate(spec):
        for n in _names(entry):
            shape[dim] *= sizes[n]
    return tuple(shape)


def spec_box(shape, spec, sizes: Dict[str, int],
             coords: Dict[str, int]) -> Box:
    """The box of the whole ``shape`` that the rank at ``coords`` holds
    under ``spec`` (each named dim split into the product of its axes'
    sizes, major to minor, as ``spmd.shard_tensor`` slices)."""
    out = []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        part, idx = 1, 0
        for name in _names(entry):
            idx = idx * sizes[name] + coords[name]
            part *= sizes[name]
        step = int(n) // part
        out.append((idx * step, (idx + 1) * step))
    return tuple(out)


def spec_boxes(shape, spec, mesh) -> Dict[int, Box]:
    """``{rank: box}`` of every rank of ``mesh`` (ranks ``[0, size)``)."""
    sizes = mesh.axis_sizes()
    return {r: spec_box(shape, spec, sizes, mesh.coords(r))
            for r in range(mesh.size)}


def is_owner(spec, mesh, rank: int) -> bool:
    """Whether ``rank`` writes its slice of a value placed by ``spec``:
    one writer per box, the rank at coordinate 0 on every axis the spec
    does not shard over (a rank outside the mesh writes nothing)."""
    if not mesh.holds(rank):
        return False
    named = set(a for e in spec for a in _names(e))
    coords = mesh.coords(rank)
    return all(c == 0 for a, c in coords.items() if a not in named)


def _piece(t: torch.Tensor, box: Box, origin: Box) -> torch.Tensor:
    """The view of ``t`` (which holds ``origin``) at ``box``."""
    for dim, ((lo, hi), (o0, _)) in enumerate(zip(box, origin)):
        t = t.narrow(dim, lo - o0, hi - lo)
    return t


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------
def _transfers(src_map: Dict[int, Box], dst_map: Dict[int, Box]):
    """The moves of one leaf, in one order every rank computes alike:
    ``(dst, box, [(holder, piece box, holder's box)])`` for each
    destination rank that does not adopt its box."""
    out = []
    for d, box in dst_map.items():
        if src_map.get(d) == box:
            continue
        distinct: Dict[Box, int] = {}
        for r, sbox in src_map.items():
            if sbox not in distinct or r == d:
                distinct[sbox] = r
        pieces = []
        for sbox, holder in distinct.items():
            ov = box_overlap(box, sbox)
            if ov is not None:
                pieces.append((holder, ov, sbox))
        out.append((d, box, pieces))
    return out


def redistribute_array(local: Optional[torch.Tensor], shape, dtype,
                       src_map: Dict[int, Box], dst_map: Dict[int, Box],
                       key: str = "array", group=None,
                       plan: Optional[RedistributionPlan] = None):
    """Move one array from the layout ``src_map`` to ``dst_map`` (global
    ranks to boxes of the whole ``shape``); ``local`` is this rank's slice
    under ``src_map`` (None when it holds none).  Collective over
    ``group`` (default: the world): every rank calls it for the same
    leaf.  Returns ``(this rank's new slice or None, LeafPlan)``."""
    import torch.distributed as dist
    from ..distributed import collective as C
    dtype = local.dtype if local is not None else dtype
    itemsize = torch.empty((), dtype=dtype).element_size()
    leaf = plan_leaf(key, shape, itemsize, src_map, dst_map)
    me = dist.get_rank() if dist.is_initialized() else 0
    device = local.device if local is not None else "cpu"
    mine = src_map.get(me)
    out: Optional[torch.Tensor] = None
    if dst_map.get(me) is not None and dst_map[me] == mine:
        out = local                               # adopt: zero copies
    sends, recvs, later = [], [], []
    for d, box, pieces in _transfers(src_map, dst_map):
        if d == me:
            out = torch.empty([hi - lo for lo, hi in box], dtype=dtype,
                              device=device)
        for holder, ov, sbox in pieces:
            if holder == d == me:
                _piece(out, ov, box).copy_(_piece(local, ov, sbox))
            elif holder == me:
                sends.append((_piece(local, ov, sbox).contiguous(), d))
            elif d == me:
                view = _piece(out, ov, box)
                if not view.is_contiguous():
                    tmp = torch.empty(view.shape, dtype=dtype,
                                      device=device)
                    later.append((view, tmp))
                    view = tmp
                recvs.append((view, holder))
    host = 0
    if sends or recvs:
        host = C.exchange(sends, recvs, group, op="redistribute")
    for view, tmp in later:
        view.copy_(tmp)
    if plan is not None:
        plan.rank_sent_bytes += sum(t.numel() * itemsize for t, _ in sends)
        plan.rank_host_staged_bytes[key] = host
    return out, leaf


_METRIC_HELP = (
    "array-redistribution traffic per live mesh reshape, by kind: "
    "'moved' = bytes whose owning rank changed (the only bytes that "
    "cross ranks), 'full_gather_equiv' = what the checkpoint round trip "
    "/ naive all-gather restore would have staged (n_dst_ranks x full "
    "array)")


def _bytes_counter(registry=None):
    from ..observability import default_registry
    r = registry if registry is not None else default_registry()
    return r.counter("redistribute_bytes_total", _METRIC_HELP,
                     labels=("kind",))


def redistribute_tree(arrays: Dict[str, Placed],
                      targets: Dict[str, Tuple[tuple, Any]],
                      registry=None, publish: bool = True, group=None):
    """Redistribute ``{key: Placed}`` onto ``targets`` (``{key: (spec,
    mesh)}``, port layout), one leaf at a time, collectively on every
    rank of the world (a rank outside a source mesh passes a
    ``Placed`` whose mesh does not hold it).  Returns ``({key: new local
    slice or None}, RedistributionPlan)`` and (by default) publishes the
    byte counts to ``redistribute_bytes_total``."""
    plan = RedistributionPlan()
    out = {}
    for k, v in arrays.items():
        spec, mesh = targets[k]
        shape = v.shape
        src_map = spec_boxes(shape, v.spec, v.mesh)
        dst_map = spec_boxes(shape, spec, mesh)
        new, leaf = redistribute_array(v.local, shape, v.local.dtype,
                                       src_map, dst_map, key=k,
                                       group=group, plan=plan)
        plan.add(leaf)
        plan.maps[k] = (src_map, dst_map)
        out[k] = new
    if publish:
        c = _bytes_counter(registry)
        c.labels(kind="moved").inc(plan.moved_bytes)
        c.labels(kind="full_gather_equiv").inc(
            plan.full_gather_equiv_bytes)
    return out, plan


# ---------------------------------------------------------------------------
# live TrainStep reshape
# ---------------------------------------------------------------------------
def _target_specs(step, mesh, axis):
    """The new mesh's placement of every parameter and optimizer-state
    leaf, by the rules the rebuilt step's set-up applies: the 1D rows
    (``P(axis)`` for a parameter-shaped leaf of a parameter whose dim 0
    the degree divides) or the 2-D ``llama_param_specs`` placement."""
    from .spmd import (P, SpecLayout, llama_param_specs, port_spec,
                       reference_shapes, spec_axes)
    params = dict(step._params)
    full = {k: step._full_shape(k, p) for k, p in step._params}
    param_spec: Dict[str, tuple] = {k: P() for k in full}
    if step._mode == "2d":
        sizes = mesh.axis_sizes()
        layout = SpecLayout(tp_axis="tp" if sizes.get("tp", 1) > 1
                            else None, fsdp_axis="fsdp")
        specs = llama_param_specs(list(full), layout,
                                  shapes=reference_shapes(full), mesh=mesh)
        for k in full:
            if bool(spec_axes(specs[k])) and \
                    step._state_param_shaped(k, params[k]):
                param_spec[k] = port_spec(k, specs[k])
        leaf_ok = dict(param_spec)
    else:
        deg = mesh.axis_sizes()[axis]
        leaf_ok = {k: (P(axis) if len(full[k]) >= 1
                       and full[k][0] % deg == 0
                       and step._state_param_shaped(k, params[k])
                       else P()) for k in full}
    leaf_spec = {}
    old_specs = step.leaf_specs()
    sizes = step._mesh.axis_sizes()
    for k, _ in step._params:
        for name, v in step.optimizer.state(k).items():
            key = "opt.%s.%s" % (k, name)
            whole = global_shape(tuple(v.shape), old_specs[key], sizes)
            leaf_spec[key] = (leaf_ok[k] if v.dim() >= 1
                              and whole == full[k] else P())
    return param_spec, leaf_spec, full


def live_reshape(step, mesh, registry=None):
    """Re-place ``step``'s parameters and optimizer state onto ``mesh``
    rank to rank (no checkpoint, no whole-array staging) and rebuild the
    TrainStep there; collective over the world.  Returns ``(new_step,
    plan)``, ``new_step`` None on a rank outside ``mesh``."""
    from ..distributed.process_mesh import as_mesh
    from .spmd import ShardingConfig, resolve_mesh_axis
    from .train_step import TrainStep

    if step._mode not in ("1d", "2d"):
        raise ValueError(
            "live_reshape needs a sharded TrainStep (a replicated step "
            "has no placement to move — just rebuild it)")
    cfg = step._cfg
    pm = as_mesh(mesh)
    if step._mode == "2d":
        if "fsdp" not in pm.dim_names:
            raise ValueError(
                "reshaping a 2D (fsdp x tp) TrainStep needs a mesh "
                "with an 'fsdp' axis; got %r" % (tuple(pm.dim_names),))
        axis = None
    else:
        pm, axis, deg = resolve_mesh_axis(
            pm, cfg.axis, -1, candidates=("dp", "sharding", "data"))
        if deg <= 1:
            raise ValueError(
                "live_reshape target mesh is degenerate (axis size 1); "
                "rebuild a replicated TrainStep instead")
    import torch.distributed as dist
    rank = dist.get_rank()
    pm.make_groups()                    # collective over the world
    param_spec, leaf_spec, full = _target_specs(step, pm, axis)
    old = step._mesh
    src_param = step._specs if step._mode == "2d" else {}
    from .spmd import P
    arrays, targets = {}, {}
    for k, p in step._params:
        arrays["model." + k] = Placed(p.data, src_param.get(k, P()), old)
        targets["model." + k] = (param_spec[k], pm)
    specs = step.leaf_specs()
    for key, v in step.opt_state_arrays().items():
        arrays[key] = Placed(v, specs[key], old)
        targets[key] = (leaf_spec[key], pm)
    with torch.no_grad():
        moved, plan = redistribute_tree(arrays, targets, registry=registry)
        for k, p in step._params:
            new = moved["model." + k]
            p.data = new if new is not None else p.data.new_empty(0)
        for k, _ in step._params:
            st = step.optimizer.state(k)     # the optimizer's own dict
            for name in list(st):
                new = moved["opt.%s.%s" % (k, name)]
                st[name] = new if new is not None else st[name].new_empty(0)
    if not pm.holds(rank):
        return None, plan
    cfg2 = cfg if step._mode == "2d" else ShardingConfig(
        stage=cfg.stage, degree=-1, axis=axis, bucket_mb=cfg.bucket_mb,
        loss_reduction=cfg.loss_reduction)
    new_step = TrainStep(step.model, step.criterion, step.optimizer,
                         clip_norm=step.clip_norm, mesh=pm, sharding=cfg2,
                         placed_shapes=full if step._mode == "2d" else None)
    return new_step, plan
