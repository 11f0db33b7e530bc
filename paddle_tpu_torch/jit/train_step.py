"""The training step (counterpart of ``paddle_tpu/jit/train_step.py``).

    step = TrainStep(model, criterion, optimizer, clip_norm=1.0)
    loss = step(input_ids, labels)

``model`` is a ``torch.nn.Module`` (the models of ``models/``) or a
paddle-API ``nn.Layer`` with a criterion over API tensors (``ResNet`` with
``lambda logits, labels: F.cross_entropy(logits, labels)`` and
``optimizer.Momentum``: the reference's construction).

One call runs the forward and the loss (fp32), the backward, the global
gradient-norm clip (``scale = clip / max(||g||, clip)`` with the norm in
fp32, each gradient scaled in fp32 and cast back to its own dtype), the
optimizer's in-place update of every parameter, and clears the gradients.
The reference traces all of it into one XLA module; the port runs it
eagerly (a CUDA-graph capture of the step is later work).

The sharded forms run one process a rank (``distributed/process_mesh``),
each given the same global batch and model:

- ``mesh=`` a mesh with a ``dp`` (or ``sharding``, ``data``) axis and
  ``sharding=ShardingConfig(stage=1|2)``: ZeRO weight-update sharding
  (Xu et al., arXiv:2004.13336; reference ``_setup_sharded`` and
  ``_build_sharded``).  Each rank computes on its dp slice of the batch;
  the gradients of the parameters whose dim 0 the degree divides (and
  whose optimizer state is parameter-shaped) are packed by dtype into
  buckets of at most ``bucket_mb``, one ``reduce_scatter`` a bucket
  (stage 2) or an ``all_reduce`` and this rank's row (stage 1); the rest
  take one coalesced ``all_reduce`` a dtype.  The clip norm sums the
  sharded squares over the axis and counts the replicated ones once; the
  update runs on this rank's rows with state created at the rows' shape,
  then one ``all_gather`` a bucket re-assembles the bucket's parameters.
- ``mesh=`` a mesh with an ``fsdp`` axis (``spmd.mesh_2d``): fsdp x tp
  (x dp) storage (reference ``_setup_sharded_2d``, ``_build_sharded_2d``).
  Each parameter is stored at its ``llama_param_specs`` placement (ZeRO-3
  as the storage layout; the slice serving stores), gathered whole over
  every axis its spec names at the start of the step and put back after
  it; compute is batch-parallel over all ranks; the gradients go back to
  the placement by one ``reduce_scatter`` a named dim and an
  ``all_reduce`` over the other live axes; the clip norm sums squares by
  group of parameters that share a set of spec axes; the update is
  local.
- No mesh, under a hybrid group (``distributed.topology``) whose data x
  sep degree is above 1: each rank computes on its data-parallel slice of
  the batch (a sequence-parallel model then keeps its sep slice of the
  sequence), and every gradient is summed over the data x sep ranks
  before the clip (divided by the data degree: the mean over replicas).

Losses are combined as the gradients are (the mean over replicas).

Checkpoints: :meth:`TrainStep.ckpt_values` gives what a
``distributed.checkpoint.CheckpointManager`` saves (each value with its
placement), :meth:`TrainStep.load_train_state` restores one saved under
any mesh; ``jit.redistribute.live_reshape`` moves a sharded step onto
another mesh without one (its rebuilt 2-D step is given
``placed_shapes``, the whole shapes whose slices the parameters already
hold).
"""
from __future__ import annotations

import contextlib
import math
import warnings
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from ..distributed import collective as C
from ..distributed.process_mesh import as_mesh
from ..ops.moe_gate import RoutingGroup, routing_over
from ..optimizer import Optimizer
from .spmd import (P, ShardingConfig, SpecLayout, llama_param_specs,
                   port_spec, reference_shapes, resolve_mesh_axis,
                   gather_spec_axes, scatter_spec_axes, shard_tensor,
                   spec_axes)

__all__ = ["TrainStep", "ShardingConfig"]


def _not_elementwise(opt) -> ValueError:
    return ValueError(
        f"{type(opt).__name__}'s update rule is not elementwise "
        f"(cross-element reductions would be computed per shard) — use "
        f"the replicated TrainStep; its state is small anyway")


class TrainStep:
    """Model + criterion + optimizer as one step, on one device or over
    the ranks of ``mesh`` (see the module notes)."""

    def __init__(self, model: nn.Module, criterion: Callable,
                 optimizer: Optimizer, clip_norm: Optional[float] = None,
                 mesh=None, sharding: Optional[ShardingConfig] = None,
                 placed_shapes: Optional[Dict[str, tuple]] = None):
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer
        self.clip_norm = clip_norm
        # a paddle-API ``nn.Layer`` (its running statistics, BatchNorm's,
        # update in place in its forward, which is the step's); the step
        # then returns the loss as an API Tensor, as the reference's does
        self._api_model = "_api_params" in vars(model)
        self._params = [(k, p) for k, p in optimizer.params
                        if p.requires_grad]
        self._mode = None
        self._replica = None
        self._routing = None
        self._placement = None
        if sharding is not None and not isinstance(sharding,
                                                   ShardingConfig):
            raise TypeError("sharding must be a jit.spmd.ShardingConfig; "
                            "got %r" % type(sharding).__name__)
        # the 2-D step's parameters already hold this rank's slices of
        # these whole shapes (``jit.redistribute.live_reshape``)
        self._placed_shapes = placed_shapes
        # an optimizer that group_sharded_parallel marked brings its own
        # mesh and stage; an implicit marker the step cannot honor
        # degrades to the replicated step instead of failing a
        # construction that worked before
        implicit = False
        if mesh is None and sharding is None:
            marker = getattr(optimizer, "_sharded_update", None)
            if marker is not None:
                mesh, sharding = marker
                implicit = True
        if mesh is not None or sharding is not None:
            try:
                self._setup_sharded(mesh, sharding or ShardingConfig())
            except (ValueError, NotImplementedError) as e:
                if not implicit:
                    raise
                warnings.warn(
                    f"ignoring the optimizer's _sharded_update marker "
                    f"({e}); building the replicated TrainStep instead",
                    stacklevel=2)
                self._mode = None
                self._setup_hybrid()
        else:
            self._setup_hybrid()

    @property
    def global_step(self) -> int:
        return self.optimizer._global_step

    # -- set-up --------------------------------------------------------------
    def _setup_hybrid(self) -> None:
        """The gradient sum of a plain step over a hybrid group: the data
        x sep ranks for a sequence-parallel model, the data ranks for any
        other (its sep ranks compute the same thing)."""
        from ..distributed.topology import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        if hcg is None:
            return
        dp = hcg.get_data_parallel_world_size()
        sep = hcg.get_sep_parallel_world_size()
        cfg = getattr(self.model, "config", None)
        seq = sep > 1 and bool(getattr(cfg, "sequence_parallel", False))
        if dp * (sep if seq else 1) <= 1:
            return
        self._mode = "hybrid"
        self._replica = (hcg.get_dp_sep_parallel_group() if seq
                         else hcg.get_data_parallel_group())
        self._dp = dp
        self._dp_index = hcg.get_data_parallel_rank()
        if getattr(cfg, "num_local_experts", 0):
            # the reference runs the hybrid step on GSPMD-global arrays:
            # its MoE blocks route the replicas' tokens as one set
            comm = self._replica
            self._routing = RoutingGroup(
                lambda t: comm.all_gather(t[None], 0), self._dp_index,
                hcg.get_sep_parallel_rank() if seq else 0, dp)

    def _setup_sharded(self, mesh, cfg: ShardingConfig) -> None:
        placement = getattr(self.model, "_ptt_ep", None)
        if placement is not None:
            if mesh is not None and as_mesh(mesh) != placement.mesh:
                raise ValueError(
                    "a shard_mixtral model trains over the mesh it was "
                    "placed on (%r), not %r" % (placement.mesh, mesh))
            self._setup_2d(placement.mesh, cfg, placement)
            return
        if mesh is not None:
            pm = as_mesh(mesh)
            if "fsdp" in pm.dim_names and pm.size > 1:
                self._setup_2d(pm, cfg)
                return
        pm, axis, deg = resolve_mesh_axis(
            mesh, cfg.axis, cfg.degree,
            candidates=("dp", "sharding", "data"))
        if deg <= 1:
            return     # degenerate: the plain step
        sizes = pm.axis_sizes()
        other = [a for a in pm.dim_names if a != axis and sizes[a] > 1]
        if other:
            raise NotImplementedError(
                f"the 1D sharded weight update composes only with pure "
                f"data parallelism; mesh has extra axes {other} — for "
                f"fsdp×tp weight sharding name the storage axis 'fsdp' "
                f"(spmd.mesh_2d) and the 2D path takes over")
        if not getattr(self.optimizer, "shardable_update", True):
            raise _not_elementwise(self.optimizer)
        self._mode = "1d"
        self._mesh = pm
        self._cfg = cfg
        self._comm = pm.bind()[axis]
        self._deg = deg
        self._idx = self._comm.index
        self._shardable: Dict[str, bool] = {}
        for k, p in self._params:
            ok = p.dim() >= 1 and p.shape[0] % deg == 0
            self._shardable[k] = ok and self._state_param_shaped(k, p)
            if self._shardable[k]:
                self.optimizer.state_for(k, self._rows(p))
            else:
                self.optimizer.state(k)
        self._buckets, self._nonshard = self._grad_buckets()

    def _setup_2d(self, pm, cfg: ShardingConfig, placement=None) -> None:
        """The 2-D step's storage: each parameter at its
        ``llama_param_specs`` placement (packed, a module group at a
        time, as the fsdp serving engine gathers them:
        ``spmd.fsdp_groups``), or at a ``shard_mixtral`` placement, which
        the parameters already hold (``placement``; the expert banks then
        stay split over ep for compute)."""
        if not getattr(self.optimizer, "shardable_update", True):
            raise _not_elementwise(self.optimizer)
        self._mode = "2d"
        self._mesh = pm
        self._cfg = cfg
        sizes = pm.axis_sizes()
        self._comms = pm.bind()
        self._coords = {n: c.index for n, c in self._comms.items()}
        self._deg = pm.size
        self._live = [a for a in pm.dim_names if sizes[a] > 1]
        self._placement = placement
        if placement is not None:
            self._fsdp_deg = sizes.get(placement.fsdp_axis, 1)
            whole = placement.whole_shapes
            specs = placement.specs
        else:
            self._fsdp_deg = sizes["fsdp"]
            layout = SpecLayout(tp_axis="tp" if sizes.get("tp", 1) > 1
                                else None, fsdp_axis="fsdp")
            whole = self._placed_shapes or {k: tuple(p.shape)
                                            for k, p in self._params}
            specs = {k: port_spec(k, v) for k, v in llama_param_specs(
                [k for k, _ in self._params], layout,
                shapes=reference_shapes(whole), mesh=pm).items()}
        self._shardable, self._specs, self._compute = {}, {}, {}
        self._gather_bytes_per_step = 0
        with torch.no_grad():
            for k, p in self._params:
                ok = bool(spec_axes(specs[k])) and (
                    placement is not None
                    or self._state_param_shaped(k, p))
                spec = specs[k] if ok else P()
                self._shardable[k], self._specs[k] = ok, spec
                self._compute[k] = (placement.compute_spec(k)
                                    if placement is not None else spec)
                gathered = spec_axes(self._compute[k])
                part = math.prod(sizes[a] for a in gathered)
                if part > 1:
                    # the compute value (a bank's E/ep experts) arrives
                    # but for this rank's own slice of it
                    nbytes = math.prod(whole[k]) * p.element_size() \
                        // math.prod(sizes[a] for a in spec_axes(spec)
                                     if a not in gathered)
                    self._gather_bytes_per_step += nbytes - nbytes // part
            if placement is None and self._placed_shapes is None:
                self._store_slices()
            if placement is None:
                from .spmd import _ShardInfo
                # the placement the fsdp x tp serving engine adopts
                self.model._ptt_shard = _ShardInfo(
                    sizes, dict(self._coords), dict(whole))
            for k, p in self._params:
                self.optimizer.state_for(k, p.data)
        self._stored = {k: p.data for k, p in self._params}
        from ..observability import default_registry
        r = default_registry()
        r.gauge(
            "train_fsdp_degree",
            "fsdp (weight-storage sharding) degree of the most "
            "recently constructed 2D TrainStep in this process "
            "(1 = params replicated)").set(self._fsdp_deg)
        self._m_gather_bytes = r.counter(
            "spmd_allgather_bytes_total",
            "per-chip bytes received by spmd param all-gathers, by "
            "site: the 2D train step's per-step param gather "
            "(train_params) and the sharded serving prologue's fsdp "
            "gather (serving_params)", labels=("site",)
        ).labels(site="train_params")

    def _store_slices(self) -> None:
        """Keep this rank's slice of each sharded parameter (the whole
        tensor is freed).  A module group's fsdp-sharded slices are laid
        back to back in one buffer, in the order the fsdp serving engine
        packs them (``spmd.fsdp_groups``), so an engine built from the
        trained model adopts them without a copy; the other slices (and a
        model that is not a decoder stack) are stored alone."""
        from .spmd import fsdp_groups
        try:
            groups = fsdp_groups(self.model, self._specs, "fsdp")
        except ValueError:
            groups = {}
        packed = set()
        for items in groups.values():
            dtypes = {p.dtype for _, p, _ in items}
            if len(dtypes) != 1:
                continue
            pieces = [shard_tensor(p.data, self._specs[n], self._mesh,
                                   self._coords) for n, p, _ in items]
            flat = torch.empty(sum(x.numel() for x in pieces),
                               dtype=dtypes.pop(),
                               device=items[0][1].device)
            off = 0
            for (n, p, _), x in zip(items, pieces):
                flat[off:off + x.numel()].copy_(x.reshape(-1))
                p.data = flat[off:off + x.numel()].view(x.shape)
                off += x.numel()
                packed.add(n)
        for k, p in self._params:
            if k not in packed and spec_axes(self._specs[k]):
                p.data = shard_tensor(p.data, self._specs[k], self._mesh,
                                      self._coords).contiguous().clone()

    def _state_param_shaped(self, k: str, p: torch.Tensor) -> bool:
        """Every state leaf of ``p`` with a dim has ``p``'s shape (the
        update shards only elementwise state)."""
        probe = self.optimizer._init_state(
            k, torch.empty(p.shape, dtype=p.dtype, device="meta"))
        for name, leaf in probe.items():
            if leaf.dim() >= 1 and tuple(leaf.shape) != tuple(p.shape):
                warnings.warn(
                    f"param {k!r}: optimizer state leaf {name!r} of shape "
                    f"{tuple(leaf.shape)} is not parameter-shaped; its "
                    f"update stays replicated", stacklevel=4)
                return False
        return True

    def _rows(self, p: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``p`` (a view)."""
        r = p.shape[0] // self._deg
        return p.data[self._idx * r:(self._idx + 1) * r]

    def _grad_buckets(self):
        """Shardable keys grouped by dtype, packed into buckets of at most
        ``bucket_mb`` (reference: ``_grad_buckets``)."""
        budget = int(self._cfg.bucket_mb * 1024 * 1024)
        groups: Dict[torch.dtype, List[str]] = {}
        nonshard = []
        for k, p in self._params:
            if self._shardable[k]:
                groups.setdefault(p.dtype, []).append(k)
            else:
                nonshard.append(k)
        params = dict(self._params)
        buckets: List[List[str]] = []
        for keys in groups.values():
            cur, cur_bytes = [], 0
            for k in keys:
                nbytes = params[k].numel() * params[k].element_size()
                if cur and cur_bytes + nbytes > budget:
                    buckets.append(cur)
                    cur, cur_bytes = [], 0
                cur.append(k)
                cur_bytes += nbytes
            if cur:
                buckets.append(cur)
        return buckets, nonshard

    def bucket_bytes(self) -> List[int]:
        """The 1D step's reduce-scatter buckets, in bytes (each bucket's
        ``[degree, cols]`` matrix)."""
        params = dict(self._params)
        return [sum(params[k].numel() * params[k].element_size()
                    for k in b) for b in self._buckets]

    # -- the step ------------------------------------------------------------
    def _check_batch(self, batch) -> None:
        for b in batch:
            if isinstance(b, torch.Tensor) and b.dim() >= 1 \
                    and b.shape[0] % self._deg:
                raise ValueError(
                    f"sharded TrainStep: batch dim0={b.shape[0]} is not "
                    f"divisible by the mesh degree {self._deg}; use "
                    f"drop_last=True (Engine.fit does) or pad the tail "
                    f"batch")

    @staticmethod
    def _slice_batch(batch, index: int, parts: int):
        out = []
        for b in batch:
            if isinstance(b, torch.Tensor) and b.dim() >= 1:
                r = b.shape[0] // parts
                b = b[index * r:(index + 1) * r]
            out.append(b)
        return out

    def _loss(self, batch) -> torch.Tensor:
        *inputs, labels = batch
        loss = self.criterion(self.model(*inputs), labels)
        # a paddle-API model and criterion give an API Tensor
        loss = getattr(loss, "_value", loss).to(torch.float32)
        loss.backward()
        return loss.detach()

    @torch.no_grad()
    def _scale(self, grads, total_sq: torch.Tensor) -> None:
        gnorm = torch.sqrt(total_sq)
        scale = self.clip_norm / torch.clamp(gnorm, min=self.clip_norm)
        for g in grads:
            if g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g.copy_(g.to(torch.float32) * scale)

    @staticmethod
    def _sq(grads) -> torch.Tensor:
        sq = [g.to(torch.float32).square().sum() for g in grads]
        return torch.stack(sq).sum()

    def _clip(self, grads) -> None:
        self._scale(grads, self._sq(grads))

    def __call__(self, *batch) -> torch.Tensor:
        """``batch`` = model inputs then labels (the global batch on every
        rank of a sharded step); returns the fp32 loss (detached) of this
        step."""
        if self._mode in ("1d", "2d"):
            loss = (self._step_1d if self._mode == "1d"
                    else self._step_2d)(batch)
            self.optimizer._global_step += 1
            return loss
        if self._mode == "hybrid":
            loss = self._sync_hybrid(batch)
        else:
            loss = self._loss(batch)
        if self.clip_norm is not None:
            grads = [p.grad for _, p in self._params if p.grad is not None]
            if grads:
                self._clip(grads)
        self.optimizer.step()
        self.optimizer.clear_grad()
        if self._api_model:
            from ..core.tensor import Tensor
            return Tensor._from_value(loss)
        return loss

    @staticmethod
    def _flat_reduce(comm, grads: List[torch.Tensor], div: int) -> None:
        """Sum ``grads`` (one dtype) over ``comm`` in one all_reduce, in
        place, divided by ``div``."""
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads]) \
            if len(grads) > 1 else grads[0].reshape(-1)
        red = comm.all_reduce(flat)
        if div > 1:
            red = red / div
        off = 0
        for g in grads:
            n = g.numel()
            g.copy_(red[off:off + n].view(g.shape))
            off += n

    @torch.no_grad()
    def _sync_hybrid(self, batch) -> torch.Tensor:
        """This rank's data-parallel slice through the model, then every
        gradient (one all_reduce a dtype) and the loss summed over the
        replica group and divided by the data degree."""
        comm = self._replica
        batch = self._slice_batch(batch, self._dp_index, self._dp) \
            if self._dp > 1 else list(batch)
        with torch.enable_grad(), routing_over(self._routing):
            loss = self._loss(batch)
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for _, p in self._params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for gs in by_dtype.values():
            self._flat_reduce(comm, gs, self._dp)
        return comm.all_reduce(loss.reshape(1))[0] / self._dp

    def _step_1d(self, batch) -> torch.Tensor:
        self._check_batch(batch)
        deg, idx, comm = self._deg, self._idx, self._comm
        mean = self._cfg.loss_reduction == "mean"
        loss = self._loss(self._slice_batch(batch, idx, deg))
        params = dict(self._params)
        with torch.no_grad():
            grads: Dict[str, torch.Tensor] = {}
            for bucket in self._buckets:
                gs = [params[k].grad if params[k].grad is not None
                      else torch.zeros_like(params[k]) for k in bucket]
                mat = torch.cat([g.reshape(deg, -1) for g in gs], dim=1) \
                    if len(gs) > 1 else gs[0].reshape(deg, -1)
                if self._cfg.stage >= 2:
                    row = comm.reduce_scatter(mat)
                else:
                    row = comm.all_reduce(mat)[idx]
                if mean:
                    row = row / deg
                off = 0
                for k in bucket:
                    shape = params[k].shape
                    c = params[k].numel() // deg
                    grads[k] = row[off:off + c].view(
                        (shape[0] // deg,) + tuple(shape[1:]))
                    off += c
            by_dtype: Dict[torch.dtype, List[str]] = {}
            for k in self._nonshard:
                if params[k].grad is not None:
                    by_dtype.setdefault(params[k].grad.dtype, []).append(k)
            for keys in by_dtype.values():
                self._flat_reduce(comm, [params[k].grad for k in keys],
                                  deg if mean else 1)
                for k in keys:
                    grads[k] = params[k].grad
            if self.clip_norm is not None:
                local = self._sq([grads[k] for k in grads
                                  if self._shardable[k]]) \
                    if self._buckets else torch.zeros(
                        (), device=loss.device)
                total = comm.all_reduce(local.reshape(1))[0]
                if self._nonshard:
                    total = total + self._sq([grads[k] for k in grads
                                              if not self._shardable[k]])
                self._scale(list(grads.values()), total)
            lr = self.optimizer.get_lr()
            for k, p in self._params:
                if k not in grads:
                    continue
                st = self.optimizer.state(k)
                if self._shardable[k]:
                    self.optimizer._update_rule(self._rows(p), grads[k], st,
                                                lr)
                else:
                    self.optimizer._update_rule(p.data, grads[k], st, lr)
                p.grad = None
            # the updated rows back on every rank: one all_gather a bucket
            for bucket in self._buckets:
                mine = torch.cat([self._rows(params[k]).reshape(-1)
                                  for k in bucket])
                rows = torch.empty((deg, mine.numel()), dtype=mine.dtype,
                                   device=mine.device)
                C.all_gather_rows(rows, mine, comm.group)
                off = 0
                for k in bucket:
                    whole = params[k].data.view(deg, -1)
                    c = whole.shape[1]
                    whole.copy_(rows[:, off:off + c])
                    off += c
            loss = comm.all_reduce(loss.reshape(1))[0]
            if mean:
                loss = loss / deg
        return loss

    def _linear_index(self) -> int:
        idx = 0
        sizes = self._mesh.axis_sizes()
        for a in self._mesh.dim_names:
            idx = idx * sizes[a] + self._coords[a]
        return idx

    def _step_2d(self, batch) -> torch.Tensor:
        self._check_batch(batch)
        comms, specs = self._comms, self._specs
        mean = self._cfg.loss_reduction == "mean"
        with torch.no_grad():
            # the ZeRO-3 compute gather: the whole value of every param
            # (a shard_mixtral bank: its E/ep experts), for this step only
            for k, p in self._params:
                p.data = gather_spec_axes(self._stored[k], self._compute[k],
                                          comms, op="train_gather")
        # a shard_mixtral model's tokens route over the mesh as one set,
        # as the reference's GSPMD-global batch does
        local = (self._placement.local(self._deg if mean else 1)
                 if self._placement is not None
                 else contextlib.nullcontext())
        try:
            with local:
                loss = self._loss(self._slice_batch(
                    batch, self._linear_index(), self._deg))
        finally:
            for k, p in self._params:
                p.data = self._stored[k]
        with torch.no_grad():
            grads: Dict[str, torch.Tensor] = {}
            pending: Dict[tuple, List[str]] = {}
            for k, p in self._params:
                g = p.grad
                p.grad = None
                if g is None:
                    continue
                g = scatter_spec_axes(g, self._compute[k],
                                      comms).contiguous()
                rest = tuple(a for a in self._live
                             if a not in spec_axes(specs[k]))
                if rest:
                    pending.setdefault((rest, g.dtype), []).append(k)
                grads[k] = g
            for (rest, _), keys in pending.items():
                for a in rest:
                    self._flat_reduce(comms[a], [grads[k] for k in keys], 1)
            if mean:
                for g in grads.values():
                    g.div_(self._deg)
            if self.clip_norm is not None:
                groups: Dict[tuple, List[torch.Tensor]] = {}
                for k, g in grads.items():
                    ax = tuple(sorted(set(spec_axes(specs[k]))))
                    groups.setdefault(ax, []).append(g)
                total = torch.zeros((), device=loss.device)
                for ax, gs in groups.items():
                    sq = self._sq(gs).reshape(1)
                    for a in ax:
                        sq = comms[a].all_reduce(sq)
                    total = total + sq[0]
                self._scale(list(grads.values()), total)
            lr = self.optimizer.get_lr()
            for k, g in grads.items():
                self.optimizer._update_rule(self._stored[k], g,
                                            self.optimizer.state(k), lr)
            loss = loss.reshape(1)
            for a in self._live:
                loss = comms[a].all_reduce(loss)
            loss = loss[0] / self._deg if mean else loss[0]
            self._m_gather_bytes.inc(self._gather_bytes_per_step)
        return loss

    # -- optimizer state -----------------------------------------------------
    def opt_state_arrays(self) -> Dict[str, torch.Tensor]:
        """Flat ``{"opt.<param>.<leaf>": tensor}`` of the live optimizer
        state (reference: ``opt_state_arrays``); a sharded leaf is this
        rank's slice (:meth:`leaf_specs` gives its placement)."""
        out = {}
        for k, _ in self._params:
            for name, v in self.optimizer.state(k).items():
                out[f"opt.{k}.{name}"] = v
        return out

    def _leaf_sharded(self, k: str, p, full_shape) -> bool:
        return (self._mode in ("1d", "2d") and self._shardable[k]
                and len(full_shape) >= 1
                and tuple(full_shape) == self._full_shape(k, p))

    def _full_shape(self, k: str, p) -> tuple:
        if self._mode == "2d":
            sizes = self._mesh.axis_sizes()
            shape = list(p.shape)
            for dim, entry in enumerate(self._specs[k]):
                for name in ([entry] if isinstance(entry, str)
                             else list(entry or ())):
                    shape[dim] *= sizes[name]
            return tuple(shape)
        return tuple(p.shape)

    def leaf_specs(self) -> Dict[str, tuple]:
        """The placement of each :meth:`opt_state_arrays` leaf in the
        port's layout: ``P(axis)`` for a 1D rank's rows, the parameter's
        spec on the 2D path, ``P()`` for a whole leaf."""
        out = {}
        for k, p in self._params:
            for name, v in self.optimizer.state(k).items():
                spec = P()
                if self._mode == "1d" and self._shardable[k] \
                        and v.dim() >= 1:
                    spec = P(self._comm.name)
                elif self._mode == "2d" and self._shardable[k] \
                        and v.dim() >= 1:
                    spec = self._specs[k]
                out[f"opt.{k}.{name}"] = spec
        return out

    @torch.no_grad()
    def load_opt_state_arrays(self, flat) -> None:
        """Restore whole arrays (numpy or tensors, as
        :meth:`opt_state_arrays` gives them gathered) into this step's
        state, each re-sliced to this step's placement (reference:
        ``load_opt_state_arrays``).  ``flat`` may also be a checkpoint
        (``distributed.checkpoint.TrainState``): then each leaf's box under
        this step's placement is assembled from only the shards that
        overlap it.  Unknown keys are ignored; missing keys keep their
        fresh init; a shape that does not fit raises."""
        from .redistribute import spec_box
        boxed = hasattr(flat, "box_tensor")
        for k, p in self._params:
            st = self.optimizer.state(k)
            for name, cur in st.items():
                key = f"opt.{k}.{name}"
                if boxed:
                    if key not in flat.arrays:
                        continue
                    whole = flat.global_shape(key)
                    spec, sizes, coords = P(), {}, {}
                    if self._leaf_sharded(k, p, whole):
                        spec = self.leaf_specs()[key]
                        sizes = self._mesh.axis_sizes()
                        coords = (self._coords if self._mode == "2d"
                                  else {self._comm.name: self._idx})
                    val = flat.box_tensor(key, spec_box(whole, spec, sizes,
                                                        coords))
                else:
                    full = flat.get(key)
                    if full is None:
                        continue
                    val = torch.as_tensor(full)
                    if self._leaf_sharded(k, p, val.shape):
                        if self._mode == "1d":
                            r = val.shape[0] // self._deg
                            val = val[self._idx * r:(self._idx + 1) * r]
                        else:
                            val = shard_tensor(val, self._specs[k],
                                               self._mesh, self._coords)
                if tuple(val.shape) != tuple(cur.shape):
                    raise ValueError(
                        f"checkpointed state {k}.{name} has shape "
                        f"{tuple(val.shape)}, current run expects "
                        f"{tuple(cur.shape)}")
                cur.copy_(val)

    # -- checkpoints ---------------------------------------------------------
    def _mesh_or_none(self):
        return self._mesh if self._mode in ("1d", "2d") else None

    def _param_spec(self, k: str) -> tuple:
        return tuple(self._specs.get(k, P())) if self._mode == "2d" else P()

    def ckpt_values(self) -> Dict[str, object]:
        """What a checkpoint of this step holds (the reference tests'
        ``_ckpt_values``): ``model.<k>`` for every entry of the model's
        state dict and ``opt.<k>.<leaf>`` for every optimizer-state leaf,
        the fp32 ``master`` included; on a sharded step each is a
        ``jit.redistribute.Placed`` (this rank's slice, its spec, the
        mesh), else the tensor."""
        from .redistribute import Placed
        mesh = self._mesh_or_none()
        out: Dict[str, object] = {}
        for k, t in self.model.state_dict().items():
            out["model." + k] = (Placed(t, self._param_spec(k), mesh)
                                 if mesh is not None else t)
        specs = self.leaf_specs()
        for k, v in self.opt_state_arrays().items():
            out[k] = Placed(v, specs[k], mesh) if mesh is not None else v
        return out

    @torch.no_grad()
    def load_train_state(self, state) -> None:
        """Restore a checkpoint (``distributed.checkpoint.TrainState``)
        saved under any mesh onto this step's placement: each parameter's
        and (through :meth:`load_opt_state_arrays`) each state leaf's box
        assembled from only the shards that overlap it, and the
        optimizer's step count from ``meta["global_step"]`` when it is
        there."""
        from .redistribute import spec_box
        mesh = self._mesh_or_none()
        sizes = mesh.axis_sizes() if mesh is not None else {}
        coords = self._coords if self._mode == "2d" else {}
        params = dict(self._params)
        for k, t in self.model.state_dict().items():
            spec = self._param_spec(k)
            whole = (self._full_shape(k, params[k]) if k in params
                     else tuple(t.shape))
            box = spec_box(whole, spec, sizes, coords)
            t.copy_(state.box_tensor("model." + k, box))
        self.load_opt_state_arrays(state)
        if "global_step" in state.meta:
            self.optimizer._global_step = int(state.meta["global_step"])
