"""Pipeline-parallel Llama training (counterpart of
``paddle_tpu/models/llama_pipeline.py``): dp x pp x tp x fsdp over
``torch.distributed`` ranks.

The reference compiles the whole hybrid step into one XLA module.  The
port runs it one process a rank over a ``ProcessMesh`` with the
reference's axis names (``pipe``, ``model`` = tp, ``sharding`` = fsdp,
``data`` = dp; an absent axis has size 1):

- a stage rank keeps its ``L/pp`` decoder layers, each parameter stored at
  its slice of the reference's ``_stage_spec`` placement (columns
  ``P(pp, None, fsdp, tp)``, rows ``P(pp, None, tp, fsdp)`` on the stacked
  ``[pp, L/pp, in, out]`` layout, norms replicated; in the port's
  ``[out, in]`` layout the two entries swap); the embedding at
  ``P(tp, fsdp)``, the LM head at the reference's ``P(fsdp, tp)``, the
  final norm whole.  The other stages' layers are released.
- inside a stage, tp and fsdp go through the 2-D step's recipe
  (``jit/spmd.gather_spec_axes`` / ``scatter_spec_axes``): every stored
  slice is gathered whole for the step, and each rank of a stage computes
  on its slice of the batch (dp x fsdp x tp ways); the gradients go back
  to the placement by a reduce-scatter a named dim and a sum over the
  other live axes;
- the stages run ``distributed.pipelining.spmd_pipeline`` (host-driven
  GPipe, ``remat`` = recompute) over the model's usual flash path;
- the loss (:meth:`LlamaPipelineTrainStep._loss`) is the reference's: the
  final RMSNorm in fp32, the head, and the shift-by-one NLL averaged over
  every valid token of the whole batch (each rank's sum over its tokens
  divided by the global count, summed over the ranks);
- the embedding, final norm and head are computed on every stage from
  the broadcast outputs, so they end each step equal on every pipe rank,
  as the reference's are replicated over ``pipe``; with tied embeddings
  the embedding's gradient is the lookup's plus the head's;
- the global-norm clip counts each stage's layers once (their squares
  summed over ``pipe``) and each replicated parameter once, then the
  optimizer's rule updates every stored slice in place.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..distributed.pipelining import spmd_pipeline
from ..nn import functional as PF
from ..distributed.process_mesh import as_mesh
from ..jit.spmd import (P, gather_spec_axes, port_spec, prune_spec_axes,
                        scatter_spec_axes, shard_tensor, spec_axes)

__all__ = ["LlamaPipelineTrainStep"]

_LAYER_PREFIX = "llama.layers."


def _stage_spec(suffix: str, pp_axis, tp_axis, fsdp_axis):
    """The reference's spec of a stacked ``[pp, Lp, ...]`` decoder-layer
    leaf (reference layout), in the Megatron layout."""
    col = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
    row = ("o_proj", "down_proj")
    if any(c in suffix for c in col):        # weight [in, out]
        return P(pp_axis, None, fsdp_axis, tp_axis)
    if any(r in suffix for r in row):
        return P(pp_axis, None, tp_axis, fsdp_axis)
    return P(pp_axis)                         # norms etc: replicated


class LlamaPipelineTrainStep:
    """One training step of a ``LlamaForCausalLM`` over a pipe (x data x
    sharding x model) mesh: ``loss = step(ids, labels)`` with the global
    batch on every rank.  The step owns the model: each rank keeps its
    stage's stored slices, updated in place."""

    def __init__(self, model, optimizer, mesh, n_microbatches: int,
                 pp_axis: str = "pipe", tp_axis: str = "model",
                 fsdp_axis: str = "sharding", dp_axis: str = "data",
                 clip_norm: Optional[float] = None, remat: bool = False):
        cfg = model.config
        pm = as_mesh(mesh)
        self.mesh = pm
        self.cfg = cfg
        self.model = model
        self.optimizer = optimizer
        self.n_micro = int(n_microbatches)
        self.pp_axis = pp_axis
        self.clip_norm = clip_norm
        self.remat = remat
        sizes = pm.axis_sizes()
        self._comms = pm.bind()
        self._coords = {n: c.index for n, c in self._comms.items()}
        pp = sizes.get(pp_axis, 1)
        L = cfg.num_hidden_layers
        if L % pp:
            raise ValueError("layers %d not divisible by pp %d" % (L, pp))
        self.layers_per_stage = L // pp
        self.stage = self._coords.get(pp_axis, 0)
        self._live = [a for a in pm.dim_names
                      if sizes[a] > 1 and a != pp_axis]
        self._n_data = pm.size // pp
        lo = self.stage * self.layers_per_stage
        mine = range(lo, lo + self.layers_per_stage)
        self._layers = [model.llama.layers[i] for i in mine]
        self._tied = model.lm_head is None
        named = dict(model.named_parameters())
        owned: List[str] = []
        specs: Dict[str, tuple] = {}
        for name, p in named.items():
            if name.startswith(_LAYER_PREFIX):
                idx, suffix = name[len(_LAYER_PREFIX):].split(".", 1)
                if int(idx) not in mine:
                    p.data = p.data.new_empty(0)     # another stage's
                    p.requires_grad_(False)
                    continue
                spec = P(*_stage_spec(suffix, pp_axis, tp_axis,
                                      fsdp_axis)[2:])
            elif name == "llama.embed_tokens.weight":
                spec = P(tp_axis, fsdp_axis)
            elif name == "lm_head.weight":
                spec = P(fsdp_axis, tp_axis)
            else:
                spec = P()
            ref_shape = (tuple(p.shape)[::-1] if p.dim() == 2
                         and name.endswith(("_proj.weight", "lm_head.weight"))
                         else tuple(p.shape))
            spec = port_spec(name, prune_spec_axes(spec, ref_shape, sizes))
            owned.append(name)
            specs[name] = spec
        self._specs = specs
        self._params = [(k, named[k]) for k in owned]
        with torch.no_grad():
            for k, p in self._params:
                if spec_axes(specs[k]):
                    p.data = shard_tensor(p.data, specs[k], pm,
                                          self._coords).contiguous().clone()
                optimizer.state_for(k, p.data)
        self._stored = {k: p.data for k, p in self._params}
        self._stage_params = {k: named[k] for k in owned
                              if k.startswith(_LAYER_PREFIX)}

    @property
    def global_step(self) -> int:
        return self.optimizer._global_step

    # -- the model -----------------------------------------------------------
    def _stage_fn(self, local, x):
        for layer in self._layers:
            x = layer._block(x)
        return x

    def _loss(self, ids, labels, count):
        """This rank's part of the reference's loss: its tokens' NLL sum
        divided by the valid-token ``count`` of the whole batch."""
        cfg = self.cfg
        inner = self.model.llama
        x = F.embedding(ids, inner.embed_tokens.weight)
        B, S, E = x.shape
        M = self.n_micro
        xs = x.reshape(M, B // M, S, E)
        ys = spmd_pipeline(self._stage_fn, self._stage_params, xs,
                           mesh=self.mesh, axis_name=self.pp_axis,
                           remat=self.remat)
        h = ys.reshape(B, S, E)
        # the final RMSNorm with fp32 statistics, then the head
        h32 = h.to(torch.float32)
        h32 = h32 * torch.rsqrt(h32.square().mean(-1, keepdim=True)
                                + cfg.rms_norm_eps)
        h = (h32 * inner.norm.weight.to(torch.float32)).to(h.dtype)
        w = inner.embed_tokens.weight if self._tied \
            else self.model.lm_head.weight
        logits = (h @ w.t().to(h.dtype)).to(torch.float32)
        nll_sum, _ = PF.cross_entropy_sum(
            logits[:, :-1].reshape(-1, logits.shape[-1]),
            labels[:, 1:].reshape(-1))
        return nll_sum / count

    # -- the step ------------------------------------------------------------
    @torch.no_grad()
    def _scale(self, grads, total_sq: torch.Tensor) -> None:
        gnorm = torch.sqrt(total_sq)
        scale = self.clip_norm / torch.clamp(gnorm, min=self.clip_norm)
        for g in grads:
            g.copy_((g.to(torch.float32) * scale).to(g.dtype))

    def _data_index(self) -> int:
        idx = 0
        sizes = self.mesh.axis_sizes()
        for a in self.mesh.dim_names:
            if a != self.pp_axis:
                idx = idx * sizes[a] + self._coords[a]
        return idx

    def __call__(self, ids, labels) -> torch.Tensor:
        from ..jit.train_step import TrainStep
        n, M = self._n_data, self.n_micro
        if ids.shape[0] % (n * M):
            raise ValueError(
                "pipeline step: batch dim0=%d is not divisible by the data "
                "ranks (%d) x micro-batches (%d)" % (ids.shape[0], n, M))
        comms, specs = self._comms, self._specs
        count = torch.clamp((labels[:, 1:] != -100).sum(), min=1).to(
            torch.float32)
        b = ids.shape[0] // n
        j = self._data_index()
        with torch.no_grad():
            for k, p in self._params:
                p.data = gather_spec_axes(self._stored[k], specs[k], comms,
                                          op="train_gather")
        try:
            loss = self._loss(ids[j * b:(j + 1) * b],
                              labels[j * b:(j + 1) * b], count)
            loss.backward()
        finally:
            for k, p in self._params:
                p.data = self._stored[k]
        with torch.no_grad():
            grads: Dict[str, torch.Tensor] = {}
            pending: Dict[tuple, List[str]] = {}
            for k, p in self._params:
                g, p.grad = p.grad, None
                g = scatter_spec_axes(g, specs[k], comms).contiguous()
                rest = tuple(a for a in self._live
                             if a not in spec_axes(specs[k]))
                if rest:
                    pending.setdefault((rest, g.dtype), []).append(k)
                grads[k] = g
            for (rest, _), keys in pending.items():
                for a in rest:
                    TrainStep._flat_reduce(comms[a],
                                           [grads[k] for k in keys], 1)
            if self.clip_norm is not None:
                self._scale(list(grads.values()), self._total_sq(grads))
            lr = self.optimizer.get_lr()
            for k, g in grads.items():
                self.optimizer._update_rule(self._stored[k], g,
                                            self.optimizer.state(k), lr)
            loss = loss.detach().reshape(1)
            for a in self._live:
                loss = comms[a].all_reduce(loss)
        self.optimizer._global_step += 1
        return loss[0]

    def _total_sq(self, grads) -> torch.Tensor:
        """The global squared norm: each group of parameters sharing a
        set of spec axes summed over those axes, a stage's layers summed
        over ``pipe`` too."""
        groups: Dict[tuple, List[torch.Tensor]] = {}
        for k, g in grads.items():
            ax = tuple(sorted(set(spec_axes(self._specs[k]))))
            groups.setdefault((ax, k in self._stage_params), []).append(g)
        total = None
        for (ax, staged), gs in groups.items():
            sq = torch.stack([g.to(torch.float32).square().sum()
                              for g in gs]).sum().reshape(1)
            for a in ax + ((self.pp_axis,) if staged
                           and self.pp_axis in self._comms else ()):
                sq = self._comms[a].all_reduce(sq)
            total = sq[0] if total is None else total + sq[0]
        return total
