"""Mixtral: the sparse mixture-of-experts Llama (counterpart of
``paddle_tpu/models/mixtral.py``).

A Llama decoder whose MLP is a bank of top-k routed SwiGLU experts held
as batched ``[E, ...]`` parameters (``w_gate``/``w_up`` ``[E, D, M]``,
``w_down`` ``[E, M, D]``, the reference's layout) behind a ``Linear``
router.  The eager block (training, and the eager oracle's cache path)
is the reference's GShard dispatch into capacity buffers: each expert
takes at most ``int(expert_capacity_factor * N * k / E)`` assignments of
a forward's ``N`` tokens, in assignment order, and drops the rest; the
load-balancing aux term comes from the raw assignment.  The serving
steps route through the dropless ``ops.moe_gate.moe_ffn`` instead, so
the eager model equals the engines only where nothing can drop:
``expert_capacity_factor >= E / k``.

Attention, norms, embedding, LM head, ``generate`` and weight
initialization are Llama's (``models/llama.py``).  Parameters live in
``config.dtype`` on the device given at construction (``device=None`` is
the CUDA card).

Over ranks the block routes the token set the reference routes, as one
set (``ops.moe_gate.routed_moe_ffn``): the reference's sequence
parallelism, hybrid data parallelism and ``shard_mixtral`` run on
GSPMD-global arrays, so their capacity, slot order and aux term are the
whole batch's; its ZeRO and 2-D steps run one ``shard_map`` replica a
shard, so those route each replica's batch alone (the block's own path).
The step that spans ranks makes the set current (``moe_gate.routing_over``);
under a sep group outside a step the model routes over the sep ranks.
:func:`shard_mixtral` places the model over a mesh of ranks (expert banks
split over ep, a rank keeping only its slices); it trains through
``TrainStep(model, ..., mesh=mesh)`` and its own forward gives the whole
batch's logits.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ._layers import Embedding, Linear, RMSNorm
from ..ops.moe_gate import (RoutingGroup, assignment_slots,
                            combine_from_buffers, current_routing,
                            dispatch_to_buffers, grouped_expert_swiglu,
                            routed_moe_ffn, routing_over, topk_gate)
from .llama import (KVCache, LlamaAttention, LlamaConfig, LlamaForCausalLM,
                    LlamaPretrainingCriterion, sep_group, sep_slice)

__all__ = ["MixtralConfig", "MixtralSparseMoeBlock", "MixtralDecoderLayer",
           "MixtralModel", "MixtralForCausalLM",
           "MixtralPretrainingCriterion", "mixtral_tiny_config",
           "mixtral_8x7b_config", "shard_mixtral", "MixtralPlacement"]


@dataclass
class MixtralConfig(LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    router_aux_loss_coef: float = 0.02
    # the eager block's capacity: int(factor * N * k / E) assignments an
    # expert; nothing drops when factor >= E / k (the engines never drop)
    expert_capacity_factor: float = 2.0


def mixtral_tiny_config(**kw) -> MixtralConfig:
    cfg = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=4, max_position_embeddings=128,
               num_local_experts=4, num_experts_per_tok=2)
    cfg.update(kw)
    return MixtralConfig(**cfg)


def mixtral_8x7b_config(**kw) -> MixtralConfig:
    """Mixtral-8x7B-v0.1's published widths: hidden 4096, intermediate
    14336, 32 layers, 32 query heads over 8 kv heads, vocabulary 32000,
    rope theta 1e6, RMS eps 1e-5, 8 experts, top-2, aux coefficient
    0.02."""
    cfg = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
               num_hidden_layers=32, num_attention_heads=32,
               num_key_value_heads=8, max_position_embeddings=32768,
               rms_norm_eps=1e-5, rope_theta=1e6, num_local_experts=8,
               num_experts_per_tok=2, router_aux_loss_coef=0.02)
    cfg.update(kw)
    return MixtralConfig(**cfg)


class MixtralSparseMoeBlock(nn.Module):
    """Top-k routed SwiGLU expert bank with batched weights: route ->
    capacity buffers ``[E, C, D]`` (drops beyond ``C``) -> three batched
    expert products -> weighted combine.  ``l_aux`` holds the last
    forward's load-balancing term ``E * sum_e f_e * P_e`` (``f_e`` from
    the raw assignment, before capacity; over ranks this rank's share of
    the set's term, ``moe_gate.aux_share``) and ``dropped`` its dropped
    assignments (the set's, over ranks).  ``ep``: this rank's ``AxisComm``
    of the expert-parallel axis under :func:`shard_mixtral` (the banks
    then hold its ``E/ep`` experts)."""

    def __init__(self, config: MixtralConfig, device=None, dtype=None):
        super().__init__()
        D, M = config.hidden_size, config.intermediate_size
        E = config.num_local_experts
        self.top_k = config.num_experts_per_tok
        self.num_experts = E
        self.capacity_factor = config.expert_capacity_factor
        kw = dict(device=device, dtype=dtype)
        self.gate = Linear(D, E, **kw)
        self.w_gate = nn.Parameter(torch.empty(E, D, M, **kw))
        self.w_up = nn.Parameter(torch.empty(E, D, M, **kw))
        self.w_down = nn.Parameter(torch.empty(E, M, D, **kw))
        self.l_aux: Optional[torch.Tensor] = None
        self.dropped: Optional[torch.Tensor] = None
        self.ep = None

    def capacity(self, n_tokens: int) -> int:
        return max(1, int(self.capacity_factor * n_tokens * self.top_k
                          / self.num_experts))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, x.shape[-1])
        E, k = self.num_experts, self.top_k
        group = current_routing()
        if group is not None or self.ep is not None:
            if group is None:
                raise RuntimeError(
                    "an expert-parallel MoE block routes over the ranks of "
                    "its mesh: run the sharded model through its own "
                    "forward or TrainStep(..., mesh=)")
            out, self.l_aux, self.dropped = routed_moe_ffn(
                flat, x.shape[0] if x.dim() == 3 else 1, self.gate.weight,
                self.w_gate, self.w_up, self.w_down, top_k=k,
                num_experts=E, capacity_factor=self.capacity_factor,
                group=group, ep_axis=self.ep)
            return out.reshape(x.shape)
        capacity = self.capacity(flat.shape[0])
        logits = (flat.to(torch.float32)
                  @ self.gate.weight.to(torch.float32).t())     # [N, E]
        top_w, top_i, probs = topk_gate(logits, k)
        slot, oh = assignment_slots(top_i, E)
        keep = slot < capacity
        disp = dispatch_to_buffers(flat, top_i, slot, keep, E, capacity)
        eo = grouped_expert_swiglu(disp, self.w_gate, self.w_up,
                                   self.w_down)
        out = combine_from_buffers(eo, top_i, slot, top_w,
                                   keep).to(flat.dtype)
        frac = oh.sum(dim=1).mean(dim=0)                        # [E]
        self.l_aux = E * (frac * probs.mean(dim=0)).sum()
        self.dropped = (~keep).sum()
        return out.reshape(x.shape)


class MixtralDecoderLayer(nn.Module):
    def __init__(self, config: MixtralConfig, device=None, dtype=None):
        super().__init__()
        self.self_attn = LlamaAttention(config, device, dtype)
        self.block_sparse_moe = MixtralSparseMoeBlock(config, device, dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, device, dtype)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps,
                                                device, dtype)

    def forward(self, x):
        h = x + self.self_attn(self.input_layernorm(x))
        return h + self.block_sparse_moe(self.post_attention_layernorm(h))

    def forward_with_cache(self, x, cache: KVCache, position_offset: int):
        attn, new_cache = self.self_attn.forward_with_cache(
            self.input_layernorm(x), cache, position_offset)
        h = x + attn
        return (h + self.block_sparse_moe(self.post_attention_layernorm(h)),
                new_cache)


class MixtralModel(nn.Module):
    def __init__(self, config: MixtralConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      device, dtype)
        self.layers = nn.ModuleList(
            [MixtralDecoderLayer(config, device, dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device, dtype)

    def forward(self, input_ids, caches: Optional[List[KVCache]] = None,
                position_offset: int = 0):
        h = self.embed_tokens(input_ids)
        if caches is None:
            for layer in self.layers:
                h = layer(h)
            return self.norm(h)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            h, c = layer.forward_with_cache(h, cache, position_offset)
            new_caches.append(c)
        return self.norm(h), new_caches


class MixtralForCausalLM(nn.Module):
    """Mixtral with an LM head.  ``device=None`` places it on the CUDA
    card; ``generator`` initializes the weights (normal with
    ``initializer_range`` for every matrix and expert bank, norms 1), as
    ``LlamaForCausalLM`` does."""

    def __init__(self, config: MixtralConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dtype = config.torch_dtype
        self.mixtral = MixtralModel(config, dev, dtype)
        self.lm_head = (None if config.tie_word_embeddings else
                        Linear(config.hidden_size, config.vocab_size,
                               device=dev, dtype=dtype))
        self.init_weights(generator)

    @property
    def device(self) -> torch.device:
        return self.mixtral.embed_tokens.weight.device

    init_weights = LlamaForCausalLM.init_weights

    def lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return h @ self.mixtral.embed_tokens.weight.t()
        return self.lm_head(h)

    def forward(self, input_ids, caches: Optional[List[KVCache]] = None,
                position_offset: int = 0):
        """As ``LlamaForCausalLM.forward``: the logits (autograd on), or
        with ``caches`` ``(logits, new caches)`` under no_grad."""
        if caches is None:
            placement = getattr(self, "_ptt_ep", None)
            if placement is not None and not placement.inside:
                return placement.forward(self, input_ids)
            hcg = sep_group(self.config)
            if hcg is not None:
                input_ids = sep_slice(input_ids, hcg)
                if current_routing() is None:
                    with routing_over(sep_routing(hcg)):
                        return self.lm_logits(self.mixtral(input_ids))
            return self.lm_logits(self.mixtral(input_ids))
        if getattr(self, "_ptt_ep", None) is not None:
            raise NotImplementedError(
                "a shard_mixtral model trains and runs whole-batch "
                "forwards; serve Mixtral over an ep mesh through "
                "jit.spmd.shard_model and the engines")
        with torch.no_grad():
            h, caches = self.mixtral(input_ids, caches, position_offset)
            return self.lm_logits(h), caches

    # the eager decode loop is model-agnostic: Llama's, so the MoE oracle
    # can never drift from the dense one (as in the reference)
    generate = LlamaForCausalLM.generate

    def router_aux_loss(self) -> torch.Tensor:
        """The sum of the layers' load-balancing terms from the LAST
        forward, times ``router_aux_loss_coef``."""
        auxes = [lyr.block_sparse_moe.l_aux for lyr in self.mixtral.layers
                 if lyr.block_sparse_moe.l_aux is not None]
        if not auxes:
            raise RuntimeError(
                "router_aux_loss() needs a forward pass first (the aux "
                "terms are recorded per layer during forward)")
        total = auxes[0]
        for a in auxes[1:]:
            total = total + a
        return total * self.config.router_aux_loss_coef


class MixtralPretrainingCriterion(nn.Module):
    """Cross-entropy plus the router aux term of the forward that produced
    ``logits`` (read from the model)."""

    def __init__(self, model: MixtralForCausalLM):
        super().__init__()
        self._model = [model]          # not registered as a submodule
        self._ce = LlamaPretrainingCriterion()

    def forward(self, logits: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        return self._ce(logits, labels) + self._model[0].router_aux_loss()


def sep_routing(hcg) -> RoutingGroup:
    """The token set of a sequence-parallel forward outside a training
    step: the sep ranks' slices of every row (each rank given the whole
    batch)."""
    comm = hcg.get_sep_parallel_group()
    return RoutingGroup(lambda t: comm.all_gather(t[None], 0), 0,
                        comm.index, 1.0)


_BANKS = ("w_gate", "w_up", "w_down")


def _placement_spec(name: str, ep: Optional[str],
                    fsdp: Optional[str]) -> tuple:
    """``shard_mixtral``'s placement of parameter ``name`` in the port's
    layout (a Linear weight ``[out, in]``): the reference's table with its
    Linear entries swapped."""
    from ..jit.spmd import P
    if name.endswith(_BANKS):
        return P(ep, None, fsdp)
    if "embed_tokens" in name or name == "lm_head.weight" \
            or any(p in name for p in ("q_proj.weight", "k_proj.weight",
                                       "v_proj.weight")):
        return P(ep, fsdp)
    if "o_proj.weight" in name:
        return P(fsdp, ep)
    return P()


class MixtralPlacement:
    """What :func:`shard_mixtral` leaves on the model (``_ptt_ep``): the
    mesh, this rank's ``AxisComm`` per axis, each parameter's placement
    (port layout, pruned to what its dims divide), the ep and fsdp axes
    and the whole shapes.

    A rank stores only its slice of each parameter.  For compute every
    parameter is gathered whole over its placement's axes except the
    expert banks' E dim, which stays split over ep (:meth:`compute_spec`):
    a rank runs only its experts.  The tokens are split by rows over the
    mesh in rank order (:meth:`linear_index`) and routed as one set over
    every rank (:meth:`routing`)."""

    def __init__(self, mesh, comms, specs, ep_axis, fsdp_axis,
                 whole_shapes):
        self.mesh = mesh
        self.comms = comms
        self.specs = specs
        self.ep_axis = ep_axis
        self.fsdp_axis = fsdp_axis
        self.whole_shapes = whole_shapes
        self.inside = False

    def compute_spec(self, name: str) -> tuple:
        from ..jit.spmd import P, _entry_names
        spec = self.specs[name]
        if not name.endswith(_BANKS):
            return spec
        return P(*[tuple(n for n in _entry_names(e) if n != self.ep_axis)
                   or None for e in spec])

    def linear_index(self) -> int:
        idx = 0
        sizes = self.mesh.axis_sizes()
        for a in self.mesh.dim_names:
            idx = idx * sizes[a] + self.comms[a].index
        return idx

    def gather_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along a new dim 0, in rank order."""
        out = t[None]
        for a in reversed(self.mesh.dim_names):
            out = self.comms[a].all_gather(out, 0)
        return out

    def routing(self, scale: float) -> RoutingGroup:
        return RoutingGroup(self.gather_ranks, self.linear_index(), 0,
                            scale)

    @contextlib.contextmanager
    def local(self, scale: float):
        """Inside the ``with``, the model runs this rank's rows as given
        (no whole-batch forward), its MoE blocks routing over the mesh
        with the aux share's ``scale`` (``moe_gate.RoutingGroup``)."""
        self.inside = True
        try:
            with routing_over(self.routing(scale)):
                yield
        finally:
            self.inside = False

    @contextlib.contextmanager
    def gathered(self, model: nn.Module):
        """Every parameter at its compute value (:meth:`compute_spec`) for
        the ``with`` block, back at its stored slice after."""
        from ..jit.spmd import gather_spec_axes
        stored = {}
        with torch.no_grad():
            for k, p in model.named_parameters():
                stored[k] = p.data
                p.data = gather_spec_axes(p.data, self.compute_spec(k),
                                          self.comms)
        try:
            yield
        finally:
            for k, p in model.named_parameters():
                p.data = stored[k]

    @torch.no_grad()
    def forward(self, model, input_ids: torch.Tensor) -> torch.Tensor:
        """The whole batch's logits on every rank: this rank's rows through
        the model at the compute values, routed over the mesh, then one
        all-gather a mesh axis."""
        from ..distributed.collective import all_gather_diff
        n = self.mesh.size
        if input_ids.shape[0] % n:
            raise ValueError(
                "shard_mixtral: batch dim0=%d is not divisible by the mesh "
                "size %d (the rows split over the ranks)"
                % (input_ids.shape[0], n))
        rows = input_ids.shape[0] // n
        idx = self.linear_index()
        with self.gathered(model), self.local(1.0):
            out = model(input_ids[idx * rows:(idx + 1) * rows])
        for a in reversed(self.mesh.dim_names):
            c = self.comms[a]
            out = all_gather_diff(out, 0, c.group, c.size)
        return out


@torch.no_grad()
def shard_mixtral(model: MixtralForCausalLM, mesh, ep_axis: str = "model",
                  fsdp_axis: str = "sharding") -> MixtralForCausalLM:
    """Expert-parallel and fsdp placement of ``model`` over the ranks of
    ``mesh`` (a ``distributed.process_mesh.ProcessMesh``; every rank
    calls this with the same whole model), the reference's placements:
    the expert banks split E over ``ep_axis`` and dim 2 over
    ``fsdp_axis``; the attention projections, the embedding and the LM
    head Megatron columns and rows with ``ep_axis`` standing in for tp and
    their other dim over ``fsdp_axis``; the router and the norms
    replicated.  An axis the mesh lacks, or whose degree a dim does not
    divide, is dropped from that dim.  Each rank keeps only its slices
    (the whole tensors are freed); the MoE blocks dispatch to the experts'
    owners over ``ep_axis`` (:class:`MixtralPlacement`).  Returns the
    model."""
    from ..distributed.process_mesh import as_mesh
    from ..jit.spmd import prune_spec_axes, shard_tensor
    pm = as_mesh(mesh)
    sizes = pm.axis_sizes()
    comms = pm.bind()
    coords = {a: c.index for a, c in comms.items()}
    ep = ep_axis if sizes.get(ep_axis, 1) > 1 else None
    fsdp = fsdp_axis if sizes.get(fsdp_axis, 1) > 1 else None
    if ep is not None and model.config.num_local_experts % sizes[ep]:
        raise ValueError(
            "shard_mixtral: %d experts do not split over an ep degree of %d"
            % (model.config.num_local_experts, sizes[ep]))
    whole = {k: tuple(p.shape) for k, p in model.named_parameters()}
    specs = {}
    for k, p in model.named_parameters():
        spec = prune_spec_axes(_placement_spec(k, ep, fsdp), whole[k], pm)
        if k.endswith(_BANKS) and ep is not None and spec[:1] != (ep,):
            raise ValueError("shard_mixtral: bank %s does not split E "
                             "over %r" % (k, ep))
        specs[k] = spec
        p.data = shard_tensor(p.data, spec, pm, coords).contiguous().clone()
    for layer in model.mixtral.layers:
        layer.block_sparse_moe.ep = comms[ep] if ep is not None else None
    model._ptt_ep = MixtralPlacement(pm, comms, specs, ep_axis, fsdp_axis,
                                     whole)
    return model
