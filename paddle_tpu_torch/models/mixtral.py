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
the CUDA card).  ``shard_mixtral`` (expert parallelism) is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..nn.layers import Embedding, Linear, RMSNorm
from ..ops.moe_gate import (assignment_slots, combine_from_buffers,
                            dispatch_to_buffers, grouped_expert_swiglu,
                            topk_gate)
from .llama import (KVCache, LlamaAttention, LlamaConfig, LlamaForCausalLM,
                    LlamaPretrainingCriterion)

__all__ = ["MixtralConfig", "MixtralSparseMoeBlock", "MixtralDecoderLayer",
           "MixtralModel", "MixtralForCausalLM",
           "MixtralPretrainingCriterion", "mixtral_tiny_config",
           "mixtral_8x7b_config", "shard_mixtral"]


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
    the raw assignment, before capacity)."""

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

    def capacity(self, n_tokens: int) -> int:
        return max(1, int(self.capacity_factor * n_tokens * self.top_k
                          / self.num_experts))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, x.shape[-1])
        E, k = self.num_experts, self.top_k
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
        if config.sequence_parallel:
            raise NotImplementedError(
                "MixtralForCausalLM: sequence parallelism is not ported "
                "for the MoE family (Llama and Qwen2 train under sep)")
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
            return self.lm_logits(self.mixtral(input_ids))
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


def shard_mixtral(model, mesh, ep_axis="model", fsdp_axis="sharding"):
    """Expert-parallel + FSDP layout: not ported (the port serves and
    trains MoE models on one device)."""
    raise NotImplementedError(
        "shard_mixtral (expert parallelism over a mesh) is not ported to "
        "paddle_tpu_torch yet; it waits for the multi-device slice")
