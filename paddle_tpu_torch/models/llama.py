"""Llama model family (counterpart of ``paddle_tpu/models/llama.py``).

Two paths, as in the reference:

- Without caches (training): ``forward(input_ids)`` returns the logits
  with autograd on; attention is the neox-rope flash path
  (``ops.flash_attention.flash_attention_rope``: the flash kernels on the
  card, their plain versions on the CPU), and ``config.recompute``
  recomputes each decoder layer in the backward
  (``torch.utils.checkpoint``) while the model is in training mode.
  With ``config.sequence_parallel`` under a hybrid group whose sep degree
  is above 1 (``distributed.topology``), each rank keeps its slice of
  the sequence of the ``input_ids`` it is given (rank ``i`` the positions
  ``i * S_local ..``): rope at those positions, and attention by
  ``ops.sequence_parallel.sdpa_ring`` or ``sdpa_ulysses``
  (``seq_parallel_mode``); the logits are the rank's slice, and
  :class:`LlamaPretrainingCriterion` takes the matching slice of the
  shifted global labels.
- With caches (inference): ``forward(input_ids, caches, position_offset)``
  returns ``(logits, new caches)`` under ``torch.no_grad``, with separate
  rope and causal attention and no kernel.  ``generate`` runs greedy
  decoding on it and is the eager oracle the serving engine is held
  against.

Parameters live in ``config.dtype`` on the device given at construction
(``device=None`` is the CUDA card) and are initialized from an explicit
``torch.Generator`` (normal with ``initializer_range``; norms 1), or
loaded from the reference with ``testing.parity.load_paddle_tpu_weights``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.device import DeviceLike, resolve_device
from . import _functional as PF
from ._layers import Embedding, Linear, RMSNorm
from ..ops.flash_attention import flash_attention_rope

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

KVCache = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    dtype: str = "float32"
    # qkv biases (qwen2-family architecture; llama proper has none)
    attention_bias: bool = False
    # recompute each decoder layer in the backward (training mode only)
    recompute: bool = False
    # shard the sequence over the hybrid group's sep axis (training)
    sequence_parallel: bool = False
    # "ring" (k/v rotation) or "ulysses" (all-to-all head swap)
    seq_parallel_mode: str = "ring"

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError("LlamaConfig dtype must be one of %s; got %r"
                             % (sorted(_DTYPES), self.dtype))
        return _DTYPES[self.dtype]


def llama_7b_config(**kw) -> LlamaConfig:
    """Llama-2-7B widths (the dataclass defaults)."""
    return LlamaConfig(**kw)


def llama_tiny_config(**kw) -> LlamaConfig:
    cfg = dict(vocab_size=1024, hidden_size=128, intermediate_size=352,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=256)
    cfg.update(kw)
    return LlamaConfig(**cfg)


class LlamaMLP(nn.Module):
    """SwiGLU MLP."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(h, i, device=device, dtype=dtype)
        self.up_proj = Linear(h, i, device=device, dtype=dtype)
        self.down_proj = Linear(i, h, device=device, dtype=dtype)

    def forward(self, x):
        return self.down_proj(PF.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaAttention(nn.Module):
    """GQA attention with neox rotary embeddings: the fused rope + flash
    path without a cache, the reference's general path over a dense K/V
    cache with one."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        sp_mode = getattr(config, "seq_parallel_mode", "ring")
        if sp_mode not in ("ring", "ulysses"):
            raise ValueError(
                f"seq_parallel_mode must be 'ring' or 'ulysses', got "
                f"{sp_mode!r}")
        self.config = config
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        h = config.hidden_size
        kw = dict(bias=config.attention_bias, device=device, dtype=dtype)
        self.q_proj = Linear(h, self.num_heads * self.head_dim, **kw)
        self.k_proj = Linear(h, self.num_kv_heads * self.head_dim, **kw)
        self.v_proj = Linear(h, self.num_kv_heads * self.head_dim, **kw)
        self.o_proj = Linear(self.num_heads * self.head_dim, h,
                             device=device, dtype=dtype)

    def _qkv(self, x):
        B, S = x.shape[0], x.shape[1]
        return (self.q_proj(x).reshape(B, S, self.num_heads, self.head_dim),
                self.k_proj(x).reshape(B, S, self.num_kv_heads,
                                       self.head_dim),
                self.v_proj(x).reshape(B, S, self.num_kv_heads,
                                       self.head_dim))

    def forward(self, x):
        """``x`` [B, S, h] -> ``out`` [B, S, h] through the fused rope +
        flash path (positions from 0), or under sequence parallelism this
        rank's slice through the ring or Ulysses."""
        B, S = x.shape[0], x.shape[1]
        q, k, v = self._qkv(x)
        hcg = sep_group(self.config)
        if hcg is not None:
            from ..ops.sequence_parallel import sdpa_ring, sdpa_ulysses
            q, k = PF.fused_rotary_position_embedding(
                q, k, position_offset=hcg.get_sep_parallel_rank() * S,
                rotary_emb_base=self.config.rope_theta)
            fn = sdpa_ulysses if getattr(self.config, "seq_parallel_mode",
                                         "ring") == "ulysses" else sdpa_ring
            out = fn(q, self._repeat_kv(k), self._repeat_kv(v), hcg,
                     axis_name="sep", is_causal=True)
            return self.o_proj(out.reshape(B, S,
                                           self.num_heads * self.head_dim))
        out = flash_attention_rope(q, self._repeat_kv(k), self._repeat_kv(v),
                                   self.config.rope_theta, is_causal=True)
        return self.o_proj(out.reshape(B, S, self.num_heads * self.head_dim))

    def forward_with_cache(self, x, cache: KVCache, position_offset: int):
        """``x`` [B, S, h] at positions from ``position_offset``; ``cache``
        the layer's (k, v) [B, L, Hkv, D] so far, or ``(None, None)``.
        Returns ``(out, (k, v))`` with the new tokens appended (before the
        GQA repeat)."""
        B, S = x.shape[0], x.shape[1]
        q, k, v = self._qkv(x)
        q, k = PF.fused_rotary_position_embedding(
            q, k, position_offset=position_offset,
            rotary_emb_base=self.config.rope_theta)
        if cache[0] is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        new_cache = (k, v)
        out = PF.scaled_dot_product_attention(q, self._repeat_kv(k),
                                              self._repeat_kv(v))
        out = self.o_proj(out.reshape(B, S, self.num_heads * self.head_dim))
        return out, new_cache

    def _repeat_kv(self, t: torch.Tensor) -> torch.Tensor:
        """GQA: each kv head repeated for its group of query heads."""
        if self.num_kv_heads == self.num_heads:
            return t
        return t.repeat_interleave(self.num_heads // self.num_kv_heads,
                                   dim=2)


def sep_group(config):
    """The hybrid group when ``config`` trains sequence-parallel over a sep
    axis above 1 (reference: ``LlamaAttention._ring_axis``), else None."""
    if not getattr(config, "sequence_parallel", False):
        return None
    from ..distributed.topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is not None and hcg.get_sep_parallel_world_size() > 1:
        return hcg
    return None


def sep_slice(t: torch.Tensor, hcg) -> torch.Tensor:
    """This sep rank's slice of dim 1 (the sequence) of ``t``."""
    n = hcg.get_sep_parallel_world_size()
    S = t.shape[1]
    if S % n:
        raise ValueError("sequence parallelism: sequence length %d does "
                         "not divide by the sep degree %d" % (S, n))
    i = hcg.get_sep_parallel_rank()
    return t[:, i * (S // n):(i + 1) * (S // n)]


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.self_attn = LlamaAttention(config, device, dtype)
        self.mlp = LlamaMLP(config, device, dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, device, dtype)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps,
                                                device, dtype)
        self._recompute = config.recompute

    def _block(self, x):
        h = x + self.self_attn(self.input_layernorm(x))
        return h + self.mlp(self.post_attention_layernorm(h))

    def forward(self, x):
        if self._recompute and self.training:
            return checkpoint(self._block, x, use_reentrant=False)
        return self._block(x)

    def forward_with_cache(self, x, cache: KVCache, position_offset: int):
        attn, new_cache = self.self_attn.forward_with_cache(
            self.input_layernorm(x), cache, position_offset)
        h = x + attn
        return h + self.mlp(self.post_attention_layernorm(h)), new_cache


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      device, dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device, dtype)

    def forward(self, input_ids, caches: Optional[List[KVCache]] = None,
                position_offset: int = 0):
        """Without ``caches``: the normed hidden states.  With them:
        ``(hidden states, new caches)``."""
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


class LlamaForCausalLM(nn.Module):
    """Llama with an LM head.  ``device=None`` places it on the CUDA card;
    ``generator`` (a ``torch.Generator`` on that device) initializes the
    weights — without one they are drawn from a generator seeded 0.  The
    parameters are trainable; the module starts in training mode (which
    only decides ``config.recompute``)."""

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dtype = config.torch_dtype
        self.llama = LlamaModel(config, dev, dtype)
        self.lm_head = (None if config.tie_word_embeddings else
                        Linear(config.hidden_size, config.vocab_size,
                               device=dev, dtype=dtype))
        self.init_weights(generator)

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Normal(0, initializer_range) for every matrix, 1 for the norm
        weights, 0 for biases, drawn from ``generator``."""
        if self.device.type == "meta":
            return      # a shard's skeleton (jit.spmd.shard_model)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            init_parameter(name, p, std, generator)

    def lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return h @ self.llama.embed_tokens.weight.t()
        return self.lm_head(h)

    def forward(self, input_ids, caches: Optional[List[KVCache]] = None,
                position_offset: int = 0):
        """``input_ids`` [B, S] -> ``logits [B, S, V]`` (autograd on); with
        ``caches`` (a list of per-layer ``(k, v)``, ``(None, None)`` for
        empty) -> ``(logits, new caches)`` under ``torch.no_grad``."""
        if caches is None:
            hcg = sep_group(self.config)
            if hcg is not None:
                input_ids = sep_slice(input_ids, hcg)
            return self.lm_logits(self.llama(input_ids))
        with torch.no_grad():
            h, caches = self.llama(input_ids, caches, position_offset)
            return self.lm_logits(h), caches

    @torch.no_grad()
    def generate(self, input_ids: torch.Tensor, max_new_tokens: int = 16,
                 eos_token_id: Optional[int] = None) -> torch.Tensor:
        """Greedy autoregressive decode with dense per-layer K/V caches
        (reference: ``LlamaForCausalLM.generate`` with ``top_p=0``).
        ``input_ids`` [B, L] -> [B, L + n] (``n <= max_new_tokens``; stops
        early when every row emitted ``eos_token_id``)."""
        ids = input_ids.to(self.device, torch.long)
        logits, caches = self(ids,
                              [(None, None)] * self.config.num_hidden_layers)
        out = [ids]
        cur_len = ids.shape[1]
        for step in range(max_new_tokens):
            nxt = logits[:, -1, :].argmax(-1).reshape(-1, 1)
            out.append(nxt)
            if eos_token_id is not None and bool(
                    (nxt == eos_token_id).all()):
                break
            if step < max_new_tokens - 1:      # the last token needs no fwd
                logits, caches = self(nxt, caches, position_offset=cur_len)
                cur_len += 1
        return torch.cat(out, dim=1)


@torch.no_grad()
def init_parameter(name: str, p: torch.Tensor, std: float,
                   generator: torch.Generator) -> None:
    """``init_weights``'s rule for one parameter, in place: norm weights
    1, biases 0, everything else normal(0, ``std``) from ``generator``
    (``jit.spmd.shard_model`` draws each whole parameter through it, in
    the same order, so a shard is the slice of the one-card model)."""
    if name.endswith("norm.weight"):
        p.fill_(1.0)
    elif name.endswith(".bias"):
        p.zero_()
    else:
        p.normal_(0.0, std, generator=generator)


def inner_model(model: nn.Module) -> nn.Module:
    """The decoder stack behind a causal-LM wrapper (reference:
    ``jit/serving_step.py`` ``_inner_model``): ``model.llama`` (Llama,
    Qwen2) or ``model.mixtral``.  Both expose ``embed_tokens``, ``layers``
    and ``norm``; a layer's FFN is its ``mlp`` or its
    ``block_sparse_moe``."""
    for name in ("llama", "mixtral"):
        inner = getattr(model, name, None)
        if inner is not None:
            return inner
    raise ValueError(
        "serving steps need a LlamaForCausalLM-shaped model (an inner "
        ".llama or .mixtral decoder stack); got %r" % type(model).__name__)


class LlamaPretrainingCriterion(nn.Module):
    """Shift-by-one LM loss with fp32 softmax (reference:
    ``LlamaPretrainingCriterion``): the labels roll left by one and the
    last position is filled with ``ignore_index``, so the logits are never
    sliced; the loss is the mean over valid labels.

    Under sequence parallelism (logits of a rank's slice of the sequence,
    global ``labels``) the global labels are shifted first, so a rank's
    last position takes the next rank's first label, then sliced; the
    loss is this rank's sum over its valid labels divided by the count of
    valid labels over the sep ranks, so the ranks' losses (and gradients)
    sum to the global mean."""

    def __init__(self, config: Optional[LlamaConfig] = None,
                 ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        tail = torch.full((labels.shape[0], 1), self.ignore_index,
                          dtype=labels.dtype, device=labels.device)
        shift = torch.cat([labels[:, 1:], tail], dim=1)
        V = logits.shape[-1]
        hcg = None
        if logits.shape[1] != labels.shape[1]:
            from ..distributed.topology import get_hybrid_communicate_group
            hcg = get_hybrid_communicate_group()
            if hcg is None or hcg.get_sep_parallel_world_size() \
                    * logits.shape[1] != labels.shape[1]:
                raise ValueError(
                    "logits of %d positions for labels of %d: only a "
                    "sequence-parallel rank's logits are a slice"
                    % (logits.shape[1], labels.shape[1]))
        if hcg is None:
            return PF.cross_entropy(logits.reshape(-1, V),
                                    shift.reshape(-1),
                                    ignore_index=self.ignore_index)
        shift = sep_slice(shift, hcg).reshape(-1)
        total, count = PF.cross_entropy_sum(logits.reshape(-1, V), shift,
                                            ignore_index=self.ignore_index)
        count = hcg.get_sep_parallel_group().all_reduce(count.reshape(1))
        return total / torch.clamp(count[0], min=1.0)


@torch.no_grad()
def llama_truncated_draft(model: LlamaForCausalLM,
                          num_layers: int = 1) -> LlamaForCausalLM:
    """Layer-truncated self-speculative draft (reference:
    ``llama_truncated_draft``): the same config cut to the first
    ``num_layers`` decoder layers, with the embedding, those layers, the
    final norm and the LM head copied from the target into a new model on
    the target's device and dtype (early-exit drafting: a cheap,
    training-free draft whose acceptance the speculative engines
    report)."""
    cfg = model.config
    if not 0 < num_layers < cfg.num_hidden_layers:
        raise ValueError(
            "draft must be a strict layer truncation: 0 < num_layers=%d < "
            "%d" % (num_layers, cfg.num_hidden_layers))
    draft = LlamaForCausalLM(replace(cfg, num_hidden_layers=num_layers),
                             device=model.device)
    src = model.state_dict()
    draft.load_state_dict({k: src[k] for k in draft.state_dict()})
    draft.eval()
    return draft


def llama_flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    """``6 N`` plus the attention term ``12 L h S`` (reference:
    ``llama_flops_per_token``; BASELINE.md's convention)."""
    attn = 12 * config.num_hidden_layers * config.hidden_size * seq_len
    return 6.0 * param_count(config) + attn


def param_count(config: LlamaConfig) -> int:
    h, i, v = config.hidden_size, config.intermediate_size, config.vocab_size
    L = config.num_hidden_layers
    kv = config.num_key_value_heads * (h // config.num_attention_heads)
    per_layer = h * h + 2 * h * kv + h * h + 3 * h * i + 2 * h
    emb = v * h * (1 if config.tie_word_embeddings else 2)
    return L * per_layer + emb + h
