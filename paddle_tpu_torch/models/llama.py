"""Llama model family (counterpart of ``paddle_tpu/models/llama.py``).

This module is the eager oracle of the serving slice: ``generate`` runs
greedy decoding with dense per-layer K/V caches and no kernel, and the
serving engine is held against it.  The reference's training fast path
(neox rope fused into the flash kernels) is not ported in this slice; a
forward without caches takes the same general path as the cache path.

Parameters live in ``config.dtype`` on the device given at construction
(``device=None`` is the CUDA card) and are initialized from an explicit
``torch.Generator`` (normal with ``initializer_range``; norms 1), or
loaded from the reference with ``testing.parity.load_paddle_tpu_weights``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..nn import functional as PF
from ..nn.layers import Embedding, Linear, RMSNorm

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
    """GQA attention with neox rotary embeddings over a dense K/V cache
    (the reference's cache path)."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
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

    def forward(self, x, cache: Optional[KVCache] = None,
                position_offset: int = 0):
        """``x`` [B, S, h]; ``cache`` the layer's (k, v) [B, L, Hkv, D] so
        far (or ``(None, None)``).  Returns ``(out, (k, v))`` with the new
        tokens appended (before the GQA repeat)."""
        B, S = x.shape[0], x.shape[1]
        q = self.q_proj(x).reshape(B, S, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(B, S, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(B, S, self.num_kv_heads, self.head_dim)
        q, k = PF.fused_rotary_position_embedding(
            q, k, position_offset=position_offset,
            rotary_emb_base=self.config.rope_theta)
        if cache is not None and cache[0] is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        new_cache = (k, v)
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = PF.scaled_dot_product_attention(q, k, v)
        out = self.o_proj(out.reshape(B, S, self.num_heads * self.head_dim))
        return out, new_cache


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

    def forward(self, x, cache: Optional[KVCache] = None,
                position_offset: int = 0):
        attn, new_cache = self.self_attn(self.input_layernorm(x), cache,
                                         position_offset)
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
        h = self.embed_tokens(input_ids)
        if caches is None:
            caches = [(None, None)] * len(self.layers)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            h, c = layer(h, cache, position_offset)
            new_caches.append(c)
        return self.norm(h), new_caches


class LlamaForCausalLM(nn.Module):
    """Llama with an LM head.  ``device=None`` places it on the CUDA card;
    ``generator`` (a ``torch.Generator`` on that device) initializes the
    weights — without one they are drawn from a generator seeded 0."""

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
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Normal(0, initializer_range) for every matrix, 1 for the norm
        weights, 0 for biases, drawn from ``generator``."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            if name.endswith("layernorm.weight") or name == "llama.norm.weight":
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)

    def lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return h @ self.llama.embed_tokens.weight.t()
        return self.lm_head(h)

    @torch.no_grad()
    def forward(self, input_ids, caches: Optional[List[KVCache]] = None,
                position_offset: int = 0):
        """``input_ids`` [B, S] -> ``(logits [B, S, V], new caches)``."""
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
        logits, caches = self(ids)
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


def param_count(config: LlamaConfig) -> int:
    h, i, v = config.hidden_size, config.intermediate_size, config.vocab_size
    L = config.num_hidden_layers
    kv = config.num_key_value_heads * (h // config.num_attention_heads)
    per_layer = h * h + 2 * h * kv + h * h + 3 * h * i + 2 * h
    emb = v * h * (1 if config.tie_word_embeddings else 2)
    return L * per_layer + emb + h
