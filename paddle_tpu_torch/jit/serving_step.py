"""The fused mixed prefill+decode serving step (counterpart of
``paddle_tpu/jit/serving_step.py`` ``MixedStep``).

Single device, greedy, fp32/bf16 pools.  The step runs eagerly (no CUDA
graphs yet); the reference's per-budget compiled modules have no
counterpart, but ``compile_counts`` still records each distinct token
budget once, so the reference's bound (budgets seen <= budget-set size)
reads the same.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..ops.kernels import rope_qkv_epilogue, rope_tables_for_positions
from ..ops.paged_attention import ragged_paged_attention, write_ragged_kv
from ..ops.sampling import greedy_sample


class MixedStep:
    """One launch sequence per engine step that advances ANY admission
    mix — running decode slots and pending prefill chunks together
    (Ragged Paged Attention, arXiv:2604.15464).

    The engine packs its work into a ragged token batch: every running
    slot contributes a length-1 decode span, every prefilling slot a
    length-C chunk span, concatenated on the token axis and padded to the
    smallest budget of a small geometric set.  The step embeds the packed
    tokens and, per layer, runs RMSNorm -> q/k/v projections -> the fused
    RoPE + QKV epilogue kernel (at each token's global position) -> an
    in-place scatter of K/V into the page pools (padding to the sink
    page) -> the ragged paged attention kernel -> o_proj + residual ->
    RMSNorm -> SwiGLU MLP + residual.  Only each span's sample row reaches
    the LM head — the [T, V] logits block is never materialized — and is
    greedy-sampled on the device, so the step's only device-to-host
    traffic is one [max_spans] int32 fetch.

    Host operand: ONE packed int32 buffer of ``4T + S*(W+4)`` values (the
    reference's layout, see :meth:`new_pack`), copied to the device once
    per step.
    """

    row_extra = 4      # q_offset / q_len / kv_len / sample_row

    def __init__(self, model, caches: List, bt_width: int, max_spans: int,
                 span_q: int):
        self.model = model
        self.caches = caches
        self.cfg = model.config
        self.bt_width = bt_width
        self.max_spans = max_spans
        self.span_q = max(1, int(span_q))   # static max span length
        self.sink = caches[0].sink
        if self.sink < 0:
            raise ValueError("MixedStep needs a sink page "
                             "(PagedKVCache(sink_block=True)) to mask "
                             "budget-padding writes")
        self.device = caches[0].key_cache.device
        self.compile_counts = {}       # token budget -> 1 once seen

    @property
    def total_compiles(self) -> int:
        return sum(self.compile_counts.values())

    def new_pack(self, T: int):
        """Allocate the step's single host buffer: ``(pack, tok_tab,
        span_tab)`` where ``tok_tab`` [4, T] (rows tokens / positions /
        dest block / dest offset) and ``span_tab`` [max_spans, W + 4]
        (block-table columns, then q_offset / q_len / kv_len /
        sample_row) are views into ``pack``."""
        S, W = self.max_spans, self.bt_width
        pack = np.empty(4 * T + S * (W + self.row_extra), np.int32)
        span_tab = pack[4 * T:].reshape(S, W + self.row_extra)
        return pack, pack[:4 * T].reshape(4, T), span_tab

    @torch.no_grad()
    def logits_packed(self, pack: np.ndarray, T: int) -> torch.Tensor:
        """Run one packed step and return the fp32 logits of each span's
        sample row, ``[max_spans, V]`` on the device (the pools are
        updated in place)."""
        if T not in self.compile_counts:
            self.compile_counts[T] = 1
        cfg = self.cfg
        llama = self.model.llama
        H = cfg.num_attention_heads
        Hkv = cfg.num_key_value_heads
        D = cfg.hidden_size // H
        S, W = self.max_spans, self.bt_width
        scale = 1.0 / math.sqrt(D)
        span_q = min(self.span_q, T)

        dev_pack = torch.from_numpy(pack).to(self.device)
        tok_tab = dev_pack[:4 * T].view(4, T)
        span_tab = dev_pack[4 * T:].view(S, W + self.row_extra)
        tokens = tok_tab[0].long()
        dest_blocks = tok_tab[2].long()
        dest_offsets = tok_tab[3].long()
        bt = span_tab[:, :W].contiguous()
        q_offsets = span_tab[:, W].contiguous()
        q_lens = span_tab[:, W + 1].contiguous()
        kv_lens = span_tab[:, W + 2].contiguous()
        sample_rows = span_tab[:, W + 3].long()

        x = llama.embed_tokens(tokens)                         # [T, h]
        # rope tables built ONCE per step: positions are layer-invariant
        cos, sin = rope_tables_for_positions(tok_tab[1], D, cfg.rope_theta)
        for layer, cache in zip(llama.layers, self.caches):
            h = layer.input_layernorm(x)
            at = layer.self_attn
            q = at.q_proj(h).view(T, H, D)
            k = at.k_proj(h).view(T, Hkv, D)
            v = at.v_proj(h).view(T, Hkv, D)
            q, k, _, _ = rope_qkv_epilogue(q, k, v, cos, sin)
            write_ragged_kv(k, v, cache.key_cache, cache.value_cache,
                            dest_blocks, dest_offsets)
            out = ragged_paged_attention(q, cache.key_cache,
                                         cache.value_cache, bt, q_offsets,
                                         q_lens, kv_lens, scale,
                                         span_q=span_q)
            x = x + at.o_proj(out.view(T, H * D))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        x = llama.norm(x)
        return self.model.lm_logits(x[sample_rows]).to(torch.float32)

    def call_packed(self, pack: np.ndarray, T: int) -> np.ndarray:
        """Run one packed step; returns the [max_spans] int32 greedy
        samples (row i = span i's next token; padding spans and non-final
        chunks are discarded by the engine)."""
        return greedy_sample(self.logits_packed(pack, T)).cpu().numpy()
