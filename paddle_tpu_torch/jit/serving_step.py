"""The serving steps (counterpart of ``paddle_tpu/jit/serving_step.py``):
the fused mixed prefill+decode ``MixedStep``, and the split engine's
``DecodeStep`` (every slot one token), bucketed ``PrefillStep`` (one
padded prompt chunk) and ``prefill_scatter`` (the dense prefill's write).

Single device, greedy, over fp32/bf16 pools or int8 pools (quantize on
write, the int8 attention kernels on read).  The steps run eagerly (no
CUDA graphs yet); the reference's compiled modules have no counterpart,
but ``compile_counts`` still records each distinct token budget or
bucket width once (``compile_count`` the decode step's one slot count),
so the reference's bounds (shapes seen <= the set's size) read the same.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..ops.kernels import rope_qkv_epilogue, rope_tables_for_positions
from ..ops.paged_attention import (chunk_prefill_attention, paged_attention,
                                   ragged_paged_attention,
                                   ragged_tensor_cores, ragged_work,
                                   write_chunk_kv,
                                   write_chunk_kv_q8, write_decode_kv,
                                   write_decode_kv_q8, write_prefill_kv,
                                   write_ragged_kv, write_ragged_kv_q8)
from ..ops.sampling import greedy_sample


def _need_sink(caches, step: str) -> int:
    sink = caches[0].sink
    if sink < 0:
        raise ValueError("%s needs a sink page (PagedKVCache(sink_block="
                         "True)) to absorb padding and masked-slot writes"
                         % step)
    return sink


def _attend_layer(layer, x, cos, sin, cache, write, attend):
    """One decoder layer of a serving step over ``x`` [N, h]: RMSNorm, the
    q/k/v projections, the fused RoPE + QKV epilogue kernel (with the
    per-token absmax of k and v for an int8 pool), the in-place K/V write
    ``write(k, v, k_amax, v_amax)`` into ``cache``, the attention
    ``attend(q)`` -> [N, H, D], o_proj and the residual, then the MLP
    block."""
    N = x.shape[0]
    at = layer.self_attn
    H, Hkv, D = at.num_heads, at.num_kv_heads, at.head_dim
    h = layer.input_layernorm(x)
    q = at.q_proj(h).view(N, H, D)
    k = at.k_proj(h).view(N, Hkv, D)
    v = at.v_proj(h).view(N, Hkv, D)
    q, k, k_amax, v_amax = rope_qkv_epilogue(q, k, v, cos, sin,
                                             with_amax=cache.quantized)
    write(k, v, k_amax, v_amax)
    x = x + at.o_proj(attend(q).reshape(N, H * D))
    return x + layer.mlp(layer.post_attention_layernorm(x))


def prefill_scatter(caches: List, kv, block_table_row) -> None:
    """Write a densely prefilled request's per-layer K/V (``kv``: the
    model's cache-path ``(k, v)`` per layer, [1, L, Hkv, D] with rope
    applied, before the GQA repeat) into every layer's pool IN PLACE at
    positions 0..L-1 of ``block_table_row`` [1, W].  int8 pools prefill
    through ``PrefillStep``/``MixedStep`` (the engine rejects the dense
    prefill with them), so this raises for them, as the reference does."""
    if caches[0].quantized:
        raise NotImplementedError(
            "prefill_scatter is the dense prefill's write and does not "
            "quantize; int8 KV pools prefill through PrefillStep or "
            "MixedStep")
    dev = caches[0].key_cache.device
    bt = torch.as_tensor(np.asarray(block_table_row, np.int32), device=dev)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    for cache, (k, v) in zip(caches, kv):
        write_prefill_kv(k, v, cache.key_cache, cache.value_cache, bt,
                         start)


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
    per step; on the card with bf16 the ragged kernel's work list
    (``ragged_work``, built from the pack's span lengths) rides in the
    same copy.
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
        self.sink = _need_sink(caches, "MixedStep")
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
        D = cfg.hidden_size // cfg.num_attention_heads
        S, W = self.max_spans, self.bt_width
        scale = 1.0 / math.sqrt(D)
        span_q = min(self.span_q, T)

        c0 = self.caches[0]
        work = None
        if self.device.type == "cuda" and ragged_tensor_cores(
                cfg.torch_dtype, c0.quantized, c0.block_size, D):
            # the ragged kernel's work list, built here from the host
            # pack's span lengths and shipped in the pack's one copy
            spans = pack[4 * T:].reshape(S, W + self.row_extra)
            work_host = ragged_work(spans[:, W + 1], spans[:, W + 2],
                                    cfg.num_attention_heads,
                                    cfg.num_key_value_heads, c0.block_size)
            dev = torch.from_numpy(np.concatenate([pack, work_host])).to(
                self.device)
            dev_pack, work = dev[:pack.size], dev[pack.size:]
        else:
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
            def write(k, v, ka, va, c=cache):
                if c.quantized:
                    write_ragged_kv_q8(k, v, c.key_cache, c.value_cache,
                                       c.key_scale, c.value_scale,
                                       dest_blocks, dest_offsets, ka, va)
                else:
                    write_ragged_kv(k, v, c.key_cache, c.value_cache,
                                    dest_blocks, dest_offsets)

            def attend(q, c=cache):
                return ragged_paged_attention(
                    q, c.key_cache, c.value_cache, bt, q_offsets, q_lens,
                    kv_lens, scale, span_q=span_q, key_scale=c.key_scale,
                    value_scale=c.value_scale, work=work)
            x = _attend_layer(layer, x, cos, sin, cache, write, attend)
        x = llama.norm(x)
        return self.model.lm_logits(x[sample_rows]).to(torch.float32)

    def call_packed(self, pack: np.ndarray, T: int) -> np.ndarray:
        """Run one packed step; returns the [max_spans] int32 greedy
        samples (row i = span i's next token; padding spans and non-final
        chunks are discarded by the engine)."""
        return greedy_sample(self.logits_packed(pack, T)).cpu().numpy()


class PrefillStep:
    """One bucket-padded prompt chunk per call (reference:
    ``PrefillStep``), the split engine's bucketed/chunked prefill.

    ``__call__(tokens, start, n_valid, block_table_row)`` embeds the
    [1, C] padded chunk and, per layer, projects, applies RoPE at global
    positions ``start + i`` (the epilogue kernel), writes the chunk's K/V
    into the pages in place (padding to the sink page; quantized on write
    for int8 pools) and attends causally over everything cached so far
    (``chunk_prefill_attention``).  Only the last valid position reaches
    the LM head, and its greedy token is the one int32 that comes back.
    ``compile_counts`` records each bucket width C once.
    """

    def __init__(self, model, caches: List, bt_width: int):
        self.model = model
        self.caches = caches
        self.cfg = model.config
        self.bt_width = bt_width
        self.sink = _need_sink(caches, "PrefillStep")
        self.device = caches[0].key_cache.device
        self.compile_counts = {}       # bucket width -> 1 once seen

    @property
    def total_compiles(self) -> int:
        return sum(self.compile_counts.values())

    @torch.no_grad()
    def __call__(self, tokens, start: int, n_valid: int,
                 block_table_row) -> int:
        """``tokens`` [1, C] int32 bucket-padded; returns the greedy token
        after position ``start + n_valid - 1`` (meaningful on a prompt's
        final chunk).  The pools are updated in place."""
        tokens = np.asarray(tokens, np.int64)
        C = tokens.shape[1]
        self.compile_counts.setdefault(C, 1)
        cfg = self.cfg
        llama = self.model.llama
        D = cfg.hidden_size // cfg.num_attention_heads
        scale = 1.0 / math.sqrt(D)
        start, n_valid = int(start), int(n_valid)
        dev = self.device
        ids = torch.from_numpy(tokens[0]).to(dev)
        row = torch.from_numpy(np.asarray(block_table_row, np.int32)).to(dev)
        pos = start + torch.arange(C, dtype=torch.int32, device=dev)
        cos, sin = rope_tables_for_positions(pos, D, cfg.rope_theta)
        x = llama.embed_tokens(ids)                            # [C, h]
        for layer, cache in zip(llama.layers, self.caches):
            def write(k, v, ka, va, c=cache):
                if c.quantized:
                    write_chunk_kv_q8(k[None], v[None], c.key_cache,
                                      c.value_cache, c.key_scale,
                                      c.value_scale, row, start, n_valid,
                                      self.sink, ka, va)
                else:
                    write_chunk_kv(k[None], v[None], c.key_cache,
                                   c.value_cache, row, start, n_valid,
                                   self.sink)

            def attend(q, c=cache):
                return chunk_prefill_attention(
                    q[None], c.key_cache, c.value_cache, row, start, scale,
                    c.key_scale, c.value_scale)[0]
            x = _attend_layer(layer, x, cos, sin, cache, write, attend)
        last = llama.norm(x[n_valid - 1:n_valid])
        return int(greedy_sample(self.model.lm_logits(last))[0])


class DecodeStep:
    """Every slot advances one token (reference: ``DecodeStep``), at the
    engine's fixed slot count.

    ``__call__(tokens, seq_lens, block_tables)`` appends each slot's
    previous token's K/V at position ``seq_lens[b]`` and attends over
    ``seq_lens[b] + 1`` cached tokens through the paged decode attention
    kernel, per layer after the RoPE + QKV epilogue kernel.  Masked slots
    carry token 0, seq_len 0 and an all-sink block-table row, so their
    writes land on the sink page and their token is ignored.  The three
    host operands travel as ONE packed int32 buffer; only the [slots]
    int32 greedy tokens come back.  ``compile_count`` is 1 once the step
    ran (one slot count per engine).
    """

    def __init__(self, model, caches: List):
        self.model = model
        self.caches = caches
        self.cfg = model.config
        self.sink = _need_sink(caches, "DecodeStep")
        self.device = caches[0].key_cache.device
        self.compile_count = 0

    @torch.no_grad()
    def __call__(self, tokens, seq_lens, block_tables) -> np.ndarray:
        """``tokens``/``seq_lens`` [slots] and ``block_tables`` [slots, W]
        int32 host arrays; returns the [slots] int32 greedy tokens.  The
        pools are updated in place."""
        self.compile_count = 1
        cfg = self.cfg
        llama = self.model.llama
        D = cfg.hidden_size // cfg.num_attention_heads
        scale = 1.0 / math.sqrt(D)
        bt = np.asarray(block_tables, np.int32)
        S, W = bt.shape
        pack = np.concatenate([np.asarray(tokens, np.int32).reshape(S),
                               np.asarray(seq_lens, np.int32).reshape(S),
                               bt.reshape(-1)])
        dev_pack = torch.from_numpy(pack).to(self.device)
        tok = dev_pack[:S].long()
        lens = dev_pack[S:2 * S]
        bt_d = dev_pack[2 * S:].view(S, W)
        seen = lens + 1                                       # int32
        cos, sin = rope_tables_for_positions(lens, D, cfg.rope_theta)
        x = llama.embed_tokens(tok)                            # [S, h]
        for layer, cache in zip(llama.layers, self.caches):
            def write(k, v, ka, va, c=cache):
                if c.quantized:
                    write_decode_kv_q8(k, v, c.key_cache, c.value_cache,
                                       c.key_scale, c.value_scale, bt_d,
                                       lens, ka, va)
                else:
                    write_decode_kv(k, v, c.key_cache, c.value_cache, bt_d,
                                    lens)

            def attend(q, c=cache):
                return paged_attention(q, c.key_cache, c.value_cache, bt_d,
                                       seen, scale, c.key_scale,
                                       c.value_scale)
            x = _attend_layer(layer, x, cos, sin, cache, write, attend)
        x = llama.norm(x)
        return greedy_sample(self.model.lm_logits(x)).cpu().numpy()
