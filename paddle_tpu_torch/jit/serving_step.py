"""The serving steps (counterpart of ``paddle_tpu/jit/serving_step.py``):
the fused mixed prefill+decode ``MixedStep``, and the split engine's
``DecodeStep`` (every slot one token), bucketed ``PrefillStep`` (one
padded prompt chunk) and ``prefill_scatter`` (the dense prefill's write).

Single device, over fp32/bf16 pools or int8 pools (quantize on write,
the int8 attention kernels on read).  Greedy by default; ``sampling=True``
puts the ``ops/sampling`` epilogue in each step (per-row temperature,
top-k, top-p and seed, carried in the step's one packed int32 host
buffer, temperature and top-p bitcast into their int32 lanes; each draw
keyed by the global position of the token it samples), and
``MixedStep(spec_k=K)`` verifies speculative spans of K + 1 tokens while
``MixedStep(return_probs=True)`` is the sampled draft that returns its
filtered distributions.  The steps run eagerly (no CUDA graphs yet); the
reference's compiled modules have no counterpart, but ``compile_counts``
still records each distinct token budget or bucket width once
(``compile_count`` the decode step's one slot count), so the reference's
bounds (shapes seen <= the set's size) read the same.
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
from ..ops.sampling import (filtered_probs, greedy_sample, sample_logits,
                            spec_verify)


def _samp_knobs(samp: torch.Tensor):
    """A packed per-row sampling operand ``[..., 4]`` int32 -> ``(temps
    f32, top_ks i32, top_ps f32, seeds i32)``: temperature and top-p
    ride bitcast in their int32 lanes (reference: ``_samp_knobs``), so
    one dtype-uniform buffer carries every knob."""
    return (samp[..., 0].view(torch.float32), samp[..., 1],
            samp[..., 2].view(torch.float32), samp[..., 3])


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
    sampled on the device (greedy, or the sampling epilogue at counter
    kv_len, the sampled token's global position), so the step's only
    device-to-host traffic is one [max_spans] int32 fetch.

    ``spec_k=K`` makes the step a speculative verifier (reference:
    ``MixedStep(spec_k=...)``): a span's ``n_draft`` column says how many
    of its tokens after the first are draft proposals; each span's K + 1
    verify rows and its last row reach the LM head, and
    ``ops/sampling.spec_verify`` returns the accepted count and the
    correction or bonus token.  ``return_probs=True`` (sampled drafts
    only) also returns the filtered distributions of the sampled rows,
    left on the device.  A step is never both.

    Host operand: ONE packed int32 buffer of ``4T + S*(W+EX)`` values (the
    reference's layout, see :meth:`new_pack`; ``EX`` = 4, + 1 ``n_draft``
    column under spec, + 4 knob columns under sampling), copied to the
    device once per step; on the card with bf16 the ragged kernel's work
    list (``ragged_work``, built from the pack's span lengths) rides in
    the same copy.
    """

    def __init__(self, model, caches: List, bt_width: int, max_spans: int,
                 span_q: int, sampling: bool = False, spec_k: int = 0,
                 return_probs: bool = False):
        self.model = model
        self.caches = caches
        self.cfg = model.config
        self.bt_width = bt_width
        self.max_spans = max_spans
        self.span_q = max(1, int(span_q))   # static max span length
        self.sampling = bool(sampling)
        self.spec_k = int(spec_k)
        self.return_probs = bool(return_probs)
        if self.return_probs and not self.sampling:
            raise ValueError(
                "MixedStep return_probs=True exists for the SAMPLED draft "
                "role (the verifier's residual needs the draft's filtered "
                "distribution); a greedy draft is a delta — construct with "
                "sampling=True or drop return_probs")
        if self.spec_k and self.return_probs:
            raise ValueError("MixedStep cannot be verifier (spec_k) and "
                             "draft (return_probs) at once")
        if self.spec_k and self.span_q < self.spec_k + 1:
            raise ValueError(
                "span_q=%d cannot cover a length-%d verify span (spec_k=%d):"
                " the attention kernel's span window must be >= every q_len"
                % (self.span_q, self.spec_k + 1, self.spec_k))
        # the span-row tail past the block-table columns: the 4 standard
        # descriptors, + the n_draft column under spec, + the 4 bitcast
        # sampling-knob columns under sampling
        self.row_extra = (4 + (1 if self.spec_k else 0)
                          + (4 if self.sampling else 0))
        self.sink = _need_sink(caches, "MixedStep")
        self.device = caches[0].key_cache.device
        self.compile_counts = {}       # token budget -> 1 once seen

    @property
    def total_compiles(self) -> int:
        return sum(self.compile_counts.values())

    def new_pack(self, T: int):
        """Allocate the step's single host buffer: ``(pack, tok_tab,
        span_tab)`` where ``tok_tab`` [4, T] (rows tokens / positions /
        dest block / dest offset) and ``span_tab`` [max_spans, W + EX]
        (block-table columns, then q_offset / q_len / kv_len / sample_row,
        + n_draft under spec, + the 4 knob columns under sampling) are
        views into ``pack``.  The extra tail columns come zeroed (greedy,
        no drafts)."""
        S, W = self.max_spans, self.bt_width
        pack = np.empty(4 * T + S * (W + self.row_extra), np.int32)
        span_tab = pack[4 * T:].reshape(S, W + self.row_extra)
        if self.row_extra > 4:
            span_tab[:, W + 4:] = 0
        return pack, pack[:4 * T].reshape(4, T), span_tab

    @torch.no_grad()
    def _forward(self, pack: np.ndarray, T: int):
        """The layers over one packed step: returns the final-normed
        hidden rows ``[T, h]`` and the device pack's ``(tok_tab,
        span_tab)`` (the pools are updated in place)."""
        if T not in self.compile_counts:
            self.compile_counts[T] = 1
        cfg = self.cfg
        llama = self.model.llama
        D = cfg.hidden_size // cfg.num_attention_heads
        S, W, EX = self.max_spans, self.bt_width, self.row_extra
        scale = 1.0 / math.sqrt(D)
        span_q = min(self.span_q, T)

        c0 = self.caches[0]
        work = None
        if self.device.type == "cuda" and ragged_tensor_cores(
                cfg.torch_dtype, c0.quantized, c0.block_size, D,
                cfg.num_attention_heads // cfg.num_key_value_heads):
            # the ragged kernel's work list, built here from the host
            # pack's span lengths and shipped in the pack's one copy
            spans = pack[4 * T:].reshape(S, W + EX)
            work_host = ragged_work(spans[:, W + 1], spans[:, W + 2],
                                    cfg.num_attention_heads,
                                    cfg.num_key_value_heads, c0.block_size)
            dev = torch.from_numpy(np.concatenate([pack, work_host])).to(
                self.device)
            dev_pack, work = dev[:pack.size], dev[pack.size:]
        else:
            dev_pack = torch.from_numpy(pack).to(self.device)
        tok_tab = dev_pack[:4 * T].view(4, T)
        span_tab = dev_pack[4 * T:].view(S, W + EX)
        tokens = tok_tab[0].long()
        dest_blocks = tok_tab[2].long()
        dest_offsets = tok_tab[3].long()
        bt = span_tab[:, :W].contiguous()
        q_offsets = span_tab[:, W].contiguous()
        q_lens = span_tab[:, W + 1].contiguous()
        kv_lens = span_tab[:, W + 2].contiguous()

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
        return llama.norm(x), tok_tab, span_tab

    def logits_packed(self, pack: np.ndarray, T: int) -> torch.Tensor:
        """Run one packed step and return the fp32 logits of each span's
        sample row, ``[max_spans, V]`` on the device (the pools are
        updated in place)."""
        x, _, span_tab = self._forward(pack, T)
        rows = span_tab[:, self.bt_width + 3].long()
        with torch.no_grad():
            return self.model.lm_logits(x[rows]).to(torch.float32)

    @torch.no_grad()
    def call_packed(self, pack: np.ndarray, T: int, q_probs=None):
        """Run one packed step.  Returns the [max_spans] int32 samples (row
        i = span i's next token; padding spans and non-final chunks are
        discarded by the engine); a verifier (``spec_k``) returns
        ``(tokens, n_acc)`` and, when sampled, takes ``q_probs`` (a tuple
        of K device [max_spans, V] draft distributions); a draft
        (``return_probs``) returns ``(tokens, probs)`` with the probs
        left on the device."""
        if self.spec_k and self.sampling and q_probs is None:
            raise ValueError("sampled speculative verify needs the draft's "
                             "q_probs tuple (zeros when no span drafts)")
        S, W, K = self.max_spans, self.bt_width, self.spec_k
        x, tok_tab, span_tab = self._forward(pack, T)
        q_offsets = span_tab[:, W].long()
        q_lens = span_tab[:, W + 1].long()
        kv_lens = span_tab[:, W + 2]
        col = W + 4 + (1 if K else 0)
        knobs = None
        if self.sampling:
            knobs = _samp_knobs(span_tab[:, col:col + 4])
        if K:
            # each span's K + 1 verify rows (clamped to its last row), then
            # its sample row: [S * (K + 2)] rows reach the LM head
            ar = torch.arange(K + 1, device=x.device)
            last = q_offsets + torch.clamp_min(q_lens - 1, 0)
            vrow = torch.minimum(q_offsets[:, None] + ar[None, :],
                                 last[:, None])
            rows = torch.cat([vrow, span_tab[:, W + 3].long()[:, None]],
                             dim=1).reshape(-1).clamp(0, T - 1)
            lv3 = self.model.lm_logits(x[rows]).to(torch.float32).view(
                S, K + 2, -1)
            didx = torch.clamp(q_offsets[:, None] + 1 + ar[None, :K], 0,
                               T - 1)
            d_toks = tok_tab[0][didx]           # the spans' fed drafts
            n_draft = span_tab[:, W + 4]
            base_pos = kv_lens - span_tab[:, W + 1] + 1
            if self.sampling:
                n_acc, e_v = spec_verify(lv3[:, :K + 1], d_toks, n_draft,
                                         *knobs, base_pos,
                                         torch.stack(tuple(q_probs), 1))
                e_p = sample_logits(lv3[:, K + 1], *knobs, kv_lens)
            else:
                zf = torch.zeros(S, device=x.device)
                zi = torch.zeros(S, dtype=torch.int32, device=x.device)
                n_acc, e_v = spec_verify(lv3[:, :K + 1], d_toks, n_draft,
                                         zf, zi, zf, zi, base_pos)
                e_p = greedy_sample(lv3[:, K + 1])
            nxt = torch.where(n_draft > 0, e_v, e_p)
            out = torch.stack([nxt, n_acc]).cpu().numpy()
            return out[0], out[1]
        lv = self.model.lm_logits(x[span_tab[:, W + 3].long()]).to(
            torch.float32)
        if not self.sampling:
            return greedy_sample(lv).cpu().numpy()
        # counter = kv_len, the sampled token's global position: the same
        # counter the split steps use, so seeded tokens agree across
        # engines
        nxt = sample_logits(lv, *knobs, kv_lens)
        if self.return_probs:
            return nxt.cpu().numpy(), filtered_probs(lv, *knobs[:3])
        return nxt.cpu().numpy()


class PrefillStep:
    """One bucket-padded prompt chunk per call (reference:
    ``PrefillStep``), the split engine's bucketed/chunked prefill.

    ``__call__(tokens, start, n_valid, block_table_row)`` embeds the
    [1, C] padded chunk and, per layer, projects, applies RoPE at global
    positions ``start + i`` (the epilogue kernel), writes the chunk's K/V
    into the pages in place (padding to the sink page; quantized on write
    for int8 pools) and attends causally over everything cached so far
    (``chunk_prefill_attention``).  Only the last valid position reaches
    the LM head, and its token (greedy, or with ``sampling=True`` the
    sampling epilogue at counter ``start + n_valid``, the sampled token's
    global position) is the one int32 that comes back.  The tokens, the
    block-table row and the knobs cross to the device as one int32 copy.
    ``compile_counts`` records each bucket width C once.
    """

    def __init__(self, model, caches: List, bt_width: int,
                 sampling: bool = False):
        self.model = model
        self.caches = caches
        self.cfg = model.config
        self.bt_width = bt_width
        self.sampling = bool(sampling)
        self.sink = _need_sink(caches, "PrefillStep")
        self.device = caches[0].key_cache.device
        self.compile_counts = {}       # bucket width -> 1 once seen

    @property
    def total_compiles(self) -> int:
        return sum(self.compile_counts.values())

    @torch.no_grad()
    def __call__(self, tokens, start: int, n_valid: int,
                 block_table_row, samp=None) -> int:
        """``tokens`` [1, C] int32 bucket-padded; returns the token after
        position ``start + n_valid - 1`` (meaningful on a prompt's final
        chunk).  ``samp`` (sampling steps): the request's [4] int32 knobs
        (None: greedy).  The pools are updated in place."""
        tokens = np.asarray(tokens, np.int32)
        C = tokens.shape[1]
        self.compile_counts.setdefault(C, 1)
        cfg = self.cfg
        llama = self.model.llama
        D = cfg.hidden_size // cfg.num_attention_heads
        scale = 1.0 / math.sqrt(D)
        start, n_valid = int(start), int(n_valid)
        dev = self.device
        row_host = np.asarray(block_table_row, np.int32).reshape(-1)
        parts = [tokens[0], row_host]
        if self.sampling:
            samp = (np.zeros(4, np.int32) if samp is None
                    else np.asarray(samp, np.int32).reshape(4))
            parts.append(samp)
        dev_pack = torch.from_numpy(np.concatenate(parts)).to(dev)
        ids = dev_pack[:C].long()
        row = dev_pack[C:C + row_host.size].view(1, -1)
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
        logits = self.model.lm_logits(last)
        if not self.sampling:
            return int(greedy_sample(logits)[0])
        # first-token sample: counter = start + n_valid, the sampled
        # token's position (the prompt length on the final chunk)
        knobs = _samp_knobs(dev_pack[C + row_host.size:].view(1, 4))
        ctr = torch.full((1,), start + n_valid, dtype=torch.int32,
                         device=dev)
        return int(sample_logits(logits, *knobs, ctr)[0])


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
    int32 tokens come back: greedy, or with ``sampling=True`` the
    sampling epilogue over the per-slot knobs (counter ``seq_lens + 1``,
    the sampled token's global position), the knobs riding in the same
    packed buffer.  ``compile_count`` is 1 once the step ran (one slot
    count per engine).
    """

    def __init__(self, model, caches: List, sampling: bool = False):
        self.model = model
        self.caches = caches
        self.cfg = model.config
        self.sampling = bool(sampling)
        self.sink = _need_sink(caches, "DecodeStep")
        self.device = caches[0].key_cache.device
        self.compile_count = 0

    @torch.no_grad()
    def __call__(self, tokens, seq_lens, block_tables,
                 samp=None) -> np.ndarray:
        """``tokens``/``seq_lens`` [slots] and ``block_tables`` [slots, W]
        int32 host arrays; ``samp`` (sampling steps only) the [slots, 4]
        int32 per-slot knobs (temperature bits, top_k, top_p bits, seed;
        greedy slots temperature 0).  Returns the [slots] int32 tokens.
        The pools are updated in place."""
        if self.sampling and samp is None:
            raise ValueError("a sampling DecodeStep needs the per-slot knob "
                             "array (the engine fills it; greedy slots are "
                             "temperature 0)")
        self.compile_count = 1
        cfg = self.cfg
        llama = self.model.llama
        D = cfg.hidden_size // cfg.num_attention_heads
        scale = 1.0 / math.sqrt(D)
        bt = np.asarray(block_tables, np.int32)
        S, W = bt.shape
        parts = [np.asarray(tokens, np.int32).reshape(S),
                 np.asarray(seq_lens, np.int32).reshape(S), bt.reshape(-1)]
        if self.sampling:
            samp = np.asarray(samp, np.int32).reshape(S, 4)
            parts.append(samp.reshape(-1))
        dev_pack = torch.from_numpy(np.concatenate(parts)).to(self.device)
        tok = dev_pack[:S].long()
        lens = dev_pack[S:2 * S]
        bt_d = dev_pack[2 * S:2 * S + S * W].view(S, W)
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
        logits = self.model.lm_logits(llama.norm(x))
        if not self.sampling:
            return greedy_sample(logits).cpu().numpy()
        knobs = _samp_knobs(dev_pack[2 * S + S * W:].view(S, 4))
        return sample_logits(logits, *knobs, seen).cpu().numpy()
