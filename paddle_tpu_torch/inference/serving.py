"""Continuous batching over the paged KV cache (counterpart of
``paddle_tpu/inference/serving.py``, ``mixed_step=True``).

The scheduler keeps a fixed number of slots.  Every engine step packs the
whole admission mix — each running slot as a length-1 decode span, each
prefilling slot's next chunk as a span of up to ``prefill_chunk_size``
tokens, as many chunks as the top token budget holds — into ONE fused
``MixedStep`` over the ragged paged attention kernel.  Total tokens pad
to a small geometric budget set; padding tokens write to the sink page
and padding spans have ``q_len = 0``.

Ported: single device, greedy decoding, fp32/bf16 pools.  Every option of
the reference engine that this slice leaves out (the split engine,
sampling, speculative decoding, int8, tensor/context/expert parallelism,
the prefix cache and its host tier, lazy page allocation, tracing and
metrics, engine roles, explicit token budgets) raises ``NotImplementedError`` naming the feature
when it is asked for; none is silently ignored.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..core.device import DeviceLike, resolve_device
from ..jit.serving_step import MixedStep
from ..ops.paged_attention import PagedKVCache


@dataclass
class GenerationRequest:
    """One in-flight generation."""
    req_id: int
    prompt_ids: np.ndarray                 # [L] int
    max_new_tokens: int = 16
    eos_token_id: Optional[int] = None
    output_ids: List[int] = field(default_factory=list)
    state: str = "waiting"          # waiting -> prefilling -> running -> done

    # slot bookkeeping (set while admitted)
    slot: int = -1
    seq_len: int = 0
    block_ids: List[int] = field(default_factory=list)
    # chunked-prefill progress: prompt tokens already in cache pages
    prefill_pos: int = 0


def _unported(options: Dict[str, bool]) -> None:
    for name, asked in options.items():
        if asked:
            raise NotImplementedError(
                "%s is not ported to paddle_tpu_torch yet (this slice "
                "serves single-device greedy decoding through the mixed "
                "step with fp32/bf16 pools)" % name)


class ContinuousBatchingEngine:
    """Slot scheduler + fused mixed prefill+decode step for
    ``LlamaForCausalLM``.

    ``add_request()`` may be called at any time, including between steps
    while other requests are mid-decode; ``step()`` advances every running
    request by one token and every prefilling request by one chunk as far
    as the top budget holds.  Greedy: interleaved execution gives each
    request the tokens it would get alone.

    ``max_seq_len`` bounds prompt + generation per request and fixes the
    block-table width; it defaults to the pool's fair share per slot.
    ``prefill_chunk_size`` bounds one span (default: the reference's auto
    bucket top, ``min(pow2ceil(max_seq_len), 512)``).  ``token_budgets``
    is the reference's ``"auto"`` geometric set, from the slot count up
    past slots + chunk; an explicit tuple is not ported yet.

    ``device=None`` is the CUDA card (raises without one); the model must
    live on the same device.  Only ``mixed_step=True`` is ported.
    """

    def __init__(self, model, max_batch_size: int = 8,
                 num_blocks: int = 256, block_size: int = 16,
                 max_seq_len: Optional[int] = None,
                 prefill_chunk_size: Optional[int] = None,
                 mixed_step: bool = True, token_budgets="auto",
                 device: DeviceLike = None,
                 lazy_alloc: bool = False, prefill_buckets=None,
                 enable_prefix_cache: bool = False, mesh=None,
                 sharding=None, kv_dtype: Optional[str] = None,
                 weight_quant: Optional[str] = None,
                 quant_collectives: bool = False, sampling: bool = False,
                 draft_model=None, tracer=None, role: str = "mixed",
                 host_tier_bytes: int = 0):
        cfg = model.config
        _unported({
            "the split decode/prefill engine (mixed_step=False)":
                not mixed_step,
            "lazy page allocation (lazy_alloc)": bool(lazy_alloc),
            "bucketed prefill (prefill_buckets)":
                prefill_buckets is not None,
            "the prefix cache (enable_prefix_cache)":
                bool(enable_prefix_cache),
            "multi-device serving (mesh/sharding)":
                mesh is not None or sharding is not None,
            "int8 KV pools (kv_dtype='int8')": kv_dtype == "int8",
            "a KV pool dtype other than the model's (kv_dtype)":
                kv_dtype not in (None, "int8", cfg.dtype),
            "weight quantization (weight_quant)": weight_quant is not None,
            "quantized collectives (quant_collectives)":
                bool(quant_collectives),
            "stochastic sampling (sampling)": bool(sampling),
            "speculative decoding (draft_model)": draft_model is not None,
            "request tracing and metrics (tracer)":
                tracer not in (None, False),
            "engine roles (role)": role != "mixed",
            "the host page tier (host_tier_bytes)": bool(host_tier_bytes),
            "explicit token budgets (token_budgets other than 'auto')":
                token_budgets != "auto",
        })
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError("the model lives on %s but the engine serves "
                             "on %s" % (model.device, self.device))
        self.model = model
        self.cfg = cfg
        self.max_batch_size = max_batch_size
        self.block_size = block_size
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.caches = [
            PagedKVCache(num_blocks, block_size, cfg.num_key_value_heads,
                         self.head_dim, cfg.torch_dtype, sink_block=True,
                         device=self.device)
            for _ in range(cfg.num_hidden_layers)]
        if max_seq_len is None:
            max_seq_len = max(block_size,
                              num_blocks * block_size // max_batch_size)
        self.max_seq_len = max_seq_len
        self.bt_width = -(-max_seq_len // block_size)
        self._sink = self.caches[0].sink
        self.slots: List[Optional[GenerationRequest]] = \
            [None] * max_batch_size
        self.waiting: List[GenerationRequest] = []
        self.finished: Dict[int, GenerationRequest] = {}
        self._next_id = 0
        # each running slot's last sampled token (its next decode input)
        self._tokens = np.zeros((max_batch_size,), np.int32)

        self.chunk_size = int(prefill_chunk_size
                              or self._auto_buckets(self.max_seq_len)[-1])
        budgets = self._auto_budgets_mixed(max_batch_size, self.chunk_size)
        self.token_budgets = budgets
        self.mixed = MixedStep(model, self.caches, self.bt_width,
                               max_spans=max_batch_size,
                               span_q=min(self.chunk_size, budgets[-1]))
        # padding tokens spread over the sink page's slots
        self._dest_pad = (np.arange(budgets[-1], dtype=np.int32)
                          % block_size)
        self._chunk_rr = 0           # round-robin cursor over chunk work

    @staticmethod
    def _auto_buckets(max_seq_len: int):
        """Geometric 32/64/.../top, top = pow2 ceil of max_seq_len capped
        at 512 (longer prompts prefill in chunks of the top bucket)."""
        top = 1
        while top < max_seq_len:
            top *= 2
        top = min(top, 512)
        out = []
        b = 32
        while b < top:
            out.append(b)
            b *= 2
        out.append(top)
        return tuple(sorted({x for x in out if x <= top}))

    @staticmethod
    def _auto_budgets_mixed(slots: int, chunk: int):
        """Geometric total-token budgets: from the pow2 ceil of the slot
        count (the all-decode pack) doubling up past slots + chunk (every
        slot decoding while a full prefill chunk rides along)."""
        b = 1
        while b < max(1, slots):
            b *= 2
        out = [b]
        while b < slots + chunk:
            b *= 2
            out.append(b)
        return tuple(out)

    # ---- public API ----------------------------------------------------
    def add_request(self, prompt_ids, max_new_tokens: int = 16,
                    eos_token_id: Optional[int] = None,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 0.0, seed: int = 0, n: int = 1) -> int:
        """Queue one prompt; returns its req_id."""
        _unported({
            "stochastic sampling (temperature/top_k/top_p/seed)":
                bool(temperature or top_k or top_p or seed),
            "n > 1 generations per prompt (n)": n != 1,
        })
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        if len(prompt) == 0 or max_new_tokens < 1:
            raise ValueError("add_request needs a non-empty prompt and "
                             "max_new_tokens >= 1")
        need = self.caches[0].blocks_needed(len(prompt) + max_new_tokens)
        if need > self.bt_width:
            raise ValueError(
                "request needs %d pages but the engine's block-table width "
                "is %d (max_seq_len=%d); raise max_seq_len"
                % (need, self.bt_width, self.max_seq_len))
        if need > self.caches[0].num_blocks:
            raise ValueError(
                "request needs %d pages but the pool only has %d; raise "
                "num_blocks" % (need, self.caches[0].num_blocks))
        req = GenerationRequest(req_id=self._next_id, prompt_ids=prompt,
                                max_new_tokens=int(max_new_tokens),
                                eos_token_id=eos_token_id)
        self._next_id += 1
        self.waiting.append(req)
        return req.req_id

    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def step(self) -> List[int]:
        """Admit waiting requests, then run one fused mixed step.  Returns
        the req_ids finished this step."""
        self._admit()
        return self._run_mixed_step()

    def run_to_completion(self) -> Dict[int, List[int]]:
        while self.has_work():
            self.step()
        return {rid: r.output_ids for rid, r in self.finished.items()}

    def result(self, req_id: int) -> List[int]:
        return self.finished[req_id].output_ids

    # ---- admission -----------------------------------------------------
    def _admit(self):
        for i in range(self.max_batch_size):
            if not self.waiting or self.slots[i] is not None:
                continue
            if not self._try_admit(self.waiting[0], i):
                break                   # no room yet: keep waiting (FIFO)
            self.waiting.pop(0)

    def _try_admit(self, req: GenerationRequest, slot: int) -> bool:
        """Reserve the request's pages (prompt + budget) and queue its
        prefill chunks.  Returns False, with no side effects, when the pool
        cannot cover it yet."""
        cache = self.caches[0]
        need = cache.blocks_needed(len(req.prompt_ids) + req.max_new_tokens)
        if need > len(cache._free):
            return False
        req.block_ids = [cache.allocate_block() for _ in range(need)]
        req.prefill_pos = 0
        req.slot = slot
        req.state = "prefilling"
        self.slots[slot] = req
        return True

    def _complete_prefill(self, req: GenerationRequest, first: int):
        req.seq_len = len(req.prompt_ids)
        req.state = "running"
        self._append_token(req, first)
        if self.slots[req.slot] is req:     # still running after budget
            self._tokens[req.slot] = first

    # ---- fused mixed prefill+decode step -------------------------------
    def _fill_mixed_pack(self, mx: MixedStep, budgets, spans):
        """Fill one MixedStep pack from span tuples ``(req, tokens,
        start)``: the span's tokens land at global positions
        ``start..start+m-1`` (kv_len = start+m), pages from the request's
        block table.  Returns ``(pack, B)``."""
        total = sum(len(t) for _, t, _ in spans)
        B = next(b for b in budgets if b >= total)
        bs = self.block_size
        W = self.bt_width
        pack, tok_tab, span_tab = mx.new_pack(B)
        tokens, positions, dest_blocks, dest_offsets = tok_tab
        tokens[:] = 0
        positions[:] = 0
        # padding tokens: distinct sink-page slots (garbage on garbage)
        dest_blocks[:] = self._sink
        dest_offsets[:] = self._dest_pad[:B]
        # padding spans pin their offset past the last token so no real
        # token maps to them
        span_tab[:, :W] = self._sink
        span_tab[:, W] = B          # q_offset
        span_tab[:, W + 1] = 0      # q_len
        span_tab[:, W + 2] = 1      # kv_len
        span_tab[:, W + 3] = 0      # sample_row
        off = 0
        for si, (r, toks, start) in enumerate(spans):
            m = len(toks)
            row = span_tab[si]
            row[W] = off
            row[W + 1] = m
            row[W + 2] = start + m
            row[W + 3] = off + m - 1
            row[:len(r.block_ids)] = r.block_ids
            pos = np.arange(start, start + m, dtype=np.int32)
            tokens[off:off + m] = toks
            positions[off:off + m] = pos
            dest_blocks[off:off + m] = [r.block_ids[p // bs] for p in pos]
            dest_offsets[off:off + m] = pos % bs
            off += m
        return pack, B

    def _pick_chunks(self, room: int):
        """Pending prefill chunks for this step, round-robin over
        prefilling slots while ``room`` holds."""
        spans = []
        n = self.max_batch_size
        advanced_first = None
        for k in range(n):
            i = (self._chunk_rr + k) % n
            r = self.slots[i]
            if r is None or r.state != "prefilling":
                continue
            if room <= 0:
                break
            size = min(self.chunk_size,
                       len(r.prompt_ids) - r.prefill_pos, room)
            if size <= 0:
                continue
            spans.append((r, size, r.prefill_pos))
            room -= size
            if advanced_first is None:
                advanced_first = i
        if advanced_first is not None:
            self._chunk_rr = (advanced_first + 1) % n
        return spans

    def _pack_spans(self):
        """This step's ragged span set: every running slot's decode token
        (all must advance), then pending prefill chunks while the TOP
        budget has room."""
        spans = []                    # (req, kind, size, start)
        total = 0
        for r in self.slots:
            if r is not None and r.state == "running":
                spans.append((r, "decode", 1, r.seq_len))
                total += 1
        for r, size, start in self._pick_chunks(
                self.token_budgets[-1] - total):
            spans.append((r, "prefill", size, start))
            total += size
        return spans, total

    def _run_mixed_step(self) -> List[int]:
        """Pack the admission mix into ONE fused MixedStep, dispatch, then
        apply the decode / prefill bookkeeping."""
        done: List[int] = []
        spans, _ = self._pack_spans()
        if not spans:
            return done
        fill = [(r,
                 np.asarray([self._tokens[r.slot]], np.int32)
                 if kind == "decode"
                 else r.prompt_ids[start:start + size].astype(np.int32),
                 start)
                for r, kind, size, start in spans]
        pack, B = self._fill_mixed_pack(self.mixed, self.token_budgets,
                                        fill)
        nxt = self.mixed.call_packed(pack, B)
        for si, (r, kind, size, start) in enumerate(spans):
            tok = int(nxt[si])
            if kind == "decode":
                r.seq_len += 1
                self._append_token(r, tok)
                if self.slots[r.slot] is r:
                    self._tokens[r.slot] = tok
            else:
                r.prefill_pos += size
                if r.prefill_pos >= len(r.prompt_ids):
                    # final chunk: tok is the sampled first token
                    # (earlier chunks' samples are discarded)
                    self._complete_prefill(r, tok)
            if r.state == "done":
                done.append(r.req_id)
        return done

    def _append_token(self, req: GenerationRequest, token: int):
        req.output_ids.append(token)
        hit_eos = (req.eos_token_id is not None
                   and token == req.eos_token_id)
        if len(req.output_ids) >= req.max_new_tokens or hit_eos:
            self._finish(req)

    def _release_slot(self, req: GenerationRequest):
        """Mask the request's slot and release its pages through the ONE
        refcounted path."""
        if req.slot >= 0:
            self.slots[req.slot] = None
            self._tokens[req.slot] = 0
        self.caches[0].free_sequence(req.block_ids)
        req.block_ids = []

    def _finish(self, req: GenerationRequest):
        req.state = "done"
        self._release_slot(req)
        self.finished[req.req_id] = req
