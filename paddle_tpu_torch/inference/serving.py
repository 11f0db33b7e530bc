"""Continuous batching over the paged KV cache (counterpart of
``paddle_tpu/inference/serving.py``).

The scheduler keeps a fixed number of slots.  Two engines, as in the
reference:

- **Split** (``mixed_step=False``, the default).  Every ``step()`` admits
  waiting requests, advances at most one pending prefill chunk, then runs
  ONE ``DecodeStep`` over all slots (the paged decode attention kernel;
  masked slots write to the sink page).  A request prefills at admission
  through the dense model forward and ``prefill_scatter``
  (``prefill_buckets=None``), or through the bucketed ``PrefillStep``:
  at once when its prompt fits one chunk, otherwise one chunk per step,
  round-robin over prefilling slots.
- **Mixed** (``mixed_step=True``).  Every step packs each running slot as
  a length-1 decode span and as many pending prefill chunks as the top
  token budget holds into ONE fused ``MixedStep`` over the ragged paged
  attention kernel.  Total tokens pad to a small geometric budget set;
  padding tokens write to the sink page and padding spans have
  ``q_len = 0``.

Both engines take ``kv_dtype="int8"`` (int8 pools with per-page, per-head
scales; quantize on write, the int8 attention kernels on read; the dense
prefill cannot write them) and ``lazy_alloc=True`` (pages allocated as a
sequence grows; when the pool runs dry mid-decode the victim finishes
early with ``truncated=True`` instead of ``step()`` raising).

``sampling=True`` (a compiled prefill path: the mixed engine or
bucketed prefill) samples each request with its own ``temperature``,
``top_k``, ``top_p`` and ``seed`` (``ops/sampling.py``: every draw keyed
by the request's seed and the sampled token's global position, so a
request samples the same tokens alone or batched, through either engine,
as the reference's engine does).  ``draft_model=`` with ``spec_k`` (the
mixed engine) decodes speculatively: each round the draft model, with its
own pools addressed by the same page ids, proposes up to ``spec_k``
tokens a slot in ``spec_k`` fused launches, and ONE target launch
verifies every slot's ``spec_k + 1`` positions (greedy: byte-identical
to non-speculative greedy; sampled: rejection resampling, exact in
distribution).  ``spec_proposed`` / ``spec_accepted`` count the draft
tokens.

``enable_prefix_cache=True`` (a compiled prefill path) shares prompt
prefixes through refcounted pages (``inference/prefix_cache.py``): a
request whose prompt starts with full pages an earlier prefill published
shares them into its block table and prefills only its suffix; a hit that
covers the whole prompt re-runs the last position on a private copy of
the last shared page (copy-on-write), so shared pages are never written.
Pages are allocated through the cache, which evicts unreferenced table
pages under pressure, and with ``host_tier_bytes`` spills them to a
host-RAM tier in one batched copy and restores them on a later hit.
``add_request(n=...)`` queues ``n`` generations of one prompt (seeds
``seed + i``) that share its one prefill: the children admit as
whole-prompt hits once the first generation's prefill has published the
pages.  ``prefill_tokens`` counts the prompt tokens the steps prefilled.

``weight_quant="int8"`` (a compiled prefill path) quantizes the
projection weights once at construction, per output channel
(``quantization.functional.quantize_param_tree``), into an
:class:`~paddle_tpu_torch.ops.dequant.Int8Weights` tree; the target's
steps dequantize each layer's weights on use into one reused scratch
(``ops/dequant.py``, one launch a layer and one for the LM head).  The
model's own parameters are untouched, so an eager ``generate`` or another
engine on the same model still sees the fp weights; a draft model stays
fp, as in the reference.  ``weight_quant_bytes`` counts codes and scales.

The admission-plane surface (the reference's): ``tracer=`` (default on,
``False`` the no-op stub) records each request's typed phase spans
(admit with the prefix hit, prefill chunks, sampled decode steps, first
token, preempt, finish) and the engine records the ``serving_*`` metric
families into the port's registry (``observability``); ``counters`` and
:meth:`health_payload` give an admission plane the engine's load;
:meth:`preempt_request` pulls a request out through the refcounted
release path; :meth:`extract_request` / :meth:`inject_request` move a
running request's KV pages to another engine as one host
``KVPageBuffer`` (the reference's wire format, so buffers travel between
the two packages' engines) and resume it there with zero re-prefill;
``role="prefill"|"decode"|"mixed"`` labels the engine for the router's
disaggregated dispatch (``inference/router.py``); :meth:`efficiency_stats`
counts one launch of the steady-state serving step for the capacity plane
(``observability/capacity.py``), and ``inference/engine_server.py``
serves an engine to other processes (``inference/fleet.py``).

``mesh=`` (a ``distributed.process_mesh.ProcessMesh`` with ``tp``,
``ep``, ``cp``, ``fsdp`` and/or ``dp`` axes, e.g. ``jit.spmd.tp_mesh(2,
backend="gloo")``, ``cp_mesh(2, ...)``, ``mesh_2d(2, 2, ...)``;
``sharding=`` a ``jit.spmd.ShardingConfig``) serves over
``torch.distributed`` ranks, one process each (the reference's ``mesh=``
engines, its checks at construction).  Every rank constructs the same
engine over its own shard of the model (``jit.spmd.shard_model``): the
pools hold the rank's kv heads (tp) and its slot stripe of every page
(cp: ``block_size / cp`` slots, the stripe partials merged over the cp
ranks), the steps run the rank's heads, vocabulary rows and FFN columns
(or, over ep, its experts) with the reference's collectives between them,
a rank stores ``1/(fsdp·tp)`` of each fsdp-sharded weight and gathers its
tp shard back one group at a time at every dispatch, a ``dp`` axis
replicates, and ``quant_collectives=True`` makes the logits all-gather
int8.  Rank 0 is the driver: it schedules, serves the public API and
writes every device operation — a step's one packed int32 array, a
copy-on-write page copy — into one control broadcast; ranks > 0 call
:meth:`run_worker` and replay them in order until
:meth:`shutdown_workers`.  As in the reference, speculative decoding, the
host spill tier and page migration are single-chip, the dense prefill
cannot feed sharded pools, and cp refuses int8 pools and a block size it
does not divide (``jit.spmd.validate_cp_serving``).

What still raises ``NotImplementedError`` naming the feature (none is
silently ignored): a pool dtype other than the model's or int8.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from ..core.device import DeviceLike, resolve_device
from ..distributed.collective import broadcast
from ..jit.serving_step import (DecodeStep, MixedStep, PrefillStep,
                                copy_block, extract_blocks, inject_blocks,
                                prefill_scatter)
from ..observability import default_registry
from ..observability.request_trace import resolve_tracer
from ..ops.dequant import Int8Weights
from ..ops.paged_attention import PagedKVCache
from ..ops.sampling import DRAFT_SEED_XOR
from .prefix_cache import HostPageTier, PrefixPageCache

# process-wide engine-id sequence: a multi-engine router needs a stable
# identity per engine for health gauges and the /healthz payload
_ENGINE_IDS = itertools.count()

# a sharded engine's control operations (rank 0 -> ranks > 0): the buffer
# is a header of _CTL_HEADER int32 (the op, then its scalars) and the
# operation's packed int32 operands
_OP_SHUTDOWN, _OP_MIXED, _OP_PREFILL, _OP_DECODE, _OP_COPY_BLOCK = range(5)
_CTL_HEADER = 8


@dataclass
class GenerationRequest:
    """One in-flight generation."""
    req_id: int
    prompt_ids: np.ndarray                 # [L] int
    max_new_tokens: int = 16
    eos_token_id: Optional[int] = None
    output_ids: List[int] = field(default_factory=list)
    state: str = "waiting"          # waiting -> prefilling -> running -> done
    # True when the pool ran dry mid-decode (lazy_alloc) and the engine
    # finished this request early instead of wedging the batch
    truncated: bool = False

    # slot bookkeeping (set while admitted)
    slot: int = -1
    seq_len: int = 0
    block_ids: List[int] = field(default_factory=list)
    # chunked-prefill progress: prompt tokens already in cache pages
    # (starts at the prefix-cache hit length)
    prefill_pos: int = 0
    # prompt tokens served from shared prefix pages instead of recompute
    prefix_hit_tokens: int = 0
    # stochastic sampling: temperature <= 0 is exact greedy; seed feeds
    # the per-position counter-based generator
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int = 0
    # n > 1 generations: a child admits only after its parent's prefill
    # published the shared prefix pages
    parent_req: Optional["GenerationRequest"] = field(default=None,
                                                     repr=False)
    # speculative decoding: positions [0, draft_len) hold draft-model KV
    # for the accepted token sequence
    draft_len: int = 0
    # perf_counter marks: submit -> first token = TTFT, first token ->
    # done over n - 1 tokens = TPOT
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0


_PORT_SCOPE = ("the port serves through the split or mixed engine, greedy "
               "or sampled, with model-dtype or int8 pools, int8 weights, "
               "an optional draft model and the prefix cache, on one "
               "device or over a tp, ep, cp, fsdp or replica mesh of "
               "torch.distributed ranks")


def _unported(options: Dict[str, bool]) -> None:
    for name, asked in options.items():
        if asked:
            raise NotImplementedError(
                "%s is not ported to paddle_tpu_torch yet (%s)"
                % (name, _PORT_SCOPE))


class ContinuousBatchingEngine:
    """Slot scheduler over the split decode/prefill steps or the fused
    mixed step, for ``LlamaForCausalLM``, ``Qwen2ForCausalLM`` or
    ``MixtralForCausalLM`` (the MoE layers through the dropless
    ``ops.moe_gate.moe_ffn``; the mixed engine counts their assignments
    in ``serving_moe_dispatch_tokens_total``).

    ``add_request()`` may be called at any time, including between steps
    while other requests are mid-decode; ``step()`` advances every running
    request by one token.  Greedy: interleaved execution gives each
    request the tokens it would get alone.

    ``max_seq_len`` bounds prompt + generation per request and fixes the
    block-table width; it defaults to the pool's fair share per slot.
    ``prefill_buckets`` (split engine): ``None`` for the dense prefill,
    ``"auto"`` for the reference's geometric set (32, 64, ... up to
    ``min(pow2ceil(max_seq_len), 512)``), or a tuple of widths.
    ``prefill_chunk_size`` bounds one chunk (default: the top bucket).
    ``token_budgets`` (mixed engine) is the reference's ``"auto"``
    geometric set, from the slot count (times ``spec_k + 1`` with a
    draft) up past that + chunk, or a tuple of totals (its top must hold
    an all-decode pack).  ``sampling``, ``draft_model``/``spec_k``,
    ``enable_prefix_cache`` and ``host_tier_bytes`` (the cache's host
    spill tier, in bytes): see the module notes.

    ``weight_quant`` (``None`` or ``"int8"``), ``tracer``, ``role``,
    ``engine_id``, ``mesh``, ``sharding`` and ``quant_collectives``: see
    the module notes (``tp_degree``, ``ep_degree`` and ``tp``, the
    ``jit.spmd.TPContext`` or None, say how the engine is sharded).

    ``device=None`` is the CUDA card (raises without one); the model must
    live on the same device.
    """

    def __init__(self, model, max_batch_size: int = 8,
                 num_blocks: int = 256, block_size: int = 16,
                 max_seq_len: Optional[int] = None,
                 lazy_alloc: bool = False, prefill_buckets=None,
                 prefill_chunk_size: Optional[int] = None,
                 enable_prefix_cache: bool = False,
                 mixed_step: bool = False, token_budgets="auto",
                 mesh=None, sharding=None, kv_dtype: Optional[str] = None,
                 weight_quant: Optional[str] = None,
                 quant_collectives: bool = False, sampling: bool = False,
                 draft_model=None, spec_k: int = 2,
                 engine_id: Optional[int] = None, tracer=None,
                 role: str = "mixed",
                 host_tier_bytes: int = 0, device: DeviceLike = None):
        cfg = model.config
        # a router sends fresh prompts to "prefill" engines and migrates
        # their finished pages to "decode" engines; "mixed" takes anything
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(
                "ContinuousBatchingEngine role must be 'prefill', "
                "'decode' or 'mixed'; got %r" % (role,))
        self.role = role
        self.engine_id = int(next(_ENGINE_IDS) if engine_id is None
                             else engine_id)
        if kv_dtype not in (None, "float32", "bfloat16", "int8"):
            raise ValueError(
                "ContinuousBatchingEngine kv_dtype must be None (follow "
                "the model dtype), 'float32', 'bfloat16' or 'int8'; got "
                "%r" % (kv_dtype,))
        if weight_quant not in (None, "int8"):
            raise ValueError(
                "ContinuousBatchingEngine weight_quant must be None or "
                "'int8'; got %r" % (weight_quant,))
        if (kv_dtype == "int8" or weight_quant == "int8") \
                and not mixed_step and not prefill_buckets:
            raise ValueError(
                "quantized serving (kv_dtype='int8' / weight_quant="
                "'int8') needs a compiled prefill path: pass "
                "mixed_step=True or prefill_buckets='auto' — the dense "
                "prefill runs the model in fp and writes unquantized K/V")
        if quant_collectives and mesh is None and sharding is None:
            raise ValueError(
                "quant_collectives=True quantizes the tensor-parallel "
                "logits all-gather; a single-chip engine has no "
                "collectives — pass mesh= (tp >= 2) or drop the flag")
        _unported({
            "a KV pool dtype other than the model's (kv_dtype)":
                kv_dtype not in (None, "int8", cfg.dtype),
        })
        # sampling / speculative validation, the reference's errors
        self.sampling = bool(sampling)
        if self.sampling and not mixed_step and not prefill_buckets:
            raise ValueError(
                "stochastic sampling needs a compiled prefill path: pass "
                "mixed_step=True or prefill_buckets='auto' — the dense "
                "prefill argmaxes its first token eagerly and cannot apply "
                "per-request temperature/top-k/top-p")
        if draft_model is not None:
            if not mixed_step:
                raise ValueError(
                    "speculative decoding (draft_model=) needs "
                    "mixed_step=True: the target verifies all slots' k+1 "
                    "positions as length-(k+1) ragged spans in one "
                    "MixedStep launch")
            if mesh is not None or sharding is not None:
                raise ValueError(
                    "speculative decoding is single-chip for now: the "
                    "draft engine runs unsharded, so a tensor-parallel "
                    "target would mix placements — drop mesh/sharding "
                    "or drop draft_model")
            if int(spec_k) < 1:
                raise ValueError(
                    "spec_k must be >= 1 (the draft proposes at least one "
                    "token per round); got %r" % (spec_k,))
            if draft_model.config.vocab_size != cfg.vocab_size:
                raise ValueError(
                    "draft and target models must share one vocabulary (%d "
                    "vs %d): accept/reject compares token ids"
                    % (draft_model.config.vocab_size, cfg.vocab_size))
        self.draft_model = draft_model
        self.spec_k = int(spec_k) if draft_model is not None else 0
        self._init_mesh(model, mesh, sharding, mixed_step, prefill_buckets,
                        quant_collectives, host_tier_bytes, token_budgets,
                        block_size, kv_dtype)
        self.device = resolve_device(device)
        for what, m in (("model", model), ("draft model", draft_model)):
            if m is not None and m.device != self.device:
                raise ValueError("the %s lives on %s but the engine serves "
                                 "on %s" % (what, m.device, self.device))
        self.model = model
        self.cfg = cfg
        # MoE dispatch accounting (reference): every real token of a mixed
        # pack is routed to top_k experts in each MoE layer, counted on
        # the host
        self._moe_layers = (cfg.num_hidden_layers
                            if getattr(cfg, "num_local_experts", 0) else 0)
        self._moe_topk = int(getattr(cfg, "num_experts_per_tok", 0))
        self.max_batch_size = max_batch_size
        self.block_size = block_size
        self.lazy_alloc = bool(lazy_alloc)
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        # each rank's pools hold its kv heads (tp) of its slot stripe (cp)
        # of every page
        self.caches = [
            PagedKVCache(num_blocks, block_size,
                         cfg.num_key_value_heads // self.tp_degree,
                         self.head_dim, cfg.torch_dtype, sink_block=True,
                         device=self.device,
                         kv_dtype="int8" if kv_dtype == "int8" else None,
                         cp=self.cp_degree)
            for _ in range(cfg.num_hidden_layers)]
        if max_seq_len is None:
            max_seq_len = max(block_size,
                              num_blocks * block_size // max_batch_size)
        # per-channel absmax PTQ, once: the target's steps dequantize this
        # tree on use (the draft stays fp, as in the reference)
        self.weight_qtree = (Int8Weights(model, tp=self.tp)
                             if weight_quant == "int8" else None)
        if self.fsdp_degree > 1:
            # the dispatches' gather of the stored fsdp shards (the int8
            # tree gathers its own codes)
            from ..jit.spmd import FsdpParams
            self.tp.fsdp_params = FsdpParams(model, self.tp, skip=(
                self.weight_qtree.param_names if self.weight_qtree
                else ()))
        self.weight_quant_bytes = (self.weight_qtree.nbytes
                                   if self.weight_qtree is not None else 0)
        self.max_seq_len = max_seq_len
        self.bt_width = -(-max_seq_len // block_size)
        self._sink = self.caches[0].sink
        self.slots: List[Optional[GenerationRequest]] = \
            [None] * max_batch_size
        self.waiting: List[GenerationRequest] = []
        self.finished: Dict[int, GenerationRequest] = {}
        self._next_id = 0
        # slot-padded decode inputs: masked slots hold token 0, seq_len 0
        # and an all-sink block-table row
        self._tokens = np.zeros((max_batch_size,), np.int32)
        self._seq_lens = np.zeros((max_batch_size,), np.int32)
        self._bt = np.full((max_batch_size, self.bt_width), self._sink,
                           np.int32)
        # per-slot sampling knobs of the decode step (temperature bits,
        # top_k, top_p bits, seed); masked slots are zeros (greedy)
        self._samp = np.zeros((max_batch_size, 4), np.int32)
        self._finished_this_step: Optional[List[int]] = None
        self._chunk_rr = 0           # round-robin cursor over chunk work
        # draft tokens the speculative rounds proposed and the target
        # accepted (plain counters; the tracer is not ported)
        self.spec_proposed = 0
        self.spec_accepted = 0
        # prompt tokens the steps prefilled (a prefix hit skips its own)
        self.prefill_tokens = 0
        shard_kw = dict(tp=self.tp,
                        quant_collectives=self.quant_collectives)
        self.decode_step = DecodeStep(model, self.caches,
                                      sampling=self.sampling,
                                      weights=self.weight_qtree, **shard_kw)

        # ---- bucketed / chunked prefill (split engine) -------------------
        if prefill_buckets == "auto":
            buckets = self._auto_buckets(self.max_seq_len)
        elif prefill_buckets:
            buckets = tuple(sorted({int(b) for b in prefill_buckets}))
        else:
            buckets = None
        self.prefill_buckets = buckets
        self.chunk_size = None
        self.prefill_step = None
        if buckets:
            self.chunk_size = int(prefill_chunk_size or buckets[-1])
            if self.chunk_size > buckets[-1]:
                raise ValueError(
                    "prefill_chunk_size %d exceeds the top bucket %d — "
                    "every chunk must map to a bucket"
                    % (self.chunk_size, buckets[-1]))
            self.prefill_step = PrefillStep(model, self.caches,
                                            self.bt_width,
                                            sampling=self.sampling,
                                            weights=self.weight_qtree,
                                            **shard_kw)

        # ---- fused mixed prefill+decode step -------------------------------
        self.token_budgets = None
        self.mixed = None
        if mixed_step:
            if self.chunk_size is None:
                self.chunk_size = int(
                    prefill_chunk_size
                    or self._auto_buckets(self.max_seq_len)[-1])
            # a speculative all-decode pack is slots x (k+1) verify
            # tokens, not slots x 1: the budget base is sized to it
            base_spans = max_batch_size * (self.spec_k + 1)
            if token_budgets == "auto":
                budgets = self._auto_budgets_mixed(base_spans,
                                                   self.chunk_size)
            else:
                budgets = tuple(sorted({int(b) for b in token_budgets}))
                if not budgets or budgets[-1] < base_spans:
                    raise ValueError(
                        "top token budget %r < %d (max_batch_size x "
                        "(spec_k+1)): an all-decode step would not fit"
                        % (token_budgets, base_spans))
            self.token_budgets = budgets
            if self.ep_degree > 1:
                # every budget stripes over the ep ranks
                from ..jit.spmd import validate_ep_serving
                validate_ep_serving(cfg.num_local_experts, self.ep_degree,
                                    budgets=budgets)
            self.mixed = MixedStep(
                model, self.caches, self.bt_width, max_spans=max_batch_size,
                # a verify span is spec_k + 1 tokens: the attention's span
                # window covers it as well as a chunk
                span_q=min(max(self.chunk_size, self.spec_k + 1),
                           budgets[-1]),
                sampling=self.sampling, spec_k=self.spec_k,
                weights=self.weight_qtree, **shard_kw)
            # padding tokens spread over the sink page's slots
            self._dest_pad = (np.arange(budgets[-1], dtype=np.int32)
                              % block_size)

        # ---- speculative draft engine --------------------------------------
        # the draft model's own per-layer pools, addressed by the same page
        # ids as the target's (caches[0] stays the one free list and
        # refcount authority), so release carries the draft KV for free.
        # The draft runs as a MixedStep too: catch-up spans are ragged
        # (1-2 tokens) and prefill chunks mirror straight into its pools.
        self.draft_caches = []
        self.draft_step = None
        self.draft_budgets = None
        self._zero_q = None
        if draft_model is not None:
            dcfg = draft_model.config
            self.draft_caches = [
                PagedKVCache(num_blocks, block_size,
                             dcfg.num_key_value_heads,
                             dcfg.hidden_size // dcfg.num_attention_heads,
                             dcfg.torch_dtype, sink_block=True,
                             device=self.device)
                for _ in range(dcfg.num_hidden_layers)]
            self.draft_step = MixedStep(
                draft_model, self.draft_caches, self.bt_width,
                max_spans=max_batch_size,
                span_q=min(self.chunk_size, self.token_budgets[-1]),
                sampling=self.sampling, return_probs=self.sampling)
            # proposal launches carry one token a slot, catch-up at most
            # two: small budgets for them, and the target's set on top so
            # the chunk mirrors always fit
            b = 1
            while b < max(1, max_batch_size):
                b *= 2
            self.draft_budgets = tuple(sorted(
                {b, 2 * b} | set(self.token_budgets)))
            if self.sampling:
                self._zero_q = torch.zeros(
                    (max_batch_size, cfg.vocab_size), dtype=torch.float32,
                    device=self.device)

        # ---- prefix cache and its host-RAM spill tier ----------------------
        if host_tier_bytes and not enable_prefix_cache:
            raise ValueError(
                "host_tier_bytes is the prefix cache's spill tier: pass "
                "enable_prefix_cache=True (there is nothing to spill "
                "without a prefix table)")
        if host_tier_bytes and draft_model is not None:
            raise ValueError(
                "a speculative engine cannot spill/restore prefix pages: a "
                "restored page carries only target-model KV, and the draft "
                "pool (addressed by the same page ids) cannot be "
                "reconstructed from it — drop host_tier_bytes or drop "
                "draft_model")
        self.host_tier = None
        self.prefix_cache = None
        if enable_prefix_cache:
            if not buckets and self.mixed is None:
                raise ValueError(
                    "enable_prefix_cache requires bucketed prefill "
                    "(prefill_buckets='auto'/tuple) or mixed_step=True: "
                    "suffix-only prefill needs an offset-carrying step")
            if host_tier_bytes:
                self.host_tier = HostPageTier(int(host_tier_bytes))
            self.prefix_cache = PrefixPageCache(
                self.caches[0], block_size, all_caches=self.caches,
                host_tier=self.host_tier)
        # the prefix cache's stat counters as last published into the
        # metrics (_sync_prefix_stats publishes each increment once)
        self._pc_published: Dict[str, int] = {}
        self._init_control()
        self._init_observability(tracer)

    def _init_mesh(self, model, mesh, sharding, mixed_step, prefill_buckets,
                   quant_collectives, host_tier_bytes, token_budgets,
                   block_size, kv_dtype):
        """Resolve ``mesh``/``sharding`` into ``self.tp`` (a
        ``jit.spmd.TPContext``, None on one device or when every axis is
        1) with the reference's checks at construction, then join the
        mesh's data groups; ``model`` must be this rank's shard
        (``jit.spmd.shard_model``)."""
        cfg = model.config
        self.tp = None
        if mesh is not None or sharding is not None:
            from ..jit.spmd import tp_serving_context
            self.tp = tp_serving_context(model, mesh, sharding)
        tp = self.tp
        self.tp_degree = tp.degree if tp is not None else 1
        self.fsdp_degree = tp.fsdp_degree if tp is not None else 1
        self.cp_degree = tp.cp_degree if tp is not None else 1
        self.ep_degree = tp.ep_degree if tp is not None else 1
        self.dp_degree = (tp.mesh.axis_sizes().get("dp", 1)
                          if tp is not None else 1)
        if self.cp_degree > 1:
            from ..jit.spmd import validate_cp_serving
            validate_cp_serving(
                self.cp_degree, block_size,
                quantized_kv=(kv_dtype == "int8"),
                dense_prefill=(not mixed_step and not prefill_buckets),
                spec_decode=self.draft_model is not None)
        if self.ep_degree > 1:
            from ..jit.spmd import validate_ep_serving
            validate_ep_serving(
                getattr(cfg, "num_local_experts", 0), self.ep_degree,
                mixed_step=bool(mixed_step),
                dense_prefill=(not mixed_step and not prefill_buckets),
                spec_decode=self.draft_model is not None,
                # an explicit set here, the "auto" set once it resolves
                budgets=() if token_budgets == "auto" else token_budgets)
        if quant_collectives and self.tp is None:
            raise ValueError(
                "quant_collectives=True but the mesh's tp axis "
                "degenerates to 1 chip — there is no logits all-gather "
                "to quantize; use tp >= 2 or drop the flag")
        self.quant_collectives = bool(quant_collectives)
        if self.tp is not None and not mixed_step and not prefill_buckets:
            raise ValueError(
                "tensor-parallel serving needs a compiled prefill path: "
                "pass mixed_step=True or prefill_buckets='auto' (the "
                "legacy dense prefill runs the model eagerly on one "
                "chip and cannot feed head-sharded KV pools)")
        if host_tier_bytes and self.tp is not None:
            raise ValueError(
                "the host spill tier is single-chip for now: a "
                "tensor-parallel engine's pools are head-sharded and the "
                "batched extract/inject path moves whole pages — drop "
                "host_tier_bytes or drop mesh/sharding")
        self._rank = 0
        if self.tp is None:
            return
        info = getattr(model, "_ptt_shard", None)
        want = self.tp.mesh.axis_sizes()
        if info is None or info.mesh_sizes != want:
            raise ValueError(
                "under a %s mesh every rank serves its own shard of the "
                "model: build it with paddle_tpu_torch.jit.spmd."
                "shard_model(model_cls, config, mesh, ...) on each rank "
                "(got %s)" % (want, "a whole model" if info is None
                              else "a shard of a %s mesh" % info.mesh_sizes))
        self.tp.bind()
        self._rank = self.tp.rank
        if info.coords != self.tp.coords:
            raise ValueError("the model is the shard of rank %s, not of "
                             "this rank %s" % (info.coords, self.tp.coords))

    def _init_observability(self, tracer):
        """The request tracer (default on; decode spans sampled every
        ``trace_decode_every`` steps a request), the ``serving_*`` metric
        families in the port's registry, and the engine's own cumulative
        ``counters``, with the sharded-serving families (degrees, mesh
        shape, tp/cp/ep collective bytes, the fsdp gather's bytes), the
        quantized collective and the MoE families."""
        self.tracer = resolve_tracer(tracer)
        self.trace_decode_every = 8
        r = default_registry()
        self._m_queue = r.gauge(
            "serving_queue_depth", "requests waiting for a free slot")
        self._m_occupancy = r.gauge(
            "serving_slot_occupancy_ratio",
            "running slots / max_batch_size")
        self._m_kv_util = r.gauge(
            "serving_kv_page_utilization_ratio",
            "allocated KV pages / pool size")
        self._m_prefill = r.histogram(
            "serving_prefill_duration_seconds",
            "prompt prefill (bucketed compiled chunk, or the legacy "
            "dense forward + fused cache scatter)")
        self._m_decode = r.histogram(
            "serving_decode_step_duration_seconds",
            "one fused batched decode step (all slots)")
        self._m_ttft = r.histogram(
            "serving_ttft_seconds", "admission wait + prefill to first "
            "token (time-to-first-token)")
        self._m_tpot = r.histogram(
            "serving_tpot_seconds",
            "mean per-token decode latency after the first token",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0))
        self._m_requests = r.counter(
            "serving_requests_total", "finished generation requests",
            labels=("outcome",))
        self._m_tokens = r.counter(
            "serving_tokens_total", "tokens generated")
        self._m_truncated = r.counter(
            "serving_truncated_victims_total",
            "requests finished early because the KV pool ran dry "
            "(lazy_alloc victim contract)")
        self._m_prefill_compiles = r.counter(
            "serving_prefill_compiles_total",
            "bucketed PrefillStep traces (bounded by the bucket count)")
        self._m_prefix_lookups = r.counter(
            "serving_prefix_cache_lookups_total",
            "prompt admissions checked against the prefix table",
            labels=("outcome",))
        self._m_prefix_hit_tokens = r.counter(
            "serving_prefix_cache_hit_tokens_total",
            "prompt tokens served from shared prefix pages instead of "
            "recompute")
        self._m_prefix_evictions = r.counter(
            "serving_prefix_cache_evictions_total",
            "prefix table entries visited by eviction under pool "
            "pressure, by outcome (reclaimed = page returned to the "
            "free list, spilled first when a host tier is attached; "
            "skipped_pinned = a live request still holds the page, so "
            "the entry was passed over — sustained skips explain "
            "cache-pressure stalls)", labels=("outcome",))
        self._m_evict_reclaimed = \
            self._m_prefix_evictions.labels(outcome="reclaimed")
        self._m_evict_skipped = \
            self._m_prefix_evictions.labels(outcome="skipped_pinned")
        self._m_migrations = r.counter(
            "serving_page_migrations_total",
            "KV page-set migrations through this engine, by direction "
            "(out = extract_request serialized a sequence's pages to "
            "host; in = inject_request scattered a migrated buffer "
            "into this pool)", labels=("direction",))
        self._m_migrations_out = \
            self._m_migrations.labels(direction="out")
        self._m_migrations_in = self._m_migrations.labels(direction="in")
        self._m_migrated_bytes = r.counter(
            "serving_migrated_bytes_total",
            "payload bytes moved across the host link by page "
            "migration (each migration counts its buffer once on "
            "extract — device-to-host — and once on inject — "
            "host-to-device)")
        self._m_host_spills = r.counter(
            "serving_host_tier_spills_total",
            "evicted prefix pages serialized into the host-RAM spill "
            "tier instead of dying")
        self._m_host_hits = r.counter(
            "serving_host_tier_hits_total",
            "prefix lookups whose chain continued into the host tier "
            "(spilled pages found for the prompt)")
        self._m_host_restores = r.counter(
            "serving_host_tier_restores_total",
            "spilled pages injected back into the device pool and "
            "re-registered under their digest keys")
        self._m_chunk_queue = r.gauge(
            "serving_prefill_chunk_queue_depth",
            "prefill chunks still pending across admitted requests")
        self._m_mixed_compiles = r.counter(
            "serving_mixed_step_compiles_total",
            "fused MixedStep traces (bounded by the token-budget-set "
            "size)")
        self._m_mixed_span_tokens = r.counter(
            "serving_mixed_span_tokens_total",
            "tokens advanced by the fused mixed step, by span kind",
            labels=("kind",))
        # the labeled children resolved once: the mixed step pays them
        # every engine round
        self._m_mixed_tok_decode = \
            self._m_mixed_span_tokens.labels(kind="decode")
        self._m_mixed_tok_prefill = \
            self._m_mixed_span_tokens.labels(kind="prefill")
        r.gauge("serving_tp_degree",
                "tensor-parallel degree of the most recently constructed "
                "engine in this process (1 = single chip)").set(
                    self.tp_degree)
        tp_coll = r.counter(
            "serving_tp_collective_bytes_total",
            "per-chip activation bytes moved through the sharded "
            "step's collectives (psum per layer boundary, exact "
            "embedding psum, exact logits all-gather)", labels=("op",))
        self._m_tp_psum = tp_coll.labels(op="psum")
        self._m_tp_all_gather = tp_coll.labels(op="all_gather")
        mesh_shape = r.gauge(
            "serving_mesh_shape",
            "serving mesh degree per axis for the most recently "
            "constructed engine (fsdp = weight-storage sharding, tp = "
            "tensor parallel, dp = replica) — 1 means the axis is "
            "absent", labels=("axis",))
        mesh_shape.labels(axis="fsdp").set(self.fsdp_degree)
        mesh_shape.labels(axis="tp").set(self.tp_degree)
        mesh_shape.labels(axis="dp").set(self.dp_degree)
        mesh_shape.labels(axis="cp").set(self.cp_degree)
        mesh_shape.labels(axis="ep").set(self.ep_degree)
        r.gauge("serving_cp_degree",
                "context-parallel degree of the most recently constructed "
                "engine (cp stripes every KV pool's slot dim — per-chip "
                "pool HBM is 1/cp; 1 = pools not striped)").set(
                    self.cp_degree)
        self._m_cp_all_gather = r.counter(
            "serving_cp_collective_bytes_total",
            "per-chip bytes received by the cross-chip online-softmax "
            "stripe merge (one all_gather of the (o, m, l) partial "
            "rows per layer per sharded dispatch)", labels=("op",)
        ).labels(op="all_gather")
        self._m_fsdp_gather = r.counter(
            "spmd_allgather_bytes_total",
            "per-chip bytes received by spmd param all-gathers, by "
            "site: the 2D train step's per-step param gather "
            "(train_params) and the sharded serving prologue's fsdp "
            "gather (serving_params)", labels=("site",)
        ).labels(site="serving_params")
        # the static per-dispatch payload of the fsdp gather (0 without an
        # fsdp axis), counted per sharded dispatch
        self._fsdp_gather_bytes = 0
        if self.tp is not None:
            # over the served tree, as the reference: int8 codes where the
            # weight tree stands in for a parameter
            from ..jit.spmd import full_shapes
            codes = set(self.weight_qtree.param_names
                        if self.weight_qtree is not None else ())
            self._fsdp_gather_bytes = self.tp.fsdp_gather_bytes({
                k: torch.empty(v, device="meta", dtype=(
                    torch.int8 if k in codes else self.cfg.torch_dtype))
                for k, v in full_shapes(self.model).items()})
        r.gauge("serving_ep_degree",
                "expert-parallel degree of the most recently constructed "
                "engine (ep shards every MoE expert bank's E dim — "
                "per-chip expert HBM is 1/ep; 1 = expert banks "
                "replicated)").set(self.ep_degree)
        ep_coll = r.counter(
            "serving_ep_collective_bytes_total",
            "per-chip bytes moved by the expert-parallel dispatch "
            "(all_to_all = the send/return buffer pair per MoE layer, "
            "all_gather = re-replicating the combined token stripes)",
            labels=("op",))
        self._m_ep_all_to_all = ep_coll.labels(op="all_to_all")
        self._m_ep_all_gather = ep_coll.labels(op="all_gather")
        self._m_quant_all_gather = r.counter(
            "serving_quant_collective_bytes_total",
            "per-chip bytes moved through QUANTIZED collectives (the "
            "EQuARX-style int8 logits all-gather: codes + per-shard "
            "scales)", labels=("op",)).labels(op="all_gather")
        self._m_moe_dispatch = r.counter(
            "serving_moe_dispatch_tokens_total",
            "token->expert assignments made by the fused MoE serving "
            "dispatch (tokens x top_k x MoE layers), by fate — the "
            "dispatch is DROPLESS (capacity == worst-case load), so "
            "'dropped' stays 0 by construction and a nonzero value "
            "means the capacity invariant broke", labels=("fate",))
        self._m_moe_routed = self._m_moe_dispatch.labels(fate="routed")
        # resolved eagerly so /metrics always shows the 0 that documents
        # droplessness
        self._m_moe_dropped = self._m_moe_dispatch.labels(fate="dropped")
        r.gauge("serving_kv_quant_dtype",
                "KV-cache element width in bits of the most recently "
                "constructed engine (8 = int8 quantized pools, 16/32 = "
                "fp)").set(self.caches[0].key_cache.element_size() * 8)
        r.counter(
            "serving_quant_token_mismatch_total",
            "greedy tokens that diverged from the fp32 reference "
            "engine on a paired run (published by the quantization "
            "bench/tests via record_token_mismatches — the tolerance "
            "gate's numerator)")
        r.gauge("serving_sampling_mode",
                "1 = the stochastic sampling epilogue is compiled into "
                "this process's most recently constructed engine, 0 = "
                "greedy-only").set(1 if self.sampling else 0)
        self._m_spec_proposed = r.counter(
            "serving_spec_proposed_tokens_total",
            "draft tokens proposed to the speculative verifier")
        self._m_spec_accepted = r.counter(
            "serving_spec_accepted_tokens_total",
            "proposed draft tokens the target verifier accepted "
            "(acceptance rate = accepted / proposed)")
        self._m_draft_step = r.histogram(
            "serving_spec_draft_step_duration_seconds",
            "one fused draft-model launch (catch-up + proposal or "
            "chunk mirror; first launch of a budget excluded)",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0))
        # the first run of each step shape never lands in a latency
        # histogram (bucketed prefill: per bucket through the step's
        # compile counts; the dense prefill: per prompt length)
        self._prefill_warm_lens = set()
        self._decode_warm = False
        # per-ENGINE cumulative host counters (the process-wide metrics
        # aggregate over every engine in the process)
        self.counters: Dict[str, int] = {
            "tokens_generated": 0, "requests_received": 0,
            "requests_admitted": 0, "preempts": 0}
        # the serving step's efficiency numbers (efficiency_stats): one
        # probe ever, cached; a failed probe latches
        self._efficiency_stats: Optional[Dict] = None
        self._efficiency_failed = False

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
                    top_p: float = 0.0, seed: int = 0, n: int = 1):
        """Queue one prompt; returns its req_id.  ``temperature`` /
        ``top_k`` / ``top_p`` / ``seed`` select stochastic sampling (the
        engine must be built with ``sampling=True``; temperature 0 is
        greedy).  ``n > 1`` (an engine with the prefix cache) queues ``n``
        generations of the prompt that share its one prefill, generation
        ``i`` sampling with ``seed + i``, and returns the list of their
        req_ids."""
        self._check_driver()
        if (temperature or top_k or top_p or seed) and not self.sampling:
            raise ValueError(
                "per-request sampling parameters need a sampling engine: "
                "construct ContinuousBatchingEngine(sampling=True, ...) — "
                "the greedy engine's steps have no sampling epilogue")
        if n < 1:
            raise ValueError("add_request n must be >= 1, got %r" % n)
        if n > 1 and self.prefix_cache is None:
            raise ValueError(
                "add_request(n=%d) shares one prefilled prefix across "
                "generations via the prefix-page cache: construct the "
                "engine with enable_prefix_cache=True" % n)
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        if len(prompt) == 0 or max_new_tokens < 1:
            raise ValueError("add_request needs a non-empty prompt and "
                             "max_new_tokens >= 1")
        cache = self.caches[0]
        need = cache.blocks_needed(len(prompt) + max_new_tokens)
        if need > self.bt_width:
            raise ValueError(
                "request needs %d pages but the engine's block-table width "
                "is %d (max_seq_len=%d); raise max_seq_len"
                % (need, self.bt_width, self.max_seq_len))
        # lazy mode only needs the prompt to fit: the tail may be truncated
        min_need = (cache.blocks_needed(len(prompt) + 1) if self.lazy_alloc
                    else need)
        if min_need > cache.num_blocks:
            raise ValueError(
                "request needs %d pages but the pool only has %d; raise "
                "num_blocks" % (min_need, cache.num_blocks))
        ids = []
        parent = None
        for i in range(n):
            req = GenerationRequest(
                req_id=self._next_id, prompt_ids=prompt,
                max_new_tokens=int(max_new_tokens),
                eos_token_id=eos_token_id, temperature=float(temperature),
                top_k=int(top_k), top_p=float(top_p), seed=int(seed) + i,
                parent_req=parent)
            parent = parent or req
            self._next_id += 1
            req.t_submit = time.perf_counter()
            self.waiting.append(req)
            ids.append(req.req_id)
        self.counters["requests_received"] += n
        self._m_queue.set(len(self.waiting))
        return ids[0] if n == 1 else ids

    # ---- multi-rank: rank 0 drives, ranks > 0 replay --------------------
    def _init_control(self):
        """The control buffer of a sharded engine: rank 0 writes every
        device operation into it (a header, then the operation's packed
        int32 operands) and broadcasts it over the control group, ONE
        broadcast an operation; ranks > 0 run the same operation on their
        shards.  Its size is the largest operation the engine can make
        (the mixed step's pack at the top budget, a bucket-wide prefill
        chunk, or the decode step's operands)."""
        self._ctl = None
        self._driver = self.tp is not None and self._rank == 0
        self._workers_live = self._driver
        if self.tp is None:
            return
        S, W = self.max_batch_size, self.bt_width
        cap = [S * (6 + W)]
        if self.prefill_buckets:
            cap.append(self.prefill_buckets[-1] + W + 4)
        if self.mixed is not None:
            cap.append(4 * self.token_budgets[-1]
                       + S * (W + self.mixed.row_extra))
        self._ctl = torch.zeros(_CTL_HEADER + max(cap), dtype=torch.int32)
        self._ctl_np = self._ctl.numpy()
        self.control_broadcasts = 0

    def _send(self, op: int, header, *payload) -> None:
        """Rank 0: broadcast one operation to the other ranks (nothing on
        one device or on ranks > 0)."""
        if not self._driver:
            return
        if not self._workers_live:
            raise RuntimeError("the sharded engine's workers were shut "
                               "down (shutdown_workers)")
        buf = self._ctl_np
        buf[:_CTL_HEADER] = 0
        buf[0] = op
        buf[1:1 + len(header)] = header
        off = _CTL_HEADER
        for a in payload:
            a = np.asarray(a, np.int32).reshape(-1)
            buf[off:off + a.size] = a
            off += a.size
        broadcast(self._ctl, 0)
        self.control_broadcasts += 1

    def run_worker(self) -> None:
        """Ranks > 0 of a sharded engine: run every device operation rank
        0 broadcasts (the steps and the page copies, in rank 0's order) on
        this rank's shard, until rank 0 calls :meth:`shutdown_workers`."""
        if self.tp is None or self._rank == 0:
            raise RuntimeError(
                "run_worker is for ranks > 0 of a sharded engine; rank 0 "
                "drives it through add_request / step")
        b = self._ctl_np
        while True:
            broadcast(self._ctl, 0)
            op = int(b[0])
            h = [int(v) for v in b[1:_CTL_HEADER]]
            p = b[_CTL_HEADER:]
            if op == _OP_SHUTDOWN:
                return
            if op == _OP_MIXED:
                self._exec_mixed(p[:h[1]].copy(), h[0])
            elif op == _OP_PREFILL:
                C, start, n_valid, W, has_samp = h[:5]
                self._exec_prefill(p[:C].reshape(1, C).copy(), start,
                                   n_valid, p[C:C + W].reshape(1, W).copy(),
                                   p[C + W:C + W + 4].copy() if has_samp
                                   else None)
            elif op == _OP_DECODE:
                S, W, has_samp = h[:3]
                q = p[:S * (2 + W + (4 if has_samp else 0))].copy()
                self._exec_decode(q[:S], q[S:2 * S],
                                  q[2 * S:2 * S + S * W].reshape(S, W),
                                  q[2 * S + S * W:].reshape(S, 4)
                                  if has_samp else None)
            elif op == _OP_COPY_BLOCK:
                copy_block(self.caches, h[0], h[1])
            else:
                raise RuntimeError("unknown control operation %d" % op)

    def shutdown_workers(self) -> None:
        """Rank 0 of a sharded engine: end the other ranks'
        :meth:`run_worker` loops (once; a no-op on one device)."""
        if self._driver and self._workers_live:
            self._send(_OP_SHUTDOWN, ())
            self._workers_live = False

    def _check_driver(self):
        if self.tp is not None and self._rank != 0:
            raise RuntimeError(
                "rank %d of a sharded engine runs run_worker(); rank 0 "
                "schedules and serves the requests" % self._rank)

    def _exec_mixed(self, pack: np.ndarray, B: int, q_probs=None):
        out = self.mixed.call_packed(pack, B, q_probs=q_probs)
        self._count_collectives(self.mixed.collective_bytes(B))
        return out

    def _exec_prefill(self, toks, start, size, row, samp):
        out = self.prefill_step(toks, start, size, row, samp)
        self._count_collectives(
            self.prefill_step.collective_bytes(toks.shape[1]))
        return out

    def _exec_decode(self, tokens, seq_lens, bt, samp):
        out = self.decode_step(tokens, seq_lens, bt, samp)
        self._count_collectives(
            self.decode_step.collective_bytes(len(tokens)))
        return out

    def _mixed_call(self, pack: np.ndarray, B: int, q_probs=None):
        self._send(_OP_MIXED, (B, pack.size), pack)
        return self._exec_mixed(pack, B, q_probs)

    def _prefill_call(self, toks, start, size, row, samp):
        self._send(_OP_PREFILL, (toks.shape[1], start, size, row.shape[1],
                                 samp is not None),
                   toks, row, *(() if samp is None else (samp,)))
        return self._exec_prefill(toks, start, size, row, samp)

    def _decode_call(self, tokens, seq_lens, bt, samp):
        self._send(_OP_DECODE, (len(tokens), bt.shape[1], samp is not None),
                   tokens, seq_lens, bt, *(() if samp is None else (samp,)))
        return self._exec_decode(tokens, seq_lens, bt, samp)

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write of a shared page, on every rank's pools."""
        self._send(_OP_COPY_BLOCK, (src, dst))
        copy_block(self.caches, src, dst)

    def _count_collectives(self, by_op: Dict[str, int]) -> None:
        """Publish one sharded dispatch's per-rank collective payload
        (reference: ``_count_collectives``; static per shape); the logits
        all-gather counts under the quantized family too when it is
        int8."""
        if not by_op:
            return
        if by_op.get("psum"):
            self._m_tp_psum.inc(by_op["psum"])
        if by_op.get("all_gather"):
            self._m_tp_all_gather.inc(by_op["all_gather"])
            if self.quant_collectives:
                self._m_quant_all_gather.inc(by_op["all_gather"])
        if by_op.get("ep_all_to_all"):
            self._m_ep_all_to_all.inc(by_op["ep_all_to_all"])
        if by_op.get("cp_merge"):
            self._m_cp_all_gather.inc(by_op["cp_merge"])
        if by_op.get("ep_all_gather"):
            self._m_ep_all_gather.inc(by_op["ep_all_gather"])
        if self._fsdp_gather_bytes:
            self._m_fsdp_gather.inc(self._fsdp_gather_bytes)

    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def step(self) -> List[int]:
        """Admit waiting requests, then advance one round: the mixed
        engine packs every decode and as many chunks as fit into one
        step; the split engine advances at most one prefill chunk, then
        decodes every running slot.  Returns the req_ids finished this
        step, those finished during admission (a one-token budget or EOS
        on the first token) included."""
        self._check_driver()
        self._finished_this_step = fts = []
        try:
            self._admit()
            if self.mixed is not None:
                done = self._run_mixed_step()
            else:
                self._prefill_chunks()
                done = self._decode_batch()
        finally:
            self._finished_this_step = None
        seen = set(done)
        done += [rid for rid in fts if rid not in seen]
        self._m_queue.set(len(self.waiting))
        self._m_occupancy.set(sum(s is not None for s in self.slots)
                              / max(1, self.max_batch_size))
        cache = self.caches[0]
        self._m_kv_util.set(1.0 - len(cache._free)
                            / max(1, cache.num_blocks))
        if self.chunk_size is not None:
            self._m_chunk_queue.set(self._pending_chunks())
        self._sync_prefix_stats()
        return done

    def run_to_completion(self) -> Dict[int, List[int]]:
        while self.has_work():
            self.step()
        return {rid: r.output_ids for rid, r in self.finished.items()}

    def result(self, req_id: int) -> List[int]:
        return self.finished[req_id].output_ids

    def preempt_request(self, req_id: int) -> Tuple[np.ndarray, List[int]]:
        """Pull a waiting or running request out of the engine and return
        ``(prompt_ids, generated_ids)`` so an admission plane can re-admit
        it elsewhere with its generated tokens re-prefixed onto the prompt
        (not the lazy-alloc victim path, which ends a request early).

        A running slot is released through the refcounted
        ``free_sequence`` path, the only release path: pages shared with
        the prefix table or another request survive, copy-on-write copies
        return to the pool, and an int8 pool's per-page scales stay with
        their pages.  The request is not finished: no outcome counter
        fires and nothing lands in ``finished``.  Raises ``KeyError`` when
        ``req_id`` is neither waiting nor on a slot."""
        for i, r in enumerate(self.waiting):
            if r.req_id == req_id:
                self.waiting.pop(i)
                self._m_queue.set(len(self.waiting))
                r.state = "preempted"
                self.counters["preempts"] += 1
                self.tracer.event(req_id, "preempt", from_state="waiting",
                                  tokens=len(r.output_ids))
                return r.prompt_ids, list(r.output_ids)
        for r in self.slots:
            if r is None or r.req_id != req_id:
                continue
            self._release_slot(r)
            r.slot = -1
            r.state = "preempted"
            self.counters["preempts"] += 1
            self.tracer.event(req_id, "preempt", from_state="running",
                              tokens=len(r.output_ids))
            return r.prompt_ids, list(r.output_ids)
        raise KeyError(
            "preempt_request(%r): request is neither waiting nor "
            "running on this engine" % (req_id,))

    # ---- KV page migration ----------------------------------------------
    def migration_geometry(self):
        """The pool geometry ``(layers, block_size, kv_heads, head_dim,
        kv_dtype)`` that page buffers extracted from or injected into this
        engine must match, or None when the engine cannot migrate pages
        (a speculative engine's draft KV cannot travel)."""
        if self.tp is not None or self.draft_step is not None:
            return None
        return (len(self.caches),) + self.caches[0].page_geometry()

    def extract_request(self, req_id: int):
        """:meth:`preempt_request` plus page extraction: the request's KV
        pages are serialized to one host ``KVPageBuffer`` (one batched
        device-to-host copy per dtype) before the refcounted release, so
        an admission plane can resume it on another engine with zero
        re-prefill (:meth:`inject_request`).  Returns ``(prompt_ids,
        generated_ids, buffer)``; ``buffer`` is None when the request
        holds no resumable KV (waiting, or mid-prefill) or the engine
        cannot extract (speculative)."""
        buf = None
        if self.migration_geometry() is not None:
            for r in self.slots:
                if (r is not None and r.req_id == req_id
                        and r.state == "running" and r.seq_len > 0):
                    n_cov = self.caches[0].blocks_needed(r.seq_len)
                    buf = extract_blocks(self.caches, r.block_ids[:n_cov],
                                         n_tokens=r.seq_len)
                    break
        prompt, gen = self.preempt_request(req_id)
        if buf is not None:
            self._m_migrations_out.inc()
            self._m_migrated_bytes.inc(buf.nbytes)
        return prompt, gen, buf

    def inject_request(self, prompt_ids, buffer, max_new_tokens: int = 16,
                       eos_token_id: Optional[int] = None,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 0.0, seed: int = 0) -> int:
        """Admit a migrated request straight into a decode slot: the
        buffer's pages scatter into freshly allocated pool pages (one
        host-to-device copy per dtype), the request starts ``running``
        with its last prompt token pending, and the next step advances it
        as a plain decode span — zero re-prefill.  The covered full pages
        re-register under the prefix cache's digest chain, so a later
        same-prefix admission hits.

        ``prompt_ids`` is the resume prompt (the original prompt plus
        every token generated so far); ``buffer.n_tokens`` must equal
        ``len(prompt_ids) - 1``.  The buffer carries KV, not sampling
        state: a sampled request re-passes its knobs here (the per-position
        generator keys on the seed and the token position, so it resumes
        the same stream).

        Raises ``ValueError`` for a request this engine can never hold
        (geometry or kv_dtype mismatch, block-table width) and
        ``RuntimeError`` for transient capacity (no free slot, too few
        pages), both before any side effect."""
        if buffer is None:
            raise ValueError(
                "inject_request needs a KVPageBuffer — use add_request "
                "for a fresh (un-migrated) prompt")
        if self.tp is not None:
            raise ValueError(
                "page migration is single-chip for now: a tensor-"
                "parallel engine's pools are head-sharded and the "
                "batched inject moves whole pages")
        if self.draft_step is not None:
            raise ValueError(
                "a speculative engine cannot accept migrated pages: "
                "the buffer carries only target-model KV and the draft "
                "pool (addressed by the same page ids) cannot be "
                "reconstructed from it")
        here = (len(self.caches),) + self.caches[0].page_geometry()
        if here != buffer.geometry():
            raise ValueError(
                "inject_request: pool geometry mismatch — buffer was "
                "extracted from (layers, block_size, kv_heads, "
                "head_dim, kv_dtype)=%r but this engine's pools are "
                "%r; KV pages only migrate between engines with "
                "identical pool geometry (including kv_dtype)"
                % (buffer.geometry(), here))
        if int(max_new_tokens) < 1:
            raise ValueError(
                "inject_request max_new_tokens must be >= 1; a "
                "migrated request with no remaining budget should "
                "complete at the router, not resume")
        if (temperature or top_k or top_p or seed) and not self.sampling:
            raise ValueError(
                "per-request sampling parameters need a sampling engine: "
                "construct ContinuousBatchingEngine(sampling=True, ...) — "
                "the greedy engine's steps have no sampling epilogue")
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        L = len(prompt)
        if buffer.n_tokens != L - 1:
            raise ValueError(
                "inject_request: buffer covers %d token(s) of KV but "
                "the resume prompt has %d — a migrated request resumes "
                "with exactly its last token pending (n_tokens == "
                "len(prompt_ids) - 1)" % (buffer.n_tokens, L))
        cache = self.caches[0]
        n_cov = cache.blocks_needed(buffer.n_tokens)
        if buffer.n_pages != n_cov:
            raise ValueError(
                "inject_request: buffer holds %d page(s) but %d cover "
                "its %d token(s) at block_size=%d"
                % (buffer.n_pages, n_cov, buffer.n_tokens,
                   self.block_size))
        total_need = cache.blocks_needed(
            L + (1 if self.lazy_alloc else int(max_new_tokens)))
        if total_need > self.bt_width:
            raise ValueError(
                "request needs %d pages but the engine's block-table "
                "width is %d (max_seq_len=%d); raise max_seq_len"
                % (total_need, self.bt_width, self.max_seq_len))
        slot = next((i for i, r in enumerate(self.slots) if r is None),
                    None)
        if slot is None:
            raise RuntimeError(
                "inject_request: no free slot — inject only into "
                "engines with slot capacity (migrated requests do not "
                "queue; their pages would pin pool pages while waiting)")
        available = len(cache._free)
        if self.prefix_cache is not None:
            available += self.prefix_cache.evictable_count()
        if total_need > available:
            raise RuntimeError(
                "inject_request: pool cannot cover %d page(s) "
                "(%d free + %d evictable)"
                % (total_need, len(cache._free),
                   available - len(cache._free)))

        # ---- commit: one batched spill for the whole deficit ----------
        short = total_need - len(cache._free)
        if short > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict(short)
            self._sync_prefix_stats()
        req = GenerationRequest(
            req_id=self._next_id, prompt_ids=prompt,
            max_new_tokens=int(max_new_tokens), eos_token_id=eos_token_id,
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), seed=int(seed))
        self._next_id += 1
        req.t_submit = time.perf_counter()
        req.block_ids = [self._alloc_block() for _ in range(total_need)]
        inject_blocks(self.caches, buffer, req.block_ids[:n_cov])
        req.slot = slot
        req.state = "running"
        req.seq_len = buffer.n_tokens
        req.prefill_pos = L
        self.slots[slot] = req
        self._tokens[slot] = int(prompt[-1])
        self._seq_lens[slot] = req.seq_len
        self._bt[slot] = self._row_for(req)[0]
        if self.sampling:
            self._samp[slot] = self._samp_row(req)
        if self.prefix_cache is not None:
            # the covered FULL pages only: pages past n_tokens hold no KV
            full = (buffer.n_tokens // self.block_size) * self.block_size
            if full:
                self.prefix_cache.register(prompt[:full], req.block_ids)
        self._m_migrations_in.inc()
        self._m_migrated_bytes.inc(buffer.nbytes)
        self.counters["requests_received"] += 1
        self.counters["requests_admitted"] += 1
        self.tracer.event(req.req_id, "admit", slot=slot,
                          prefix_hit_tokens=0, prompt_tokens=L,
                          enqueue_ts=req.t_submit, migrated=True)
        return req.req_id

    def health_payload(self) -> Dict:
        """Load and health snapshot for admission planes: occupancy,
        pages, the chunk queue, evictable prefix pages, the host tier's
        footprint, the int8 weight tree's bytes and this engine's
        cumulative ``counters`` — the body ``/healthz`` serves with this
        engine installed as the process's health provider
        (``observability.set_health_provider(engine.health_payload)``)."""
        pc = self.prefix_cache
        cache = self.caches[0]
        payload = {
            "engine_id": self.engine_id,
            "role": self.role,
            "occupancy": sum(s is not None for s in self.slots),
            "slots": self.max_batch_size,
            "waiting": len(self.waiting),
            "free_pages": len(cache._free),
            "total_pages": cache.num_blocks,
            "chunk_queue_depth": (self._pending_chunks()
                                  if self.chunk_size is not None else 0),
            "evictable_pages": (pc.evictable_count()
                                if pc is not None else 0),
            "host_tier_bytes": (self.host_tier.bytes
                                if self.host_tier is not None else 0),
            "host_tier_entries": (len(self.host_tier)
                                  if self.host_tier is not None else 0),
            "weight_quant_bytes": self.weight_quant_bytes,
        }
        payload["counters"] = {
            **self.counters,
            "prefix_lookups": (pc.hits + pc.misses) if pc is not None
            else 0,
            "prefix_hits": pc.hits if pc is not None else 0,
            "host_tier_spills": pc.spills if pc is not None else 0,
            "host_tier_restores": pc.restores if pc is not None else 0,
        }
        if self._efficiency_stats is not None:
            payload["efficiency"] = self._efficiency_stats
        return payload

    def efficiency_stats(self, compute: bool = False) -> Optional[Dict]:
        """Serving-step device-efficiency numbers — the capacity plane's
        per-token FLOPs and bytes source, with the reference's contract:
        lazy, cached for the engine's lifetime, one probe ever, opt out
        with ``PADDLE_TPU_MFU_COST_ANALYSIS=0``.  ``compute=False`` (the
        health-payload read) returns the cached block or None — it NEVER
        probes.

        The probed launch is the engine's steady-state decode shape: the
        SMALLEST mixed token budget an all-decode pack of ``slots x
        (spec_k + 1)`` tokens fits, or the split decode step at the slot
        count, each span attending ``max_seq_len`` keys (the block
        table's reach).  Per-token numbers amortize over the launch's
        packed token capacity.  The numbers are an analytic count of the
        port's own launch (``jit/serving_step.launch_cost``: its GEMMs,
        the attention kernels' work, the weights and KV pages it moves);
        the reference's describe its compiled XLA module
        (``cost_analysis``), a different program."""
        if self._efficiency_stats is not None:
            return self._efficiency_stats
        if not compute:
            return None
        if self._efficiency_failed:
            # a failed probe is cached too: a periodic refresh must not
            # re-pay it every sweep; the env gate is NOT a failure
            return None
        from ..observability.capacity import _cost_analysis_enabled
        if not _cost_analysis_enabled():
            return None
        try:
            if self.mixed is not None:
                # the SMALLEST budget an all-decode pack fits (explicit
                # budget sets only validate their TOP against it, so
                # budgets[0] can be far smaller — probing it would
                # amortize the weights over too few tokens)
                base = self.max_batch_size * (self.spec_k + 1)
                T = min((b for b in self.token_budgets if b >= base),
                        default=self.token_budgets[-1])
                stats = self.mixed.launch_stats(T, self.max_seq_len)
                kind = "mixed"
            else:
                stats = self.decode_step.launch_stats(self.max_batch_size,
                                                      self.max_seq_len)
                kind = "decode"
        except Exception:                             # noqa: BLE001
            self._efficiency_failed = True
            return None
        if not stats.get("flops_per_token"):
            self._efficiency_failed = True
            return None
        self._efficiency_stats = {
            "step": kind,
            "tokens_per_launch": int(stats["tokens"]),
            "flops_per_token": float(stats["flops_per_token"]),
            "hbm_bytes_per_token": float(
                stats.get("hbm_bytes_per_token", 0.0)),
            "flops_per_launch": float(stats.get("flops", 0.0)),
            "source": stats["source"],
        }
        return self._efficiency_stats

    # ---- page allocation -----------------------------------------------
    def _try_alloc(self) -> Optional[int]:
        """Pop a free page, evicting an unreferenced prefix-cache page
        under pressure (only table entries no live request holds go);
        None when neither can supply one."""
        c = self.caches[0]
        if not c._free and self.prefix_cache is not None:
            self.prefix_cache.evict(1)
            self._sync_prefix_stats()
        if not c._free:
            return None
        return c.allocate_block()

    def _sync_prefix_stats(self):
        """Publish the prefix cache's host-side stat counters (evictions
        by outcome, host-tier spills, hits and restores) into the
        metrics, diffed against the last published snapshot so each
        increment lands once."""
        pc = self.prefix_cache
        if pc is None:
            return
        pub = self._pc_published
        for attr, metric in (
                ("evictions", self._m_evict_reclaimed),
                ("skipped_pinned", self._m_evict_skipped),
                ("spills", self._m_host_spills),
                ("host_hits", self._m_host_hits),
                ("restores", self._m_host_restores)):
            cur = getattr(pc, attr)
            delta = cur - pub.get(attr, 0)
            if delta:
                metric.inc(delta)
                pub[attr] = cur

    def _alloc_block(self) -> int:
        blk = self._try_alloc()
        if blk is None:
            raise RuntimeError(
                "PagedKVCache out of blocks (%d in pool) and nothing "
                "evictable" % self.caches[0].num_blocks)
        return blk

    def _row_for(self, req: GenerationRequest) -> np.ndarray:
        row = np.full((1, self.bt_width), self._sink, np.int32)
        row[0, :len(req.block_ids)] = req.block_ids
        return row

    def _grow_pages(self) -> List[int]:
        """Lazy mode, before the step: every running slot must own a page
        for the position it writes (seq_len).  A slot neither the pool nor
        prefix-cache eviction can serve is the victim: finished early with ``truncated=True``, its
        pages back in the pool, the batch decoding on."""
        truncated = []
        cache = self.caches[0]
        for i, r in enumerate(list(self.slots)):
            if r is None or r.state != "running":
                continue
            need = cache.blocks_needed(r.seq_len + 1)
            while len(r.block_ids) < need:
                blk = self._try_alloc()
                if blk is None:
                    break
                self._bt[i, len(r.block_ids)] = blk
                r.block_ids.append(blk)
            if len(r.block_ids) < need:
                r.truncated = True
                self._m_truncated.inc()
                self._finish(r)
                truncated.append(r.req_id)
        return truncated

    # ---- admission -----------------------------------------------------
    def _admit(self):
        for i in range(self.max_batch_size):
            if not self.waiting or self.slots[i] is not None:
                continue
            if not self._try_admit(self.waiting[0], i):
                break                   # no room yet: keep waiting (FIFO)
            self.waiting.pop(0)

    def _try_admit(self, req: GenerationRequest, slot: int) -> bool:
        """Match the prompt against the prefix cache, reserve the
        request's pages (prompt + budget, or prompt + 1 in lazy mode) and
        start (or finish) its suffix prefill.  Returns False, with no side
        effects (a host-tier restore inside ``match`` aside, as in the
        reference), when the pool cannot cover it yet."""
        if (req.parent_req is not None
                and req.parent_req.state in ("waiting", "prefilling")):
            # an n > 1 child waits for its parent's prefill to publish the
            # shared pages, then admits as a whole-prompt hit
            return False
        cache = self.caches[0]
        pc = self.prefix_cache
        L = len(req.prompt_ids)
        matched: List[int] = []
        hit_len = 0
        cow = False
        if pc is not None:
            matched = pc.match(req.prompt_ids)
            hit_len = len(matched) * self.block_size
            if matched and hit_len >= L:
                # whole-prompt hit: the last position re-runs to sample the
                # first token, and its write lands in the last shared page,
                # which therefore gets a private copy
                hit_len = L - 1
                cow = True
        need = cache.blocks_needed(
            L + (1 if self.lazy_alloc else req.max_new_tokens))
        new_needed = need - len(matched) + (1 if cow else 0)
        available = len(cache._free)
        if pc is not None:
            available += pc.evictable_count(exclude=set(matched))
        if new_needed > available:
            return False

        if pc is not None:
            # literal label values: the metric lint pins label domains
            self._m_prefix_lookups.labels(
                outcome="hit" if matched else "miss").inc()
            if matched:
                pc.hits += 1
                pc.hit_tokens += hit_len
                self._m_prefix_hit_tokens.inc(hit_len)
            else:
                pc.misses += 1
        cache.share_blocks(matched)
        req.block_ids = list(matched)
        # evict the whole deficit up front, in ONE evict() call (one
        # batched spill); only after share_blocks, so the matched pages
        # hold a second reference and are never the victims
        short = new_needed - len(cache._free)
        if short > 0 and pc is not None:
            pc.evict(short)
            self._sync_prefix_stats()
        if cow:
            src = req.block_ids[-1]
            dst = self._alloc_block()
            self._copy_block(src, dst)
            if self.draft_caches:
                # the draft pools share the page ids: their copy of the
                # shared page moves with the target's
                copy_block(self.draft_caches, src, dst)
            cache.free_sequence([src])      # drop this request's share
            req.block_ids[-1] = dst
        while len(req.block_ids) < need:
            req.block_ids.append(self._alloc_block())
        req.prefill_pos = hit_len
        req.prefix_hit_tokens = hit_len
        # a prefix hit fills the draft pools too (the publisher's chunks
        # mirrored there); the suffix chunks mirror from prefill_pos on
        req.draft_len = hit_len
        req.slot = slot
        req.state = "prefilling"
        self.slots[slot] = req
        self.counters["requests_admitted"] += 1
        self.tracer.event(req.req_id, "admit", slot=slot,
                          prefix_hit_tokens=hit_len, prompt_tokens=L,
                          enqueue_ts=req.t_submit)
        if self.sampling:
            self._samp[slot] = self._samp_row(req)
        if self.mixed is not None:
            pass            # chunks ride the mixed step packed this step()
        elif self.prefill_step is None:
            self._prefill_dense(req)
        elif L - hit_len <= self.chunk_size:
            self._prefill_chunk(req)    # fits one bucket: at admission
        # else: one chunk per step(), interleaved with decode
        return True

    def _prefill_dense(self, req: GenerationRequest):
        """The whole prompt through the model's cache path once, its
        per-layer K/V written with ``prefill_scatter``, the first token
        the argmax of the last position."""
        t0 = time.perf_counter()
        L = len(req.prompt_ids)
        ids = torch.from_numpy(req.prompt_ids[None, :]).to(self.device)
        logits, kv = self.model(
            ids, [(None, None)] * self.cfg.num_hidden_layers)
        row = self._row_for(req)
        prefill_scatter(self.caches, kv, row)
        first = int(torch.argmax(logits[0, -1].to(torch.float32)))
        t1 = time.perf_counter()
        if L in self._prefill_warm_lens:
            self._m_prefill.observe(t1 - t0)
        self._prefill_warm_lens.add(L)
        self.tracer.span(req.req_id, "prefill_dense", t0, t1, tokens=L)
        req.prefill_pos = L
        self.prefill_tokens += len(req.prompt_ids)
        self._complete_prefill(req, first, row)

    def _bucket_for(self, size: int) -> int:
        for b in self.prefill_buckets:
            if b >= size:
                return b
        raise AssertionError("chunk of %d tokens exceeds the top bucket %d"
                             % (size, self.prefill_buckets[-1]))

    def _prefill_chunks(self):
        """Advance at most one pending prefill chunk, round-robin over
        slots, so a long prompt never stalls the running decodes."""
        if self.prefill_step is None:
            return
        n = self.max_batch_size
        for k in range(n):
            i = (self._chunk_rr + k) % n
            r = self.slots[i]
            if r is not None and r.state == "prefilling":
                self._prefill_chunk(r)
                self._chunk_rr = (i + 1) % n
                return

    def _prefill_chunk(self, req: GenerationRequest):
        """One bucket-padded chunk through the PrefillStep; the final
        chunk completes the prefill with its sampled first token."""
        L = len(req.prompt_ids)
        start = req.prefill_pos
        size = min(self.chunk_size, L - start)
        toks = np.zeros((1, self._bucket_for(size)), np.int32)
        toks[0, :size] = req.prompt_ids[start:start + size]
        row = self._row_for(req)
        t0 = time.perf_counter()
        pre = self.prefill_step.total_compiles
        first = self._prefill_call(
            toks, start, size, row,
            self._samp_row(req) if self.sampling else None)
        traced = self.prefill_step.total_compiles - pre
        t1 = time.perf_counter()
        if traced:
            # the first chunk of a bucket width stays out of the histogram
            self._m_prefill_compiles.inc(traced)
        else:
            self._m_prefill.observe(t1 - t0)
        self.tracer.span(req.req_id, "prefill_chunk", t0, t1, offset=start,
                         tokens=size, warm=not traced)
        req.prefill_pos += size
        self.prefill_tokens += size
        if req.prefill_pos >= L:
            self._complete_prefill(req, first, row)

    def _complete_prefill(self, req: GenerationRequest, first: int,
                          row: np.ndarray):
        slot = req.slot
        req.seq_len = len(req.prompt_ids)
        req.draft_len = req.seq_len     # the draft pool mirrored the prompt
        req.state = "running"
        if self.prefix_cache is not None:
            # publish the prompt's full pages for later admissions
            self.prefix_cache.register(req.prompt_ids, req.block_ids)
        self._append_token(req, first)
        if self.slots[slot] is req:     # still running after its budget
            self._tokens[slot] = first
            self._seq_lens[slot] = req.seq_len
            self._bt[slot] = row[0]

    # ---- split decode --------------------------------------------------
    def _decode_batch(self) -> List[int]:
        """ONE DecodeStep at the fixed slot count; masked slots (empty or
        still prefilling) ride along on the sink page."""
        done = self._grow_pages() if self.lazy_alloc else []
        if not any(r is not None and r.state == "running"
                   for r in self.slots):
            return done
        t0 = time.perf_counter()
        nxt = self._decode_call(self._tokens, self._seq_lens, self._bt,
                                self._samp if self.sampling else None)
        t1 = time.perf_counter()
        if self._decode_warm:
            self._m_decode.observe(t1 - t0)
        self._decode_warm = True
        if self.tracer.enabled:
            for r in self.slots:
                if r is not None and r.state == "running":
                    self.tracer.sample_span(
                        r.req_id, "decode_step", t0, t1,
                        every=self.trace_decode_every)
        for i, r in enumerate(list(self.slots)):
            if r is None or r.state != "running":
                continue
            r.seq_len += 1
            self._seq_lens[i] += 1
            self._append_token(r, int(nxt[i]))
            if self.slots[i] is r:
                self._tokens[i] = nxt[i]
            if r.state == "done":
                done.append(r.req_id)
        return done

    # ---- fused mixed prefill+decode step -------------------------------
    @staticmethod
    def _samp_row(req: GenerationRequest, seed_xor: int = 0) -> np.ndarray:
        """The request's packed sampling knobs (reference: ``_samp_row``):
        (temperature bits, top_k, top_p bits, seed), the fp knobs bitcast
        into their int32 lanes; ``seed_xor`` derives the draft's
        independent proposal stream from the same request seed."""
        row = np.empty(4, np.int32)
        row[0] = np.float32(req.temperature).view(np.int32)
        row[1] = req.top_k
        row[2] = np.float32(req.top_p).view(np.int32)
        row[3] = (req.seed ^ seed_xor) & 0x7FFFFFFF
        return row

    def _fill_mixed_pack(self, mx: MixedStep, budgets, spans):
        """Fill one MixedStep pack from span tuples ``(req, tokens, start,
        n_draft, seed_xor, masked)``: the span's tokens land at global
        positions ``start..start+m-1`` (kv_len = start+m), pages from the
        request's block table, the ``n_draft`` and knob columns when the
        step has them.  ``masked`` spans keep the padding descriptor
        (writes to the sink page, an all-sink block table) but occupy
        their span row, so output and probability rows stay slot-aligned
        across launches.  Returns ``(pack, B)``."""
        total = sum(len(sp[1]) for sp in spans)
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
        nd_col = W + 4 if mx.spec_k else -1
        sc = W + 4 + (1 if mx.spec_k else 0)
        off = 0
        for si, (r, toks, start, nd, sxor, masked) in enumerate(spans):
            m = len(toks)
            row = span_tab[si]
            row[W] = off
            row[W + 1] = m
            row[W + 3] = off + m - 1
            tokens[off:off + m] = toks
            if masked:
                # the slot's row, touching nothing live: an all-sink table,
                # writes on the sink page, kv_len the span itself
                row[W + 2] = m
                positions[off:off + m] = np.arange(m, dtype=np.int32)
                off += m
                continue
            row[W + 2] = start + m
            row[:len(r.block_ids)] = r.block_ids
            if nd_col >= 0:
                row[nd_col] = nd
            if mx.sampling:
                row[sc:sc + 4] = self._samp_row(r, sxor)
            pos = np.arange(start, start + m, dtype=np.int32)
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
        if self.draft_step is not None:
            return self._run_spec_round()
        done = self._grow_pages() if self.lazy_alloc else []
        spans, _ = self._pack_spans()
        if not spans:
            return done
        fill = [(r,
                 np.asarray([self._tokens[r.slot]], np.int32)
                 if kind == "decode"
                 else r.prompt_ids[start:start + size].astype(np.int32),
                 start, 0, 0, False)
                for r, kind, size, start in spans]
        pack, B = self._fill_mixed_pack(self.mixed, self.token_budgets,
                                        fill)
        t0 = time.perf_counter()
        pre = self.mixed.total_compiles
        nxt = self._mixed_call(pack, B)
        traced = self.mixed.total_compiles - pre
        t1 = time.perf_counter()
        n_dec = sum(1 for _, kind, _, _ in spans if kind == "decode")
        n_pre = sum(size for _, kind, size, _ in spans if kind != "decode")
        if n_dec:
            self._m_mixed_tok_decode.inc(n_dec)
        if n_pre:
            self._m_mixed_tok_prefill.inc(n_pre)
        if self._moe_layers:
            # dropless dispatch: every real token lands on exactly top_k
            # experts per MoE layer, none are dropped
            self._m_moe_routed.inc((n_dec + n_pre) * self._moe_topk
                                   * self._moe_layers)
        if traced:
            # the first step at a budget stays out of the histograms
            self._m_mixed_compiles.inc(traced)
        else:
            # the fused step is both rounds: its duration goes to the
            # histograms of whatever the pack advanced
            if n_dec:
                self._m_decode.observe(t1 - t0)
            if n_pre:
                self._m_prefill.observe(t1 - t0)
        if self.tracer.enabled:
            for r, kind, size, start in spans:
                if kind == "decode":
                    self.tracer.sample_span(
                        r.req_id, "decode_step", t0, t1,
                        every=self.trace_decode_every)
                else:
                    self.tracer.span(r.req_id, "prefill_chunk", t0, t1,
                                     offset=start, tokens=size,
                                     warm=not traced)
        for si, (r, kind, size, start) in enumerate(spans):
            tok = int(nxt[si])
            if kind == "decode":
                r.seq_len += 1
                self._seq_lens[r.slot] += 1
                self._append_token(r, tok)
                if self.slots[r.slot] is r:
                    self._tokens[r.slot] = tok
            else:
                r.prefill_pos += size
                self.prefill_tokens += size
                if r.prefill_pos >= len(r.prompt_ids):
                    # final chunk: tok is the sampled first token
                    # (earlier chunks' samples are discarded)
                    self._complete_prefill(r, tok, self._row_for(r))
            if r.state == "done":
                done.append(r.req_id)
        return done

    # ---- speculative decoding (draft_model=) -----------------------------
    def _spec_k_eff(self, req: GenerationRequest) -> int:
        """Draft depth for this request this round: never propose past the
        generation budget (a round emits at most k_eff + 1 tokens)."""
        remaining = req.max_new_tokens - len(req.output_ids)
        return max(0, min(self.spec_k, remaining - 1))

    def _grow_spec_pages(self, keff: Dict[int, int]):
        """Lazy mode: pages for the k_eff draft positions past the
        mandatory seq_len write are opportunistic — when the pool cannot
        cover a slot's full draft depth, the depth shrinks instead of
        truncating the request (``_grow_pages`` grew the mandatory
        page)."""
        c = self.caches[0]
        for r in self.slots:
            if r is None or r.state != "running":
                continue
            k = keff.get(r.slot, 0)
            while k > 0:
                need = c.blocks_needed(r.seq_len + 1 + k)
                while len(r.block_ids) < need:
                    blk = self._try_alloc()
                    if blk is None:
                        break
                    self._bt[r.slot, len(r.block_ids)] = blk
                    r.block_ids.append(blk)
                if len(r.block_ids) >= need:
                    break
                k -= 1
            keff[r.slot] = k

    def _run_draft_round(self, run_spans, chunk_spans, drafts):
        """The round's ``spec_k`` fused draft launches.  Launch 0 packs
        every running slot's catch-up span (the 1-2 accepted tokens the
        draft pool has not seen, ending at the current token) with the
        round's prefill-chunk mirrors, so the draft pool prefills the same
        prompts in the same rounds; launches 1..k-1 feed each freshly
        proposed token back.  A slot whose draft depth is capped below the
        launch index rides along masked (sink writes), keeping the output
        rows slot-aligned.  Fills ``drafts[slot]``; returns the launches'
        filtered proposal distributions (device-resident, sampled
        engines) for the verifier's rejection resampling."""
        q_list = []
        for i in range(self.spec_k):
            spans = []
            for r, k_eff in run_spans:
                masked = i >= k_eff
                if i == 0 and not masked:
                    cu = r.seq_len + 1 - r.draft_len
                    toks = np.asarray(r.output_ids[-cu:], np.int32)
                    start = r.draft_len
                elif masked:
                    toks = np.asarray([r.output_ids[-1]], np.int32)
                    start = r.seq_len + i
                else:
                    toks = np.asarray([drafts[r.slot][i - 1]], np.int32)
                    start = r.seq_len + i
                spans.append((r, toks, start, 0, DRAFT_SEED_XOR, masked))
            if i == 0:
                for r, size, start in chunk_spans:
                    spans.append((r, r.prompt_ids[start:start + size]
                                  .astype(np.int32), start, 0,
                                  DRAFT_SEED_XOR, False))
            if not spans:
                break
            t0 = time.perf_counter()
            pre = self.draft_step.total_compiles
            pack, B = self._fill_mixed_pack(self.draft_step,
                                            self.draft_budgets, spans)
            out = self.draft_step.call_packed(pack, B)
            if self.sampling:
                toks_np, probs = out
                q_list.append(probs)
            else:
                toks_np = out
            if self.draft_step.total_compiles == pre:
                self._m_draft_step.observe(time.perf_counter() - t0)
            for si, (r, _k) in enumerate(run_spans):
                drafts[r.slot].append(int(toks_np[si]))
            if not run_spans:
                break               # chunk mirror only, nothing to feed
        return q_list

    def _run_spec_round(self) -> List[int]:
        """One speculative round: ``spec_k`` fused draft launches propose
        per-slot token chains, ONE fused MixedStep launch verifies every
        slot's k+1 positions (and advances the prefill chunks riding the
        same pack), and the host applies the accepted prefix and the
        correction or bonus token.  Greedy output is byte-identical to
        the non-speculative engine's; sampled output is exact in
        distribution (rejection resampling on the device)."""
        done = self._grow_pages() if self.lazy_alloc else []
        keff: Dict[int, int] = {}
        for r in self.slots:
            if r is not None and r.state == "running":
                keff[r.slot] = self._spec_k_eff(r)
        if self.lazy_alloc:
            self._grow_spec_pages(keff)
        run_spans = [(r, keff[r.slot]) for r in self.slots
                     if r is not None and r.state == "running"]
        total_v = sum(k + 1 for _, k in run_spans)
        # chunk room must fit both packs that carry the chunks: the verify
        # pack (k_eff + 1 tokens a running slot) and the draft's launch 0
        # (at most 2 catch-up tokens a running slot)
        chunk_spans = self._pick_chunks(
            min(self.token_budgets[-1] - total_v,
                self.draft_budgets[-1] - 2 * len(run_spans)))
        if not run_spans and not chunk_spans:
            return done

        drafts: Dict[int, List[int]] = {r.slot: [] for r, _ in run_spans}
        q_list = self._run_draft_round(run_spans, chunk_spans, drafts)

        v_spans = []
        for r, k_eff in run_spans:
            toks = np.empty(k_eff + 1, np.int32)
            toks[0] = self._tokens[r.slot]
            if k_eff:
                toks[1:] = drafts[r.slot][:k_eff]
            v_spans.append((r, toks, r.seq_len, k_eff, 0, False))
        for r, size, start in chunk_spans:
            v_spans.append((r, r.prompt_ids[start:start + size]
                            .astype(np.int32), start, 0, 0, False))
        pack, B = self._fill_mixed_pack(self.mixed, self.token_budgets,
                                        v_spans)
        q_probs = None
        if self.sampling:
            q_list += [self._zero_q] * (self.spec_k - len(q_list))
            q_probs = tuple(q_list)
        t0 = time.perf_counter()
        pre = self.mixed.total_compiles
        nxt, n_acc = self._mixed_call(pack, B, q_probs=q_probs)
        traced = self.mixed.total_compiles - pre
        t1 = time.perf_counter()
        n_pre = sum(size for _, size, _ in chunk_spans)
        if traced:
            self._m_mixed_compiles.inc(traced)
        else:
            if run_spans:
                self._m_decode.observe(t1 - t0)
            if n_pre:
                self._m_prefill.observe(t1 - t0)
        if n_pre:
            self._m_mixed_tok_prefill.inc(n_pre)
        if self.tracer.enabled:
            for r, _k in run_spans:
                self.tracer.sample_span(
                    r.req_id, "decode_step", t0, t1,
                    every=self.trace_decode_every, speculative=True)
            for r, size, start in chunk_spans:
                self.tracer.span(r.req_id, "prefill_chunk", t0, t1,
                                 offset=start, tokens=size,
                                 warm=not traced)
        emitted = 0
        for si, (r, toks, start, nd, _x, _m) in enumerate(v_spans):
            if r.state == "prefilling":
                r.prefill_pos += len(toks)
                self.prefill_tokens += len(toks)
                if r.prefill_pos >= len(r.prompt_ids):
                    self._complete_prefill(r, int(nxt[si]),
                                           self._row_for(r))
                    if r.state == "done":
                        done.append(r.req_id)
                continue
            na = int(n_acc[si])
            k_eff = nd
            self.spec_proposed += k_eff
            self.spec_accepted += na
            self._m_spec_proposed.inc(k_eff)
            self._m_spec_accepted.inc(na)
            # the draft pool's correct prefix, marked before seq_len moves:
            # the slot's live launches fed cur@seq_len and d1..d_{k_eff-1},
            # and it ends at the last accepted fed position — the next
            # round's catch-up span starts there
            if k_eff >= 1:
                r.draft_len = r.seq_len + 1 + min(na, k_eff - 1)
            for t in drafts[r.slot][:na] + [int(nxt[si])]:
                r.seq_len += 1
                self._seq_lens[r.slot] += 1
                emitted += 1
                self._append_token(r, t)
                if r.state == "done":
                    done.append(r.req_id)
                    break
            if self.slots[r.slot] is r:
                self._tokens[r.slot] = r.output_ids[-1]
                if self.lazy_alloc:
                    # roll back the pages grown for rejected draft
                    # positions through the refcounted release path
                    c = self.caches[0]
                    keep = len(c.trim_blocks(r.block_ids, r.seq_len + 1))
                    del r.block_ids[keep:]
                    self._bt[r.slot, keep:] = self._sink
        if emitted:
            self._m_mixed_tok_decode.inc(emitted)
        return done

    def _append_token(self, req: GenerationRequest, token: int):
        req.output_ids.append(token)
        self.counters["tokens_generated"] += 1
        if len(req.output_ids) == 1:
            req.t_first_token = time.perf_counter()
            ttft = (req.t_first_token - req.t_submit if req.t_submit
                    else 0.0)
            if req.t_submit:
                self._m_ttft.observe(ttft)
            self.tracer.event(req.req_id, "first_token",
                              ts=req.t_first_token, ttft=ttft)
        hit_eos = (req.eos_token_id is not None
                   and token == req.eos_token_id)
        if len(req.output_ids) >= req.max_new_tokens or hit_eos:
            self._finish(req)

    def _release_slot(self, req: GenerationRequest):
        """Mask the request's slot back to token 0, seq_len 0 and the sink
        page, and release its pages through the ONE refcounted path."""
        if req.slot >= 0:
            s = req.slot
            self.slots[s] = None
            self._tokens[s] = 0
            self._seq_lens[s] = 0
            self._bt[s, :] = self._sink
            self._samp[s, :] = 0
        self.caches[0].free_sequence(req.block_ids)
        req.block_ids = []

    def _pending_chunks(self) -> int:
        n = 0
        for r in self.slots:
            if r is not None and r.state == "prefilling":
                rem = len(r.prompt_ids) - r.prefill_pos
                n += -(-rem // self.chunk_size)
        return n

    def _finish(self, req: GenerationRequest):
        req.state = "done"
        if self._finished_this_step is not None:
            self._finished_this_step.append(req.req_id)
        n_tok = len(req.output_ids)
        outcome = "truncated" if req.truncated else "completed"
        self._m_requests.labels(
            outcome="truncated" if req.truncated else "completed").inc()
        self._m_tokens.inc(n_tok)
        req.t_done = time.perf_counter()
        if n_tok > 1 and req.t_first_token:
            self._m_tpot.observe(
                (req.t_done - req.t_first_token) / (n_tok - 1))
        self.tracer.event(req.req_id, "finish", ts=req.t_done, tokens=n_tok,
                          outcome=outcome)
        self._release_slot(req)
        self.finished[req.req_id] = req
