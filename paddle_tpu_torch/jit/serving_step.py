"""The serving steps (counterpart of ``paddle_tpu/jit/serving_step.py``):
the fused mixed prefill+decode ``MixedStep``, and the split engine's
``DecodeStep`` (every slot one token), bucketed ``PrefillStep`` (one
padded prompt chunk) and ``prefill_scatter`` (the dense prefill's write);
and the page moves of the prefix cache: ``copy_block`` (copy-on-write of
a shared page) and ``extract_blocks`` / ``inject_blocks`` (pages to and
from a host :class:`~paddle_tpu_torch.ops.paged_attention.KVPageBuffer`,
the host tier's spill and restore).

One device, or one rank of a sharded mesh (``tp=``: the engine's
``jit.spmd.TPContext``; the model is then the rank's shard, the pools hold
its kv heads, and the steps add the reference's collectives: the
embedding sum, a sum after each o_proj and down projection, the logits
all-gather — exact, or int8 with ``quant_collectives`` — and the MoE
dispatch's all_to_alls).  Under an fsdp axis (``tp.fsdp_params``: the
engine's ``jit.spmd.FsdpParams``) each group of parameters — the embedding, each
decoder layer, the final norm, the LM head — is gathered back to its tp
compute shard just before it runs.  Under a cp axis the pools hold the
rank's slot stripe of every page: the host packs global in-page offsets
and each rank keeps the rows its stripe owns (:func:`_cp_local_dest`, the
rest to its own sink stripe), and the attention is the stripe's partial
softmax (``ops/paged_attention``'s ``*_partial``, plain PyTorch, as the
reference's) merged over the cp ranks in one all_gather a layer
(``ops/online_softmax.cross_chip_merge``).  Pools are fp32/bf16 or int8
(quantize on write, the int8 attention kernels on read).  Greedy by default; ``sampling=True``
puts the ``ops/sampling`` epilogue in each step (per-row temperature,
top-k, top-p and seed, carried in the step's one packed int32 host
buffer, temperature and top-p bitcast into their int32 lanes; each draw
keyed by the global position of the token it samples), and
``MixedStep(spec_k=K)`` verifies speculative spans of K + 1 tokens while
``MixedStep(return_probs=True)`` is the sampled draft that returns its
filtered distributions.  ``weights=`` (an :class:`~paddle_tpu_torch.ops.
dequant.Int8Weights`, the engine's ``weight_quant="int8"`` tree) makes a
step take every layer's projections (and a Mixtral layer's expert banks)
and the LM head from the int8 tree, dequantized on use one layer at a
time (``ops/dequant.py``).  The steps serve any model with an inner
``.llama`` (Llama, Qwen2) or ``.mixtral`` decoder stack: a Mixtral
layer's FFN is the dropless ``ops.moe_gate.moe_ffn`` (:func:`_ffn`), so
the engines never drop an assignment where the eager block may.  The
steps run eagerly (no CUDA graphs yet); the
reference's compiled modules have no counterpart, but ``compile_counts``
still records each distinct token budget or bucket width once
(``compile_count`` the decode step's one slot count), so the reference's
bounds (shapes seen <= the set's size) read the same.
"""
from __future__ import annotations

import contextlib
import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..models import _functional as PF
from ..models.llama import inner_model
from ..ops.dequant import layer_weights
from ..ops.kernels import rope_qkv_epilogue, rope_tables_for_positions
from ..ops.online_softmax import cross_chip_merge
from ..ops.paged_attention import (KVPageBuffer, _chunk_dest, _decode_dest,
                                   chunk_prefill_attention,
                                   chunk_prefill_attention_partial,
                                   paged_attention, paged_attention_partial,
                                   ragged_attention_partial,
                                   ragged_paged_attention,
                                   ragged_tensor_cores, ragged_work,
                                   write_chunk_kv,
                                   write_chunk_kv_q8, write_decode_kv,
                                   write_decode_kv_q8, write_prefill_kv,
                                   write_ragged_kv, write_ragged_kv_q8)
from ..ops.moe_gate import moe_ffn
from ..ops.sampling import (filtered_probs, greedy_sample, sample_logits,
                            spec_verify)
from .spmd import tp_embed, tp_gather_logits, tp_gather_logits_q8


def _local_heads(cfg, tp):
    """This rank's ``(query heads, kv heads)``: the config's over the tp
    degree."""
    deg = tp.degree if tp is not None else 1
    return cfg.num_attention_heads // deg, cfg.num_key_value_heads // deg


def _collective_bytes(tp, cfg, n_tokens: int, rows: int, q8: bool):
    """One sharded dispatch's per-rank collective payload ({} on one
    device; ``spmd.TPContext.collective_bytes``)."""
    if tp is None:
        return {}
    return tp.collective_bytes(cfg, n_tokens, rows, quant_gather=q8)


def _cp_comm(tp):
    """This rank's cp ``AxisComm``, or None without a cp axis."""
    return tp.cp_comm if tp is not None else None


def _cp_local_dest(dest_blocks, dest_offsets, bsl: int, index: int,
                   sink: int):
    """GLOBAL per-token write destinations -> this rank's slot stripe
    (reference: ``_cp_local_dest``): rank ``index`` holds slots
    ``[index * bsl, (index + 1) * bsl)`` of every page; a token whose
    global in-page offset falls there writes at the local offset, every
    other token goes to this rank's own stripe of the sink page, so each
    K/V row is written exactly once pool-wide."""
    lo = dest_offsets - index * bsl
    owned = (lo >= 0) & (lo < bsl)
    n = dest_offsets.shape[0]
    blk = torch.where(owned, dest_blocks, torch.full_like(dest_blocks, sink))
    off = torch.where(owned, lo, torch.arange(
        n, dtype=dest_offsets.dtype, device=dest_offsets.device) % bsl)
    return blk, off


def _cp_attend(q, partials, comm):
    """The stripe partials merged over the cp ranks, in ``q``'s dtype."""
    return cross_chip_merge(*partials, comm).to(q.dtype)


def _gathered(tp, key):
    """Group ``key``'s parameters at their tp compute shard for the block
    (the engine's ``jit.spmd.FsdpParams.gather``); nothing without an fsdp
    axis."""
    fsdp = tp.fsdp_params if tp is not None else None
    return contextlib.nullcontext() if fsdp is None else fsdp.gather(key)


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


def _proj(mod, name: str, h, w=None):
    """``mod.name`` (a ``Linear``) over ``h``: the model's weight, or the
    int8 tree's dequantized one from ``w`` (the bias always the
    model's)."""
    lin = getattr(mod, name)
    return lin(h) if w is None else F.linear(h, w[name], lin.bias)


def _tp_psum(t, tp):
    """The layer-boundary sum (reference: ``_tp_psum``): identity on one
    device, the sum of the row-sharded projection's partial products over
    the tp ranks otherwise."""
    if tp is None or tp.tp_comm is None:
        return t
    return tp.tp_comm.all_reduce(t)


def _embed(llama, tokens, tp):
    """The token embedding (reference: ``_embed``): the module's lookup on
    one device, the vocab-parallel masked lookup and exact sum under
    tp."""
    if tp is None or tp.tp_comm is None:
        return llama.embed_tokens(tokens)
    return tp_embed(llama.embed_tokens.weight, tokens, tp.tp_comm)


def _moe_ffn(blk, h, w=None, tp=None):
    """The dropless MoE FFN (reference: ``_moe_ffn``) in place of
    ``layer.mlp``: the block's top-k gate over the step's rows, each
    expert over its assigned rows, the weighted combine
    (``ops.moe_gate.moe_ffn``); under an ep axis the token stripes cross
    it through the two all_to_alls and one all_gather.  The banks are the
    rank's (its ``E/ep`` experts), or with int8 weights the tree's
    dequantized ones; the router is always the model's, replicated.  No
    tp sum: the combine is already the whole activation."""
    if w is None:
        banks = (blk.w_gate, blk.w_up, blk.w_down)
    else:
        banks = (w["w_gate"], w["w_up"], w["w_down"])
    ep = tp.ep_comm if tp is not None else None
    return moe_ffn(h, blk.gate.weight, *banks, top_k=blk.top_k,
                   ep_axis=ep, ep_degree=ep.size if ep is not None else 1)


def _ffn(layer, h, w=None, tp=None):
    """Per-layer FFN dispatch (reference: ``_ffn``), branching on the
    layer: the SwiGLU MLP of a Llama layer (column/row sharded, one sum
    under tp), the MoE FFN of a Mixtral layer."""
    if hasattr(layer, "block_sparse_moe"):
        return _moe_ffn(layer.block_sparse_moe, h, w, tp)
    mlp = layer.mlp
    return _tp_psum(_proj(mlp, "down_proj", PF.swiglu(
        _proj(mlp, "gate_proj", h, w), _proj(mlp, "up_proj", h, w)), w), tp)


def _attend_layer(layer, x, cos, sin, cache, write, attend, w=None,
                  tp=None):
    """One decoder layer of a serving step over ``x`` [N, h]: RMSNorm, the
    q/k/v projections (with their biases, Qwen2's), the fused RoPE + QKV
    epilogue kernel (with the per-token absmax of k and v for an int8
    pool), the in-place K/V write ``write(k, v, k_amax, v_amax)`` into
    ``cache``, the attention ``attend(q)`` -> [N, H, D], o_proj and the
    residual, then the FFN block (:func:`_ffn`).  ``w``: the layer's
    quantized weights by name, dequantized from the int8 tree (the
    model's own weights when None).  Under tp (``tp``: the engine's
    :class:`~paddle_tpu_torch.jit.spmd.TPContext`) the model is this
    rank's shard: the projections give the rank's heads, the pools hold
    its kv heads, and o_proj and the FFN end in a sum over
    the tp ranks."""
    N = x.shape[0]
    at = layer.self_attn
    D = at.head_dim
    h = layer.input_layernorm(x)
    # the head counts are the projections' (a rank's, under tp)
    q = _proj(at, "q_proj", h, w).view(N, -1, D)
    k = _proj(at, "k_proj", h, w).view(N, -1, D)
    v = _proj(at, "v_proj", h, w).view(N, -1, D)
    H = q.shape[1]
    q, k, k_amax, v_amax = rope_qkv_epilogue(q, k, v, cos, sin,
                                             with_amax=cache.quantized)
    write(k, v, k_amax, v_amax)
    x = x + _tp_psum(_proj(at, "o_proj", attend(q).reshape(N, H * D), w),
                     tp)
    return x + _ffn(layer, layer.post_attention_layernorm(x), w, tp)


def _layer_weights(weights, i: int):
    """Layer ``i``'s projections from the int8 tree (one dequant launch),
    or None for a step over the model's own weights."""
    return None if weights is None else weights.layer(i)


def _lm_logits(model, weights, h, tp=None, q8: bool = False):
    """The LM head over ``h``: the int8 tree's dequantized head (one
    launch) when it holds one, else the model's (gathered first under
    fsdp).  Under tp the head is the rank's vocab shard and the logits
    come back whole through the exact all-gather, or with ``q8`` the int8
    one (reference: ``_tp_logits``)."""
    head = None if weights is None else weights.lm_head()
    with _gathered(tp, "head"):
        out = model.lm_logits(h) if head is None else F.linear(h, head)
    if tp is None or tp.tp_comm is None:
        return out
    if q8:
        return tp_gather_logits_q8(out, tp.tp_comm)
    return tp_gather_logits(out, tp.tp_comm)


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


# ---------------------------------------------------------------------------
# page moves: copy-on-write, and pages to and from host RAM
# ---------------------------------------------------------------------------
def _page_pools(caches):
    """Every pool a page lives in, per dtype: the K then V pools of all
    layers, and an int8 pool's K then V scale tables."""
    pools = ([c.key_cache for c in caches]
             + [c.value_cache for c in caches])
    scales = ([c.key_scale for c in caches]
              + [c.value_scale for c in caches]
              if caches[0].quantized else [])
    return pools, scales


@torch.no_grad()
def copy_block(caches, src: int, dst: int) -> None:
    """Copy physical page ``src`` to ``dst`` IN PLACE in every layer's K
    and V pools (reference: ``copy_block``, the copy-on-write of a shared
    prefix page); an int8 pool's ``key_scale``/``value_scale`` rows travel
    with the page, so the copy dequantizes exactly as its source."""
    pools, scales = _page_pools(caches)
    for t in pools + scales:
        t[dst].copy_(t[src])


# host payload copies of the page moves (reference: MIGRATION_TRANSFERS):
# an extract adds one device-to-host copy per dtype (codes; + scales for
# int8 pools), an inject one host-to-device copy per dtype, whatever the
# page count
MIGRATION_TRANSFERS = {"d2h": 0, "h2d": 0}


def migration_transfers() -> dict:
    """Snapshot of the ``{d2h, h2d}`` host payload-copy counts."""
    return dict(MIGRATION_TRANSFERS)


def _to_wire(t: torch.Tensor) -> np.ndarray:
    """One device-to-host copy of ``t``; bf16 as its 16-bit patterns."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _from_wire(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """One host-to-device copy of the wire array ``a`` as ``dtype``."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).to(device).view(dtype)
    return torch.from_numpy(a).to(device)


@torch.no_grad()
def extract_blocks(caches, block_ids, n_tokens: int) -> KVPageBuffer:
    """Serialize physical pages ``block_ids`` of every layer's pools into
    one host :class:`KVPageBuffer` (reference: ``extract_blocks``): the
    pages are gathered on the device into one stacked buffer per dtype,
    which crosses to the host in ONE copy per dtype (int8 codes plus their
    scale rows).  The pools are only read."""
    ids = [int(b) for b in block_ids]
    if not ids:
        raise ValueError("extract_blocks needs at least one page")
    c0 = caches[0]
    pools, scales = _page_pools(caches)
    idx = torch.tensor(ids, dtype=torch.long).to(c0.key_cache.device)
    codes = _to_wire(torch.stack([t.index_select(0, idx) for t in pools]))
    MIGRATION_TRANSFERS["d2h"] += 1
    sc = None
    if scales:
        sc = _to_wire(torch.stack([t.index_select(0, idx) for t in scales]))
        MIGRATION_TRANSFERS["d2h"] += 1
    return KVPageBuffer(
        codes=codes, scales=sc, n_pages=len(ids), n_tokens=int(n_tokens),
        block_size=c0.block_size, num_kv_heads=c0.num_kv_heads,
        head_dim=c0.head_dim, num_layers=len(caches),
        kv_dtype=c0.kv_dtype)


@torch.no_grad()
def inject_blocks(caches, buf: KVPageBuffer, dest_blocks) -> None:
    """Scatter a :class:`KVPageBuffer`'s pages into ``dest_blocks`` of
    every layer's pools IN PLACE (reference: ``inject_blocks``): the
    buffer crosses to the device in ONE copy per dtype, then one indexed
    write per pool.  ``dest_blocks`` come from the target pool's
    refcounted ``allocate_block`` (the caller owns the references).  A
    buffer of another geometry or ``kv_dtype`` raises ``ValueError``
    before anything is written."""
    c0 = caches[0]
    here = (len(caches),) + c0.page_geometry()
    want = buf.geometry()
    if here != want:
        raise ValueError(
            "inject_blocks: pool geometry mismatch — buffer was extracted "
            "from (layers, block_size, kv_heads, head_dim, kv_dtype)=%r but "
            "the target pool is %r; KV pages only migrate between engines "
            "with identical pool geometry (including kv_dtype — int8 codes "
            "are meaningless in an fp pool and vice versa)" % (want, here))
    if len(dest_blocks) != buf.n_pages:
        raise ValueError(
            "inject_blocks: buffer holds %d page(s) but %d destination "
            "block(s) were allocated" % (buf.n_pages, len(dest_blocks)))
    pools, scales = _page_pools(caches)
    dev = c0.key_cache.device
    idx = torch.tensor([int(b) for b in dest_blocks],
                       dtype=torch.long).to(dev)
    codes = _from_wire(buf.codes, c0.key_cache.dtype, dev)
    MIGRATION_TRANSFERS["h2d"] += 1
    for i, t in enumerate(pools):
        t.index_copy_(0, idx, codes[i])
    if scales:
        sc = _from_wire(buf.scales, torch.float32, dev)
        MIGRATION_TRANSFERS["h2d"] += 1
        for i, t in enumerate(scales):
            t.index_copy_(0, idx, sc[i])


def launch_cost(model, caches, weights, rows: int, lm_rows: int,
                spans) -> dict:
    """FLOPs and bytes of ONE serving-step launch, counted analytically
    (the counterpart of the reference's ``compiled_cost_stats``, which
    reads the compiled XLA module's ``cost_analysis``: these numbers
    describe the port's own launch, not that module).

    ``rows`` packed token rows run every decoder layer; ``lm_rows`` rows
    reach the LM head; ``spans`` is the attention's ``[(q_len, kv_len)]``
    (padding spans attend nothing and are left out).

    - ``flops``: the GEMMs — 2 x in x out per row for each of a layer's
      seven quantizable weights, and 2 x hidden x vocab per LM-head row —
      plus the attention kernels' own work, 4 per visible (query head,
      key, head-dim) triple (row ``r`` of a span sees ``kv_len - q_len +
      r + 1`` keys).  A Mixtral layer's expert banks count whole, as if
      every row ran every expert: the reference's dense count (its XLA
      cost analysis counts the dense dispatch buffers), which overstates
      a MoE step's routed expert work ``E / k`` times; the router is not
      counted.
    - ``bytes_accessed``: the weights read once (the seven of every layer
      and the LM head in the model dtype, or under
      ``weight_quant="int8"`` the tree's int8 codes and fp32 scales), the
      KV pages the attention reads (each span's ``kv_len`` tokens of K
      and V in every layer; int8 pools add each read page's two fp32
      scale rows) and the pages written (every packed row's K and V in
      every layer; int8 pools add one fp32 scale a head for each).

    ``tokens`` is ``rows``, the launch's packed capacity, and the per-token
    numbers amortize over it (padding rows run the GEMMs too)."""
    cfg = model.config
    llama = inner_model(model)
    H, h, V = cfg.num_attention_heads, cfg.hidden_size, cfg.vocab_size
    c0 = caches[0]
    L, Hkv, D, bs = len(caches), c0.num_kv_heads, c0.head_dim, c0.block_size
    pool_isz = c0.key_cache.element_size()
    head = (model.lm_head.weight if model.lm_head is not None
            else llama.embed_tokens.weight)
    proj = [w for layer in llama.layers for _n, w in layer_weights(layer)]
    gemm = 2.0 * rows * sum(w.numel() for w in proj) \
        + 2.0 * lm_rows * h * V
    pairs = sum(sum(kvl - ql + r + 1 for r in range(ql))
                for ql, kvl in spans)
    flops = gemm + 4.0 * L * pairs * H * D
    if weights is not None:
        w_bytes = weights.nbytes + (
            head.numel() * head.element_size() if weights.head is None
            else 0)
    else:
        w_bytes = sum(w.numel() * w.element_size() for w in proj + [head])
    kv_read = sum(kvl for _, kvl in spans) * Hkv * D * pool_isz * 2
    kv_write = rows * Hkv * D * pool_isz * 2
    if c0.quantized:
        kv_read += sum(-(-kvl // bs) for _, kvl in spans) * Hkv * 4 * 2
        kv_write += rows * Hkv * 4 * 2
    n_bytes = w_bytes + L * (kv_read + kv_write)
    return {"tokens": int(rows), "source": "analytic",
            "flops": float(flops), "bytes_accessed": float(n_bytes),
            "flops_per_token": float(flops) / rows,
            "hbm_bytes_per_token": float(n_bytes) / rows}


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
                 return_probs: bool = False, weights=None, tp=None,
                 quant_collectives: bool = False):
        self.model = model
        self.weights = weights
        self.tp = tp
        self.q8_gather = bool(quant_collectives) and tp is not None \
            and tp.degree > 1
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

    def collective_bytes(self, T: int) -> dict:
        """Per-rank collective payload of one sharded step at budget ``T``
        ({} on one device; reference: ``MixedStep.collective_bytes``)."""
        return _collective_bytes(self.tp, self.cfg, T, self.max_spans,
                                 self.q8_gather)

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
        llama = inner_model(self.model)
        D = cfg.hidden_size // cfg.num_attention_heads
        S, W, EX = self.max_spans, self.bt_width, self.row_extra
        scale = 1.0 / math.sqrt(D)
        span_q = min(self.span_q, T)

        c0 = self.caches[0]
        H, Hkv = _local_heads(cfg, self.tp)
        cp = _cp_comm(self.tp)
        work = None
        if self.device.type == "cuda" and cp is None and ragged_tensor_cores(
                cfg.torch_dtype, c0.quantized, c0.block_size, D, H // Hkv):
            # the ragged kernel's work list, built here from the host
            # pack's span lengths and shipped in the pack's one copy
            spans = pack[4 * T:].reshape(S, W + EX)
            work_host = ragged_work(spans[:, W + 1], spans[:, W + 2], H,
                                    Hkv, c0.block_size)
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
        if cp is not None:
            # the host packed GLOBAL in-page offsets; the span lengths the
            # partials loop over are read from the host pack
            bsl = c0.key_cache.shape[1]
            dest_blocks, dest_offsets = _cp_local_dest(
                dest_blocks, dest_offsets, bsl, cp.index, self.sink)
            host = pack[4 * T:].reshape(S, W + EX)
            spans = (host[:, W], host[:, W + 1], host[:, W + 2])

        with _gathered(self.tp, "embed"):
            x = _embed(llama, tokens, self.tp)                 # [T, h]
        # rope tables built ONCE per step: positions are layer-invariant
        cos, sin = rope_tables_for_positions(tok_tab[1], D, cfg.rope_theta)
        for i, (layer, cache) in enumerate(zip(llama.layers, self.caches)):
            def write(k, v, ka, va, c=cache):
                if c.quantized:
                    write_ragged_kv_q8(k, v, c.key_cache, c.value_cache,
                                       c.key_scale, c.value_scale,
                                       dest_blocks, dest_offsets, ka, va)
                else:
                    write_ragged_kv(k, v, c.key_cache, c.value_cache,
                                    dest_blocks, dest_offsets)

            def attend(q, c=cache):
                if cp is not None:
                    return _cp_attend(q, ragged_attention_partial(
                        q, c.key_cache, c.value_cache, bt, *spans, scale,
                        cp.index * bsl, c.block_size), cp)
                return ragged_paged_attention(
                    q, c.key_cache, c.value_cache, bt, q_offsets, q_lens,
                    kv_lens, scale, span_q=span_q, key_scale=c.key_scale,
                    value_scale=c.value_scale, work=work)
            with _gathered(self.tp, i):
                x = _attend_layer(layer, x, cos, sin, cache, write, attend,
                                  _layer_weights(self.weights, i), self.tp)
        with _gathered(self.tp, "norm"):
            x = llama.norm(x)
        return x, tok_tab, span_tab

    def _lm(self, h):
        return _lm_logits(self.model, self.weights, h, self.tp,
                          self.q8_gather)

    def launch_stats(self, T: int, kv_len: int) -> dict:
        """:func:`launch_cost` of one budget-``T`` all-decode launch: every
        one of the ``max_spans`` spans a decode span (``spec_k + 1``
        tokens under speculation) attending ``kv_len`` keys, the rest of
        the budget padding; each span's sample row (and, under
        speculation, its ``spec_k + 1`` verify rows) reaches the LM head.
        The counterpart of the reference's ``compiled_stats(T)``."""
        q = self.spec_k + 1
        if T < self.max_spans * q:
            raise ValueError("budget %d holds no all-decode pack of %d "
                             "spans of %d" % (T, self.max_spans, q))
        lm_rows = self.max_spans * ((self.spec_k + 2) if self.spec_k
                                    else 1)
        return launch_cost(self.model, self.caches, self.weights, T,
                           lm_rows, [(q, kv_len)] * self.max_spans)

    def logits_packed(self, pack: np.ndarray, T: int) -> torch.Tensor:
        """Run one packed step and return the fp32 logits of each span's
        sample row, ``[max_spans, V]`` on the device (the pools are
        updated in place)."""
        x, _, span_tab = self._forward(pack, T)
        rows = span_tab[:, self.bt_width + 3].long()
        with torch.no_grad():
            return self._lm(x[rows]).to(torch.float32)

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
            lv3 = self._lm(x[rows]).to(torch.float32).view(
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
        lv = self._lm(x[span_tab[:, W + 3].long()]).to(torch.float32)
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
                 sampling: bool = False, weights=None, tp=None,
                 quant_collectives: bool = False):
        self.model = model
        self.weights = weights
        self.tp = tp
        self.q8_gather = bool(quant_collectives) and tp is not None \
            and tp.degree > 1
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

    def collective_bytes(self, C: int) -> dict:
        """Per-rank collective payload of one sharded chunk of bucket
        width ``C`` (one logits row; {} on one device)."""
        return _collective_bytes(self.tp, self.cfg, C, 1, self.q8_gather)

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
        llama = inner_model(self.model)
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
        cp = _cp_comm(self.tp)
        if cp is not None:
            # the chunk's global destinations, then this rank's stripe
            c0 = self.caches[0]
            bsl = c0.key_cache.shape[1]
            blk, off = _cp_local_dest(*_chunk_dest(
                C, c0.block_size, row, start, n_valid, self.sink), bsl,
                cp.index, self.sink)
        with _gathered(self.tp, "embed"):
            x = _embed(llama, ids, self.tp)                    # [C, h]
        for i, (layer, cache) in enumerate(zip(llama.layers, self.caches)):
            def write(k, v, ka, va, c=cache):
                if cp is not None:
                    write_ragged_kv(k, v, c.key_cache, c.value_cache, blk,
                                    off)
                elif c.quantized:
                    write_chunk_kv_q8(k[None], v[None], c.key_cache,
                                      c.value_cache, c.key_scale,
                                      c.value_scale, row, start, n_valid,
                                      self.sink, ka, va)
                else:
                    write_chunk_kv(k[None], v[None], c.key_cache,
                                   c.value_cache, row, start, n_valid,
                                   self.sink)

            def attend(q, c=cache):
                if cp is not None:
                    o, m, l = chunk_prefill_attention_partial(
                        q[None], c.key_cache, c.value_cache, row, start,
                        scale, cp.index * bsl, c.block_size)
                    return _cp_attend(q, (o[0], m[0], l[0]), cp)
                return chunk_prefill_attention(
                    q[None], c.key_cache, c.value_cache, row, start, scale,
                    c.key_scale, c.value_scale)[0]
            with _gathered(self.tp, i):
                x = _attend_layer(layer, x, cos, sin, cache, write, attend,
                                  _layer_weights(self.weights, i), self.tp)
        with _gathered(self.tp, "norm"):
            last = llama.norm(x[n_valid - 1:n_valid])
        logits = _lm_logits(self.model, self.weights, last, self.tp,
                            self.q8_gather)
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

    def __init__(self, model, caches: List, sampling: bool = False,
                 weights=None, tp=None, quant_collectives: bool = False):
        self.model = model
        self.weights = weights
        self.tp = tp
        self.q8_gather = bool(quant_collectives) and tp is not None \
            and tp.degree > 1
        self.caches = caches
        self.cfg = model.config
        self.sampling = bool(sampling)
        self.sink = _need_sink(caches, "DecodeStep")
        self.device = caches[0].key_cache.device
        self.compile_count = 0

    def collective_bytes(self, slots: int) -> dict:
        """Per-rank collective payload of one sharded decode step over
        ``slots`` slots ({} on one device)."""
        return _collective_bytes(self.tp, self.cfg, slots, slots,
                                 self.q8_gather)

    def launch_stats(self, slots: int, kv_len: int) -> dict:
        """:func:`launch_cost` of one decode launch at ``slots`` slots,
        each attending ``kv_len`` keys (one token a slot).  The
        counterpart of the reference's ``compiled_stats(slots)``."""
        return launch_cost(self.model, self.caches, self.weights, slots,
                           slots, [(1, kv_len)] * slots)

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
        llama = inner_model(self.model)
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
        cp = _cp_comm(self.tp)
        if cp is not None:
            # each slot's global destination, then this rank's stripe; the
            # host's longest sequence bounds the pages the partials read
            c0 = self.caches[0]
            bsl = c0.key_cache.shape[1]
            blk, off = _cp_local_dest(*_decode_dest(bt_d, lens,
                                                    c0.block_size),
                                      bsl, cp.index, self.sink)
            longest = int(parts[1].max()) + 1
        with _gathered(self.tp, "embed"):
            x = _embed(llama, tok, self.tp)                    # [S, h]
        for i, (layer, cache) in enumerate(zip(llama.layers, self.caches)):
            def write(k, v, ka, va, c=cache):
                if cp is not None:
                    write_ragged_kv(k, v, c.key_cache, c.value_cache, blk,
                                    off)
                elif c.quantized:
                    write_decode_kv_q8(k, v, c.key_cache, c.value_cache,
                                       c.key_scale, c.value_scale, bt_d,
                                       lens, ka, va)
                else:
                    write_decode_kv(k, v, c.key_cache, c.value_cache, bt_d,
                                    lens)

            def attend(q, c=cache):
                if cp is not None:
                    return _cp_attend(q, paged_attention_partial(
                        q, c.key_cache, c.value_cache, bt_d, seen, scale,
                        cp.index * bsl, c.block_size, longest), cp)
                return paged_attention(q, c.key_cache, c.value_cache, bt_d,
                                       seen, scale, c.key_scale,
                                       c.value_scale)
            with _gathered(self.tp, i):
                x = _attend_layer(layer, x, cos, sin, cache, write, attend,
                                  _layer_weights(self.weights, i), self.tp)
        with _gathered(self.tp, "norm"):
            x = llama.norm(x)
        logits = _lm_logits(self.model, self.weights, x, self.tp,
                            self.q8_gather)
        if not self.sampling:
            return greedy_sample(logits).cpu().numpy()
        knobs = _samp_knobs(dev_pack[2 * S + S * W:].view(S, 4))
        return sample_logits(logits, *knobs, seen).cpu().numpy()
