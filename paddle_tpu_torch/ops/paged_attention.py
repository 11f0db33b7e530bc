"""Paged KV cache and paged attention (counterpart of
``paddle_tpu/ops/paged_attention.py``).

The KV cache is a pool of fixed-size pages ``[phys, block_size, kv_heads,
head_dim]`` per layer on the device; sequences address it through block
tables.  The free list and refcounts are host state (allocation is
control flow, not compute).  ``kv_dtype="int8"`` stores symmetric int8
codes with per-page, per-head fp32 absmax scales; every write quantizes
on write with a running-max scale.

Kernels (CUDA C++, built by ``_build.py``):

- ``csrc/ragged_paged_attention.cu`` replaces ``_ragged_paged_kernel``
  (``paddle_tpu/ops/pallas_kernels.py``, launched by
  ``_ragged_paged_attention_pallas``): the mixed step's attention, for
  fp32/bf16 pools and, with ``key_scale``/``value_scale``, int8 pools.
  bf16 q runs its tensor-core kernel over a work list built on the host
  (:func:`ragged_work`: chunk tiles on ``mma.sync``, decode spans split
  over a block's warps, and a long one over several blocks); fp32 q runs
  its CUDA-core kernel;
- ``csrc/paged_decode_attention.cu`` replaces ``_paged_decode_kernel``
  (launched by ``_paged_attention_pallas``): the split engine's decode
  attention, one query per slot, for the same pool types; each slot's
  pages stream through shared memory by ``cp.async`` and may split over
  several blocks (:func:`decode_splits`), merged in split order.

Their fast kernels take every head dim that is a multiple of 8 up to
128 (:func:`kernel_head_dim`): they are built at 32, 64, 96 and 128 and
read the pools' rows at their real width.  Each source also holds a
generic CUDA-core kernel (``csrc/paged_generic.cuh``) for the shapes the
fast ones do not take: any other head dim, more than 32 query heads a kv
head (#5), int8 pools of block size over 64 (#5) and block sizes over 128
(#7).  The wrappers choose by shape alone (:func:`ragged_generic`,
:func:`decode_generic`); both count in the same launch counters.  Each
source note gives its design: the pools are read in place, in their own
dtype, and only the used pages of each sequence are read.  The int8
variants compute what the Pallas int8 path computes: each q row and each
probability row (per page) quantized per row, both products on the codes
with exact integer sums, the scales folded in afterwards.

Every wrapper takes its plain PyTorch version for CPU tensors and
launches its kernel (or raises) for CUDA tensors, counting the launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional

import numpy as np
import torch

from .. import _build
from ..quantization.functional import (dequantize_symmetric,
                                       fold_int8_scores, quantize_symmetric,
                                       quantize_rows_symmetric)
from .online_softmax import online_softmax_update

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_WIDTHS = (32, 64, 96, 128)   # the head dims the kernels are built at
_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}

# The declared tolerance of the int8 kernels against the dequantizing
# reference path (the reference's ``KERNEL_INT8_REL_TOL``): relative to
# the largest dequantized value in the pool.  The kernels quantize each q
# row and each probability row, which the dequantizing path does not;
# the reference measured ~5e-3 at unit-variance data.
KERNEL_INT8_REL_TOL = 0.02


class PagedKVCache:
    """One layer's K/V page pools plus the host free list and refcounts
    (reference: ``PagedKVCache``).

    ``sink_block=True`` adds one extra physical page, never in the free
    list, exposed as ``.sink``: the steps route the writes of padding
    tokens and masked slots there, so occupancy changes never corrupt
    live pages.  Pages are refcounted; ``free_sequence`` is the single
    release path.

    ``kv_dtype="int8"`` stores int8 codes plus per-page, per-head fp32
    absmax scales ``key_scale``/``value_scale`` [phys, Hkv], zero until
    written (``quantized`` is then True); ``"float32"``/``"bfloat16"``
    override ``dtype``; ``None`` keeps it.
    """

    def __init__(self, num_blocks: int, block_size: int, num_kv_heads: int,
                 head_dim: int, dtype: torch.dtype = torch.float32,
                 sink_block: bool = False, device=None,
                 kv_dtype: Optional[str] = None):
        if kv_dtype is not None and kv_dtype not in _KV_DTYPES:
            raise ValueError(
                "PagedKVCache kv_dtype must be one of None (use dtype), "
                "'float32', 'bfloat16' or 'int8'; got %r" % (kv_dtype,))
        if kv_dtype is not None:
            dtype = _KV_DTYPES[kv_dtype]
        self.quantized = dtype == torch.int8
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.sink = num_blocks if sink_block else -1
        phys = num_blocks + (1 if sink_block else 0)
        shape = (phys, block_size, num_kv_heads, head_dim)
        self.key_cache = torch.zeros(shape, dtype=dtype, device=device)
        self.value_cache = torch.zeros(shape, dtype=dtype, device=device)
        self.key_scale = self.value_scale = None
        if self.quantized:
            self.key_scale = torch.zeros((phys, num_kv_heads),
                                         dtype=torch.float32, device=device)
            self.value_scale = torch.zeros_like(self.key_scale)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref: dict = {}            # block id -> live reference count

    def pool_bytes(self) -> int:
        """Device bytes of this layer's K+V pools, an int8 pool's scale
        tables included (the capacity the int8 pool is judged by)."""
        arrs = [self.key_cache, self.value_cache]
        if self.quantized:
            arrs += [self.key_scale, self.value_scale]
        return sum(a.numel() * a.element_size() for a in arrs)

    def allocate_block(self) -> int:
        if not self._free:
            raise RuntimeError(
                "PagedKVCache out of blocks (%d in pool); raise num_blocks "
                "or free finished sequences" % self.num_blocks)
        b = self._free.pop()
        self._ref[b] = 1
        return b

    def refcount(self, block_id: int) -> int:
        return self._ref.get(int(block_id), 0)

    def free_sequence(self, block_ids):
        """Drop one reference per page; recycle pages that hit zero."""
        for b in block_ids:
            b = int(b)
            if b < 0 or b == self.sink:
                continue
            n = self._ref.pop(b, 1) - 1
            if n > 0:
                self._ref[b] = n
            else:
                self._free.append(b)

    def blocks_needed(self, seq_len: int) -> int:
        return -(-seq_len // self.block_size)

    def trim_blocks(self, block_ids, n_tokens: int):
        """Speculative-decode rollback (reference: ``trim_blocks``):
        release the tail pages past what ``n_tokens`` needs (pages grown
        for draft positions the verifier rejected) through the refcounted
        release path, and return the kept prefix."""
        keep = self.blocks_needed(max(int(n_tokens), 1))
        if keep >= len(block_ids):
            return list(block_ids)
        self.free_sequence(block_ids[keep:])
        return list(block_ids[:keep])


def write_ragged_kv(k_new: torch.Tensor, v_new: torch.Tensor,
                    key_cache: torch.Tensor, value_cache: torch.Tensor,
                    dest_blocks: torch.Tensor,
                    dest_offsets: torch.Tensor) -> None:
    """Scatter a packed ragged batch's K/V rows [T, Hkv, D] into the pools
    IN PLACE: token ``t`` lands at ``(dest_blocks[t], dest_offsets[t])``.
    The caller routes padding tokens to the sink page.  The reference
    scatters in XLA outside any kernel; here it is one ``index_put_`` per
    pool into the preallocated pages (no pool copy)."""
    idx = (dest_blocks, dest_offsets)
    key_cache.index_put_(idx, k_new)
    value_cache.index_put_(idx, v_new)


def write_decode_kv(k_new, v_new, key_cache, value_cache, block_tables,
                    seq_lens) -> None:
    """The decode append IN PLACE: slot ``b``'s row [B, Hkv, D] lands at
    position ``seq_lens[b]`` of its block table (masked slots aim at the
    sink page)."""
    blk, off = _decode_dest(block_tables, seq_lens, key_cache.shape[1])
    key_cache.index_put_((blk, off), k_new)
    value_cache.index_put_((blk, off), v_new)


def write_prefill_kv(k_new, v_new, key_cache, value_cache, block_tables,
                     seq_lens) -> None:
    """A whole prompt's K/V [B, S, Hkv, D] IN PLACE at positions
    ``seq_lens[b] + i``, one scatter for all of it."""
    bs = key_cache.shape[1]
    pos = (seq_lens.to(torch.long)[:, None]
           + torch.arange(k_new.shape[1], device=k_new.device)[None, :])
    blk = torch.gather(block_tables.to(torch.long), 1, pos // bs)
    key_cache.index_put_((blk, pos % bs), k_new)
    value_cache.index_put_((blk, pos % bs), v_new)


def write_chunk_kv(k_new, v_new, key_cache, value_cache, block_table_row,
                   start, n_valid, sink: int) -> None:
    """One bucket-padded prefill chunk [1, C, Hkv, D] IN PLACE: position
    ``i`` lands at sequence position ``start + i``; padding (``i >=
    n_valid``) goes to the sink page's slot 0."""
    blk, off = _chunk_dest(k_new.shape[1], key_cache.shape[1],
                           block_table_row, start, n_valid, sink)
    key_cache.index_put_((blk, off), k_new[0])
    value_cache.index_put_((blk, off), v_new[0])


def _decode_dest(block_tables, seq_lens, bs: int):
    pos = seq_lens.to(torch.long)
    blk = torch.gather(block_tables.to(torch.long), 1,
                       (pos // bs)[:, None])[:, 0]
    return blk, pos % bs


def _chunk_dest(C: int, bs: int, block_table_row, start, n_valid,
                sink: int):
    """Destination (page, slot) of each chunk position; the table lookup
    clamps past the row's end (those positions are padding, and go to the
    sink anyway)."""
    dev = block_table_row.device
    idx = torch.arange(C, device=dev)
    pos = idx + start
    row = block_table_row[0].to(torch.long)
    blk = row[torch.clamp(pos // bs, max=row.shape[0] - 1)]
    valid = idx < n_valid
    blk = torch.where(valid, blk, torch.full_like(blk, sink))
    off = torch.where(valid, pos % bs, torch.zeros_like(pos))
    return blk, off


# ---------------------------------------------------------------------------
# int8 writes: quantize on write with a running-max scale per page and head
# ---------------------------------------------------------------------------
def _scatter_max(scale, blks, amax):
    """``scale`` with each row ``blks[t]`` raised to at least ``amax[t]``
    (duplicate rows accumulate), as a new tensor."""
    idx = blks[:, None].expand(-1, scale.shape[1])
    return scale.clone().scatter_reduce_(0, idx, amax, "amax")


def _quant_write_tokens(cache, scale, new_vals, blks, offs,
                        amax=None) -> None:
    """The core of every int8 write, IN PLACE: ``cache`` [phys, bs, Hkv,
    D] int8 and ``scale`` [phys, Hkv] fp32; token ``t`` of ``new_vals``
    [N, Hkv, D] lands at ``(blks[t], offs[t])``.

    A scatter-max folds the new rows' absmax (``amax`` [N, Hkv] when the
    epilogue computed it) into each touched page's scale; the touched
    pages' existing codes are rescaled by old/new (ratio 1, bit-exact,
    while a scale does not move); then the new rows are quantized with
    the final scale.  The reference's expressions in its order."""
    blks, offs = blks.to(torch.long), offs.to(torch.long)
    vals = new_vals.to(torch.float32)
    if amax is None:
        amax = vals.abs().amax(dim=-1)                    # [N, Hkv]
    new_scale = _scatter_max(scale, blks, amax)
    ratio = torch.where(new_scale > 0,
                        scale / new_scale.clamp_min(1e-30),
                        torch.ones((), device=scale.device))
    pages = cache[blks].to(torch.float32) * ratio[blks][:, None, :, None]
    cache.index_put_((blks,), torch.round(pages).to(cache.dtype))
    q = quantize_symmetric(vals, new_scale[blks][:, :, None])
    cache.index_put_((blks, offs), q.to(cache.dtype))
    scale.copy_(new_scale)


def _quant_write_one_per_page(cache, scale, new_vals, blks, offs,
                              amax=None) -> None:
    """``_quant_write_tokens`` for at most one token per live page (the
    decode append): the rescaled page and its new row merge into one
    page-wise scatter."""
    bs = cache.shape[1]
    blks, offs = blks.to(torch.long), offs.to(torch.long)
    vals = new_vals.to(torch.float32)
    if amax is None:
        amax = vals.abs().amax(dim=-1)
    new_scale = _scatter_max(scale, blks, amax)
    ratio = torch.where(new_scale > 0,
                        scale / new_scale.clamp_min(1e-30),
                        torch.ones((), device=scale.device))
    pages = torch.round(cache[blks].to(torch.float32)
                        * ratio[blks][:, None, :, None])
    q = quantize_symmetric(vals, new_scale[blks][:, :, None])
    row = (torch.arange(bs, device=cache.device)[None, :]
           == offs[:, None])
    pages = torch.where(row[:, :, None, None], q[:, None], pages)
    cache.index_put_((blks,), pages.to(cache.dtype))
    scale.copy_(new_scale)


def write_decode_kv_q8(k_new, v_new, key_cache, value_cache, key_scale,
                       value_scale, block_tables, seq_lens, k_amax=None,
                       v_amax=None) -> None:
    """int8 ``write_decode_kv``, IN PLACE.  Precondition: at most one
    live page per slot (each slot appends to its own tail page; only
    masked slots share the sink page)."""
    blk, off = _decode_dest(block_tables, seq_lens, key_cache.shape[1])
    _quant_write_one_per_page(key_cache, key_scale, k_new, blk, off,
                              k_amax)
    _quant_write_one_per_page(value_cache, value_scale, v_new, blk, off,
                              v_amax)


def write_chunk_kv_q8(k_new, v_new, key_cache, value_cache, key_scale,
                      value_scale, block_table_row, start, n_valid,
                      sink: int, k_amax=None, v_amax=None) -> None:
    """int8 ``write_chunk_kv``, IN PLACE (padding to the sink page)."""
    blk, off = _chunk_dest(k_new.shape[1], key_cache.shape[1],
                           block_table_row, start, n_valid, sink)
    _quant_write_tokens(key_cache, key_scale, k_new[0], blk, off, k_amax)
    _quant_write_tokens(value_cache, value_scale, v_new[0], blk, off,
                        v_amax)


def write_ragged_kv_q8(k_new, v_new, key_cache, value_cache, key_scale,
                       value_scale, dest_blocks, dest_offsets, k_amax=None,
                       v_amax=None) -> None:
    """int8 ``write_ragged_kv``, IN PLACE: the packed token batch of the
    mixed step."""
    _quant_write_tokens(key_cache, key_scale, k_new, dest_blocks,
                        dest_offsets, k_amax)
    _quant_write_tokens(value_cache, value_scale, v_new, dest_blocks,
                        dest_offsets, v_amax)


def dequant_pages(pages, page_scale):
    """int8 pages ``[..., bs, Hkv, D]`` times their ``page_scale [...,
    Hkv]`` to fp32."""
    return dequantize_symmetric(pages, page_scale[..., None, :, None])


def chunk_prefill_attention(q, key_cache, value_cache, block_table_row,
                            start: int, scale: float, key_scale=None,
                            value_scale=None):
    """Causal attention of one padded prefill chunk over the paged cache
    (the reference's XLA-only ``chunk_prefill_attention``; plain torch on
    both devices).

    ``q`` [1, C, H, D] at positions ``start .. start + C - 1`` (the
    chunk's own K/V already written).  Only the chunk's used pages
    ``ceil((start + C) / bs)`` are read, int8 pages dequantized; keys at
    positions ``<= qpos`` count.  Two passes as in the reference: the row
    max over the used window, then the exp-sum and the weighted sum, here
    over all used pages at once instead of page by page (the same values
    up to fp32 summation order).  Padding rows come out as garbage the
    caller never reads."""
    _, C, H, D = q.shape
    bs, Hkv = key_cache.shape[1], key_cache.shape[2]
    W = block_table_row.shape[1]
    rep = H // Hkv
    n_used = min(-(-(int(start) + C) // bs), W)
    pages = block_table_row[0, :n_used].to(torch.long).clamp_min(0)

    def gather(cache, cache_scale):
        page = cache[pages]                               # [n, bs, Hkv, D]
        page = (dequant_pages(page, cache_scale[pages])
                if cache_scale is not None else page.to(torch.float32))
        page = page.reshape(n_used * bs, Hkv, D)
        return page.repeat_interleave(rep, dim=1) if rep != 1 else page

    qf = q[0].to(torch.float32) * scale                   # [C, H, D]
    qpos = int(start) + torch.arange(C, device=q.device)
    cols = torch.arange(n_used * bs, device=q.device)
    s = torch.einsum("qhd,khd->hqk", qf, gather(key_cache, key_scale))
    s = s.masked_fill(~(cols[None, None, :] <= qpos[None, :, None]),
                      float("-inf"))
    m = s.amax(dim=-1, keepdim=True)                      # [H, C, 1]
    p = torch.exp(s - m)                                  # -inf keys -> 0
    l = p.sum(dim=-1)                                     # [H, C]
    acc = torch.einsum("hqk,khd->qhd", p, gather(value_cache, value_scale))
    out = acc / l.clamp_min(1e-30).t()[:, :, None]
    return out[None].to(q.dtype)


def _ragged_attention_plain(q, key_cache, value_cache, block_tables,
                            q_offsets, q_lens, kv_lens, scale: float):
    """The plain PyTorch version of the kernel (same math as the
    reference's ``_ragged_attention_xla``): token ``t`` of span ``s`` sits
    at global position ``kv_lens[s] - q_lens[s] + (t - q_offsets[s])`` and
    attends keys at positions <= that with an fp32 masked softmax.  Only
    each span's used pages ``bt[s, :ceil(kv_len/bs)]`` are gathered, and
    padding rows are 0.  Loops over spans on the host."""
    T, H, D = q.shape
    Hkv, bs = key_cache.shape[2], key_cache.shape[1]
    W = block_tables.shape[1]
    rep = H // Hkv
    out = torch.zeros_like(q)
    bt = block_tables.cpu().tolist()
    for s, (off, ql, kvl) in enumerate(zip(q_offsets.tolist(),
                                           q_lens.tolist(),
                                           kv_lens.tolist())):
        if ql <= 0:
            continue
        n_pages = min(-(-kvl // bs), W)
        pages = torch.tensor(bt[s][:n_pages], dtype=torch.long,
                             device=q.device)
        k = key_cache[pages].reshape(n_pages * bs, Hkv, D).float()
        v = value_cache[pages].reshape(n_pages * bs, Hkv, D).float()
        if rep != 1:
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        qs = q[off:off + ql].float() * scale                  # [ql, H, D]
        sc = torch.einsum("qhd,khd->hqk", qs, k)
        qpos = kvl - ql + torch.arange(ql, device=q.device)
        cols = torch.arange(n_pages * bs, device=q.device)
        ok = (cols[None, :] <= qpos[:, None]) & (cols[None, :] < kvl)
        sc = sc.masked_fill(~ok[None], float("-inf"))
        p = torch.softmax(sc, dim=-1)
        # masked keys have p == 0, but a poisoned (non-finite) slot in a
        # used page past kv_len must not leak through 0 * NaN
        v = v.masked_fill(~(cols < kvl)[:, None, None], 0.0)
        out[off:off + ql] = torch.einsum("hqk,khd->qhd", p, v).to(q.dtype)
    return out


# How far apart another fp32 order of the same int8 computation may put a
# probability before it is coded: a relative 1e-5 of x = p / p_scale * 127
# (the exp's and the division's few ulps, and the rounding of s - m for
# |s - m| < 64).  Only codes whose x lies that close to a .5 boundary can
# round the other way in a kernel.
P_CODE_REL_WINDOW = 1e-5


def _ragged_attention_int8_plain(q, key_cache, value_cache, key_scale,
                                 value_scale, block_tables, q_offsets,
                                 q_lens, kv_lens, scale: float,
                                 flip_bound: bool = False):
    """The plain version of the int8 kernel, in the Pallas int8 kernel's
    order (``pallas_kernels.py:1524-1595``): each q row (one query head of
    one span row, over D) quantized per row; page by page, q.K^T on the
    codes folded with the q row's, the page's k and the softmax scales;
    the online-softmax update with the page's probability rows quantized
    per row, p.V on the codes folded with the p row's and the page's v
    scales.  Products of int8 codes summed over D (or over a page of
    keys) stay below 127^2 * 1040 < 2^24 while both are at most 1040, so
    an fp32 matmul of the codes is exact: it stands in for the int32
    product (TF32 must be off on the card).  Rows outside every span are
    0.  Loops over spans and pages on the host.

    ``flip_bound=True`` returns ``(out, flips)``, ``flips`` [T, H, D] fp32:
    per output element, how far the probability codes within
    ``P_CODE_REL_WINDOW`` of a .5 boundary move it if each rounds the
    other way (one code step of key t moves acc by p_scale / 127 * |v_t|,
    rescaled and divided by l like the rest).  ``out`` is the same bit for
    bit."""
    T, H, D = q.shape
    bs, Hkv = key_cache.shape[1], key_cache.shape[2]
    W = block_tables.shape[1]
    g = H // Hkv
    out = torch.zeros_like(q)
    flips = torch.zeros(q.shape, device=q.device) if flip_bound else None
    width = 2 * D if flip_bound else D      # acc carries the flips too
    bt = block_tables.cpu().tolist()
    ninf = float("-inf")
    for s, (off, ql, kvl) in enumerate(zip(q_offsets.tolist(),
                                           q_lens.tolist(),
                                           kv_lens.tolist())):
        if ql <= 0:
            continue
        R = ql * g
        # [ql, H, D] -> [Hkv, ql * groups, D]: one row per query vector
        rows = (q[off:off + ql].reshape(ql, Hkv, g, D).permute(1, 0, 2, 3)
                .reshape(Hkv, R, D))
        q_codes, q_s = quantize_rows_symmetric(rows)
        qc = q_codes.to(torch.float32)
        qpos = (kvl - ql + torch.arange(ql, device=q.device)
                ).repeat_interleave(g)[None, :, None]     # [1, R, 1]
        m = torch.full((Hkv, R, 1), ninf, device=q.device)
        l = torch.zeros((Hkv, R, 1), device=q.device)
        acc = torch.zeros((Hkv, R, width), device=q.device)
        for p_idx in range(min(-(-kvl // bs), W)):
            page = bt[s][p_idx]
            kp = key_cache[page].permute(1, 0, 2).to(torch.float32)
            vp = value_cache[page].permute(1, 0, 2).to(torch.float32)
            sk = key_scale[page][:, None, None]            # [Hkv, 1, 1]
            sv = value_scale[page][:, None, None]
            sc = fold_int8_scores(qc @ kp.transpose(1, 2), q_s, sk, scale)
            cols = p_idx * bs + torch.arange(bs, device=q.device)
            ok = (cols <= qpos) & (cols < kvl)             # [1, R, bs]
            sc = torch.where(ok, sc, torch.full((), ninf, device=q.device))

            def pv_of_p(p, vp=vp, sv=sv):
                p_codes, p_s = quantize_rows_symmetric(p)
                pv = fold_int8_scores(p_codes.to(torch.float32) @ vp, p_s,
                                      sv)
                if not flip_bound:
                    return pv
                x = p / p_s * 127.0
                edge = ((x - x.floor() - 0.5).abs()
                        <= P_CODE_REL_WINDOW * x).to(torch.float32)
                return torch.cat(
                    [pv, fold_int8_scores(edge @ vp.abs(), p_s, sv)], -1)

            m, l, acc = online_softmax_update((m, l, acc), sc, ok, pv_of_p)
        o = acc / l.clamp_min(1e-30)                       # [Hkv, R, width]

        def rows_of(o):
            return (o.reshape(Hkv, ql, g, D).permute(1, 0, 2, 3)
                    .reshape(ql, H, D))
        out[off:off + ql] = rows_of(o[..., :D]).to(q.dtype)
        if flip_bound:
            flips[off:off + ql] = rows_of(o[..., D:])
    return (out, flips) if flip_bound else out


def kernel_head_dim(D: int) -> int:
    """The width the fast paged kernels are built at for head dim ``D``
    (``csrc/common.cuh::paged_width``): the least of 32, 64, 96 and 128
    that is at least ``D`` and of which ``D`` is a whole number of 32nds,
    so that a lane's columns lie all below ``D`` or all past it (D 80 is
    built at 128).  The kernels read the pools' rows at their real width;
    the columns past it change no score and no output column the wrapper
    returns (nor, for int8 pools, any absmax or code).  0 for every other
    ``D >= 1`` (not a multiple of 8, or over 128): the generic kernel
    takes it at its own width, as the reference's kernels take any head
    dim.  Raises ``ValueError`` naming ``D`` below 1."""
    if D < 1:
        raise ValueError("head_dim %d: the paged kernels need a head dim "
                         ">= 1" % D)
    if D % 8 or D > 128:
        return 0
    return next(w for w in _KERNEL_WIDTHS if w >= D and D % (w // 32) == 0)


def ragged_generic(head_dim: int, groups: int, quantized: bool,
                   block_size: int) -> bool:
    """Whether :func:`ragged_paged_attention` runs the generic kernel on
    the card: a head dim without a fast width (:func:`kernel_head_dim`),
    more than 32 query heads a kv head, or int8 pools of block size over
    64 (the CUDA-core kernel's tiles hold 32 query vectors and whole
    pages of at most 64 keys)."""
    return (kernel_head_dim(head_dim) == 0 or groups > 32
            or (quantized and block_size > 64))


def _check_head_dim(name: str, D: int) -> None:
    """Raise ``ValueError`` naming ``D`` for a head dim no kernel (and no
    plain version) takes: below 1."""
    try:
        kernel_head_dim(D)
    except ValueError as e:
        raise ValueError("%s: %s" % (name, e)) from None


def _check_paged_operands(name, q, key_cache, value_cache, key_scale,
                          value_scale, tables):
    """Raise ``ValueError`` for what the attention kernels do not take:
    shapes, dtypes, int32 tables, devices, contiguity.
    ``tables`` maps names to the int32 operands and their wanted leading
    size (or None)."""
    D = q.shape[-1]
    H = q.shape[-2]
    phys, bs, Hkv, Dk = key_cache.shape
    if Hkv <= 0 or H % Hkv:
        raise ValueError("%s: %d query heads must group over %d kv heads"
                         % (name, H, Hkv))
    if Dk != D or value_cache.shape != key_cache.shape:
        raise ValueError("%s: q %s vs pools %s / %s"
                         % (name, tuple(q.shape), tuple(key_cache.shape),
                            tuple(value_cache.shape)))
    quantized = key_scale is not None
    pool_ok = (key_cache.dtype == value_cache.dtype
               == (torch.int8 if quantized else q.dtype))
    if q.dtype not in _DTYPE_CODE or not pool_ok:
        raise ValueError("%s: q must be float32/bfloat16 with pools of its "
                         "dtype (or int8 pools with key_scale/value_scale); "
                         "got %s %s %s" % (name, q.dtype, key_cache.dtype,
                                           value_cache.dtype))
    operands = [("q", q), ("key_cache", key_cache),
                ("value_cache", value_cache)]
    if quantized:
        for sname, t in (("key_scale", key_scale),
                         ("value_scale", value_scale)):
            if (t is None or t.dtype != torch.float32
                    or tuple(t.shape) != (phys, Hkv)):
                raise ValueError("%s: %s must be float32 [%d, %d]"
                                 % (name, sname, phys, Hkv))
            operands.append((sname, t))
    for tname, (t, lead) in tables.items():
        if t.dtype != torch.int32:
            raise ValueError("%s: %s must be int32" % (name, tname))
        if lead is not None and t.dim() == 1 and tuple(t.shape) != (lead,):
            raise ValueError("%s: %s shape %s, want (%d,)"
                             % (name, tname, tuple(t.shape), lead))
        operands.append((tname, t))
    for tname, t in operands:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("%s: %s must be a contiguous tensor on %s"
                             % (name, tname, q.device))


@functools.lru_cache(maxsize=None)
def _int8_folds(scale: float):
    """The fp32 constants the int8 kernels fold with: the score fold
    ``float32(scale / 127^2)`` and the p.V fold ``float32(1 / 127^2)``,
    as ``fold_int8_scores`` computes its ``c``."""
    return (float(np.float32(scale / (127 * 127))),
            float(np.float32(1.0 / (127 * 127))))


def _ragged_entry():
    fn = _build.load("ragged_paged_attention").ptt_ragged_paged_attention
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 13 + [I] * 10 + [F, F, F, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _ragged_generic_entry():
    fn = _build.load(
        "ragged_paged_attention").ptt_ragged_paged_attention_generic
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 10 + [I] * 9 + [F, F, F, I, I, P]
        fn.restype = ctypes.c_int
    return fn


# the tensor-core ragged kernel's work items (csrc/ragged_paged_attention.cu)
RAGGED_TILE_Q = 128          # query vectors (rows x groups) per chunk item
RAGGED_DECODE = 0x8000       # an item's low half: a decode item ...
RAGGED_SPLIT_SHIFT = 7       # ... of (bits 7-14) + 1 splits, (bits 0-6) its own
_DECODE_MAX_GROUPS = 8       # decode items: query heads per kv head
_DECODE_MAX_BLOCK = 32       # decode items: keys per page (one per lane)
_DECODE_MAX_SPLITS = 64
_DECODE_MIN_SPLIT_PAGES = 8  # a split gives each of its 8 warps a page
# blocks the decode items should fill once spans are split: two on each
# of the H100's 132 SMs; spans are split only while fewer than half of
# that are launched
_DECODE_TARGET_BLOCKS = 264


def ragged_tensor_cores(dtype: torch.dtype, quantized: bool,
                        block_size: int, head_dim: int,
                        groups: int = 1) -> bool:
    """Whether :func:`ragged_paged_attention` runs the tensor-core kernel
    on the card for q of ``dtype``: bf16 q over bf16 pools, or over int8
    pools whose block size is a multiple of 8 dividing 64 (a page then
    covers whole 8-key tiles of the s8 products) and whose head dim is a
    multiple of 16 (rows of whole 16-byte pieces); never for a shape the
    generic kernel takes (:func:`ragged_generic`)."""
    if ragged_generic(head_dim, groups, quantized, block_size):
        return False
    return dtype == torch.bfloat16 and (
        not quantized or (block_size % 8 == 0 and 64 % block_size == 0
                          and head_dim % 16 == 0))


def ragged_work(q_lens, kv_lens, heads: int, kv_heads: int,
                block_size: int) -> np.ndarray:
    """The tensor-core kernel's work list for one step, built on the host
    from the spans' ``q_lens`` and ``kv_lens`` (host arrays): int32 items
    ``span << 16 | code``, chunk items first (the longest work starts
    first), one per ``RAGGED_TILE_Q`` query vectors of a span (code =
    the tile), then the decode spans (``q_len`` 1; code ``RAGGED_DECODE |
    (n - 1) << RAGGED_SPLIT_SHIFT | i``, split ``i`` of ``n``), whose keys
    the block's warps share.  While the step's blocks would not give each
    SM one (fewer than 132), a long decode span is split over up to
    ``ceil(264 / (decode spans x kv heads))`` blocks of at least 8 pages
    each, merged in split order by the last of them.  Padding spans
    (``q_len`` 0) get none, so no block is launched to return at once.
    The step passes it to every layer's call."""
    groups = heads // kv_heads
    decode = (groups <= _DECODE_MAX_GROUPS
              and block_size <= _DECODE_MAX_BLOCK)
    q_lens = np.asarray(q_lens).tolist()
    kv_lens = np.asarray(kv_lens).tolist()
    chunk, dec = [], []
    for s, ql in enumerate(q_lens):
        if ql == 1 and decode:
            dec.append(s)
        elif ql > 0:
            chunk += [s << 16 | t
                      for t in range(-(-ql * groups // RAGGED_TILE_Q))]
    splits = 1
    if dec and ((len(chunk) + len(dec)) * kv_heads
                < _DECODE_TARGET_BLOCKS // 2):
        splits = min(_DECODE_MAX_SPLITS,
                     -(-_DECODE_TARGET_BLOCKS // (len(dec) * kv_heads)))
    items = chunk
    for s in dec:
        pages = -(-kv_lens[s] // block_size)
        n = max(1, min(splits, pages // _DECODE_MIN_SPLIT_PAGES))
        items += [s << 16 | RAGGED_DECODE | (n - 1) << RAGGED_SPLIT_SHIFT | i
                  for i in range(n)]
    return np.asarray(items, np.int32)


# per (device, stream), grown on demand and reused by the calls on that
# stream, which run one after another: the split decode items' partial
# states (written before they are read in a call) and their arrival
# counters (zeroed once, reset by the block that merges, so a call leaves
# them zero for the next).  Calls on another stream get their own, so
# concurrent calls never share a counter.  A kernel that stops part-way
# can leave a counter nonzero only through a device fault, which leaves
# the CUDA context unusable for any later call.
_SPLIT_SCRATCH = {}


def _split_scratch(device, stream: int, n_partials: int, n_counters: int):
    """``(partials, counters)`` of ``stream`` (a ``cuda_stream`` handle):
    fp32 and int32 device buffers of at least these sizes."""
    key = (device, stream)
    bufs = _SPLIT_SCRATCH.get(key)
    if bufs is None or bufs[0].numel() < n_partials \
            or bufs[1].numel() < n_counters:
        bufs = _SPLIT_SCRATCH[key] = (
            torch.empty(max(n_partials, 1 << 20), dtype=torch.float32,
                        device=device),
            torch.zeros(max(n_counters, 1 << 12), dtype=torch.int32,
                        device=device))
    return bufs


def _count(wrapper, quantized: bool, generic: bool = False) -> None:
    """One launch of ``wrapper``'s kernel: ``.int8_launches`` for int8
    pools, ``.launches`` otherwise (fast or generic kernel alike); a
    generic kernel's launch is also counted apart, in
    ``.generic_int8_launches`` or ``.generic_launches``."""
    if quantized:
        wrapper.int8_launches += 1
        wrapper.generic_int8_launches += int(generic)
    else:
        wrapper.launches += 1
        wrapper.generic_launches += int(generic)


def ragged_paged_attention(q: torch.Tensor, key_cache: torch.Tensor,
                           value_cache: torch.Tensor,
                           block_tables: torch.Tensor,
                           q_offsets: torch.Tensor, q_lens: torch.Tensor,
                           kv_lens: torch.Tensor, scale=None,
                           span_q: int = 0, key_scale=None,
                           value_scale=None, work=None) -> torch.Tensor:
    """Ragged paged attention over packed spans: ``q`` [T, H, D], pools
    [phys, bs, Hkv, D], ``block_tables`` [S, W] int32, ``q_offsets`` /
    ``q_lens`` / ``kv_lens`` [S] int32.  ``span_q`` bounds every q_len
    (the step's static chunk size; the CUDA-core kernel tiles rows up to
    it).  ``key_scale``/``value_scale`` [phys, Hkv] fp32 select the int8
    variant over int8 pools.  ``work``: :func:`ragged_work` of these
    spans on q's device, required by the tensor-core kernel
    (:func:`ragged_tensor_cores`; the step builds it on the host, so the
    call never waits for the device) and unused otherwise.  Returns
    [T, H, D] in q's dtype; rows outside every span are 0.

    CPU tensors take the plain version; CUDA tensors launch a kernel or
    raise: the generic kernel for the shapes :func:`ragged_generic` names,
    else the tensor-core or the CUDA-core kernel.  ``.launches`` counts
    the fp32/bf16-pool kernels, ``.int8_launches`` the int8 ones."""
    T, H, D = q.shape
    _check_head_dim("ragged_paged_attention", D)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    quantized = key_scale is not None
    if q.device.type == "cpu":
        if quantized:
            return _ragged_attention_int8_plain(
                q, key_cache, value_cache, key_scale, value_scale,
                block_tables, q_offsets, q_lens, kv_lens, scale)
        return _ragged_attention_plain(q, key_cache, value_cache,
                                       block_tables, q_offsets, q_lens,
                                       kv_lens, scale)
    if q.device.type != "cuda":
        raise ValueError("ragged_paged_attention: unsupported device %s"
                         % q.device)
    S, W = block_tables.shape
    _check_paged_operands(
        "ragged_paged_attention", q, key_cache, value_cache, key_scale,
        value_scale, {"block_tables": (block_tables, None),
                      "q_offsets": (q_offsets, S), "q_lens": (q_lens, S),
                      "kv_lens": (kv_lens, S)})
    bs, Hkv = key_cache.shape[1], key_cache.shape[2]
    span_q = int(span_q) if span_q else T
    if S == 0 or span_q <= 0:
        raise ValueError("ragged_paged_attention: needs S > 0 spans and "
                         "span_q > 0")
    c_qk, c_pv = _int8_folds(float(scale)) if quantized else (0.0, 0.0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if ragged_generic(D, H // Hkv, quantized, bs):
        out = torch.zeros_like(q)
        code = _ragged_generic_entry()(
            q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
            key_scale.data_ptr() if quantized else None,
            value_scale.data_ptr() if quantized else None,
            block_tables.data_ptr(), q_offsets.data_ptr(),
            q_lens.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), T, S, W,
            H, Hkv, D, bs, key_cache.stride(0), key_cache.stride(1),
            float(scale), c_qk, c_pv, _DTYPE_CODE[q.dtype], int(quantized),
            stream)
        _build.check(code, "ragged_paged_attention (generic)")
        _count(ragged_paged_attention, quantized, generic=True)
        return out
    Dk = kernel_head_dim(D)
    if Dk != D:
        # the kernels are built at Dk: q and the output padded with zero
        # columns (the pools are read at their own width D)
        q = torch.nn.functional.pad(q, (0, Dk - D))
    out = torch.zeros_like(q)
    partials = counters = None
    if ragged_tensor_cores(q.dtype, quantized, bs, D, H // Hkv):
        if work is None:
            raise ValueError("ragged_paged_attention: the tensor-core "
                             "kernel needs work=ragged_work(q_lens, "
                             "kv_lens, ...) of the step's spans")
        if work.dtype != torch.int32 or work.device != q.device \
                or work.dim() != 1 or not work.is_contiguous():
            raise ValueError("ragged_paged_attention: work must be a "
                             "contiguous 1-D int32 tensor on %s" % q.device)
        if work.numel() == 0:
            return out[..., :D].contiguous() if Dk != D else out
        # split decode items' partial softmax states, [item, Hkv, groups,
        # Dk + 2] fp32, and their arrival counters [item, Hkv]
        partials, counters = _split_scratch(
            q.device, stream, work.numel() * H * (Dk + 2),
            work.numel() * Hkv)
    else:
        work = None
    fn = _ragged_entry()
    code = fn(q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
              key_scale.data_ptr() if quantized else None,
              value_scale.data_ptr() if quantized else None,
              block_tables.data_ptr(), q_offsets.data_ptr(),
              q_lens.data_ptr(), kv_lens.data_ptr(),
              None if work is None else work.data_ptr(),
              None if partials is None else partials.data_ptr(),
              None if counters is None else counters.data_ptr(),
              out.data_ptr(), S, W, H, Hkv, D, bs, key_cache.stride(0),
              key_cache.stride(1), span_q,
              0 if work is None else work.numel(), float(scale), c_qk, c_pv,
              _DTYPE_CODE[q.dtype], int(quantized), stream)
    _build.check(code, "ragged_paged_attention")
    _count(ragged_paged_attention, quantized)
    return out[..., :D].contiguous() if Dk != D else out


ragged_paged_attention.launches = 0
ragged_paged_attention.int8_launches = 0
ragged_paged_attention.generic_launches = 0
ragged_paged_attention.generic_int8_launches = 0


def _paged_attention_plain(q, key_cache, value_cache, block_tables,
                           seq_lens, scale: float, key_scale=None,
                           value_scale=None, flip_bound: bool = False):
    """The plain version of the decode kernel (reference:
    ``_paged_attention_xla`` for fp pools, the Pallas int8 path for int8
    pools): slot ``b``'s one query attends the keys at positions below
    ``seq_lens[b]`` of its used pages.  It is the ragged plain version
    over one-token spans (kv_len = seq_len, the query at the last
    position), whose mask is then ``col < seq_len``; a slot with
    seq_len 0 reads nothing and gives 0.  ``flip_bound`` (int8 pools) as
    in ``_ragged_attention_int8_plain``."""
    B = q.shape[0]
    dev = q.device
    spans = (torch.arange(B, dtype=torch.int32, device=dev),
             torch.ones(B, dtype=torch.int32, device=dev), seq_lens)
    if key_scale is not None:
        return _ragged_attention_int8_plain(q, key_cache, value_cache,
                                            key_scale, value_scale,
                                            block_tables, *spans, scale,
                                            flip_bound)
    return _ragged_attention_plain(q, key_cache, value_cache, block_tables,
                                   *spans, scale)


def _decode_entry():
    fn = _build.load("paged_decode_attention").ptt_paged_decode_attention
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 10 + [I] * 8 + [F, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _decode_generic_entry():
    fn = _build.load(
        "paged_decode_attention").ptt_paged_decode_attention_generic
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 8 + [I] * 6 + [F, F, F, I, I, P]
        fn.restype = ctypes.c_int
    return fn


DECODE_MAX_BLOCK = 128
DECODE_HEAD_TILE = 8         # query heads of a group one block takes


def decode_generic(head_dim: int, block_size: int) -> bool:
    """Whether :func:`paged_attention` runs the generic kernel on the
    card: a head dim without a fast width (:func:`kernel_head_dim`) or a
    block size over ``DECODE_MAX_BLOCK`` (the fast kernel's stages)."""
    return (kernel_head_dim(head_dim) == 0
            or block_size > DECODE_MAX_BLOCK)
_SMS = 132                   # the H100's SMs


def decode_splits(slots: int, kv_heads: int, groups: int, width: int):
    """``(n_split, run)``: the decode kernel cuts each slot's block-table
    width ``width`` into ``n_split`` runs of ``run`` pages, one block
    each.  Chosen from the shapes alone (the host never reads the
    lengths): no split while the (slot, kv head, head tile) blocks cover
    the card's 132 SMs; otherwise as many splits as keep the blocks
    within one wave of ~264 (two an SM: a split block costs a few
    microseconds of start and merge, and a second wave costs more), each
    run at least 8 pages, at most 64 runs."""
    blocks = slots * kv_heads * -(-groups // DECODE_HEAD_TILE)
    n = 1
    if blocks < _SMS:
        n = max(1, min(_DECODE_MAX_SPLITS, _DECODE_TARGET_BLOCKS // blocks,
                       width // _DECODE_MIN_SPLIT_PAGES))
    run = -(-width // n)
    return -(-width // run), run


def paged_attention(q: torch.Tensor, key_cache: torch.Tensor,
                    value_cache: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor, scale=None, key_scale=None,
                    value_scale=None) -> torch.Tensor:
    """Decode attention over the paged cache: ``q`` [B, H, D] (one query
    per slot), pools [phys, bs, Hkv, D], ``block_tables`` [B, W] int32,
    ``seq_lens`` [B] int32 = the tokens each query sees (already counting
    its own).  ``key_scale``/``value_scale`` select the int8 variant.
    Returns [B, H, D] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch a kernel or
    raise.  The fast kernel takes any query-head group, head dims that
    are multiples of 8 up to 128 and block sizes up to 128; every other
    shape runs the generic kernel (:func:`decode_generic`).  The fast
    kernel may split each slot's pages over several blocks
    (:func:`decode_splits`), whose states it merges in split order: two
    calls give the same bits, as they do from the generic kernel.
    ``.launches`` counts the fp32/bf16-pool kernel, ``.int8_launches``
    the int8 one."""
    B, H, D = q.shape
    _check_head_dim("paged_attention", D)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    quantized = key_scale is not None
    if q.device.type == "cpu":
        return _paged_attention_plain(q, key_cache, value_cache,
                                      block_tables, seq_lens, scale,
                                      key_scale, value_scale)
    if q.device.type != "cuda":
        raise ValueError("paged_attention: unsupported device %s"
                         % q.device)
    _check_paged_operands(
        "paged_attention", q, key_cache, value_cache, key_scale,
        value_scale, {"block_tables": (block_tables, None),
                      "seq_lens": (seq_lens, B)})
    bs, Hkv = key_cache.shape[1], key_cache.shape[2]
    W = block_tables.shape[1]
    if block_tables.shape[0] != B or B == 0 or W == 0:
        raise ValueError("paged_attention: block_tables %s for %d slots"
                         % (tuple(block_tables.shape), B))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if decode_generic(D, bs):
        out = torch.empty_like(q)
        c_qk, c_pv = _int8_folds(float(scale)) if quantized else (0.0, 0.0)
        code = _decode_generic_entry()(
            q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
            key_scale.data_ptr() if quantized else None,
            value_scale.data_ptr() if quantized else None,
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), B,
            W, H, Hkv, D, bs, float(scale), c_qk, c_pv,
            _DTYPE_CODE[q.dtype], int(quantized), stream)
        _build.check(code, "paged_attention (generic)")
        _count(paged_attention, quantized, generic=True)
        return out
    n_split, run = decode_splits(B, Hkv, H // Hkv, W)
    out = torch.empty_like(q)
    partials = counters = None
    if n_split > 1:
        # the splits' merged states [blocks, split, 8, D + 2] and their
        # arrival counts, the per-stream scratch #5's split items use
        n_bh = B * Hkv * -(-(H // Hkv) // DECODE_HEAD_TILE)
        partials, counters = _split_scratch(
            q.device, stream,
            n_bh * n_split * DECODE_HEAD_TILE * (kernel_head_dim(D) + 2),
            n_bh)
    fold = _int8_folds(float(scale))[0] if quantized else float(scale)
    fn = _decode_entry()
    code = fn(q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
              key_scale.data_ptr() if quantized else None,
              value_scale.data_ptr() if quantized else None,
              block_tables.data_ptr(), seq_lens.data_ptr(),
              None if partials is None else partials.data_ptr(),
              None if counters is None else counters.data_ptr(),
              out.data_ptr(), B, W, H, Hkv, D, bs, n_split, run, fold,
              _DTYPE_CODE[q.dtype], int(quantized), stream)
    _build.check(code, "paged_attention")
    _count(paged_attention, quantized)
    return out


paged_attention.launches = 0
paged_attention.int8_launches = 0
paged_attention.generic_launches = 0
paged_attention.generic_int8_launches = 0
