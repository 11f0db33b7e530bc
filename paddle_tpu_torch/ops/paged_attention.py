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
  fp32/bf16 pools and, with ``key_scale``/``value_scale``, int8 pools;
- ``csrc/paged_decode_attention.cu`` replaces ``_paged_decode_kernel``
  (launched by ``_paged_attention_pallas``): the split engine's decode
  attention, one query per slot, for the same pool types.

Each source note gives its design: the pools are read in place, in their
own dtype, and only the used pages of each sequence are read.  The int8
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
_HEAD_DIMS = (32, 64, 128)
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
    scales.  Products of int8 codes summed over D <= 128 (or over a page
    of keys) stay below 127^2 * 128 < 2^24, so an fp32 matmul of the codes
    is exact: it stands in for the int32 product (TF32 must be off on the
    card).  Rows outside every span are 0.  Loops over spans and pages on
    the host.

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


def _check_paged_operands(name, q, key_cache, value_cache, key_scale,
                          value_scale, tables, max_groups: int):
    """Raise ``ValueError`` for what the attention kernels do not take:
    shapes, head dims, dtypes, int32 tables, devices, contiguity.
    ``tables`` maps names to the int32 operands and their wanted leading
    size (or None)."""
    D = q.shape[-1]
    H = q.shape[-2]
    phys, bs, Hkv, Dk = key_cache.shape
    if Hkv <= 0 or H % Hkv or H // Hkv > max_groups:
        raise ValueError("%s: %d query heads must group over %d kv heads, "
                         "at most %d per group" % (name, H, Hkv,
                                                   max_groups))
    if Dk != D or value_cache.shape != key_cache.shape:
        raise ValueError("%s: q %s vs pools %s / %s"
                         % (name, tuple(q.shape), tuple(key_cache.shape),
                            tuple(value_cache.shape)))
    if D not in _HEAD_DIMS:
        raise ValueError("%s: head_dim %d not in %s" % (name, D,
                                                         _HEAD_DIMS))
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
        fn.argtypes = [P] * 10 + [I] * 9 + [F, F, F, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def ragged_paged_attention(q: torch.Tensor, key_cache: torch.Tensor,
                           value_cache: torch.Tensor,
                           block_tables: torch.Tensor,
                           q_offsets: torch.Tensor, q_lens: torch.Tensor,
                           kv_lens: torch.Tensor, scale=None,
                           span_q: int = 0, key_scale=None,
                           value_scale=None) -> torch.Tensor:
    """Ragged paged attention over packed spans: ``q`` [T, H, D], pools
    [phys, bs, Hkv, D], ``block_tables`` [S, W] int32, ``q_offsets`` /
    ``q_lens`` / ``kv_lens`` [S] int32.  ``span_q`` bounds every q_len
    (the step's static chunk size; the kernel tiles rows up to it).
    ``key_scale``/``value_scale`` [phys, Hkv] fp32 select the int8
    variant over int8 pools.  Returns [T, H, D] in q's dtype; rows outside
    every span are 0.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  ``.launches`` counts the fp32/bf16-pool kernel,
    ``.int8_launches`` the int8 one."""
    T, H, D = q.shape
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
                      "kv_lens": (kv_lens, S)}, 32)
    bs, Hkv = key_cache.shape[1], key_cache.shape[2]
    span_q = int(span_q) if span_q else T
    if S == 0 or span_q <= 0:
        raise ValueError("ragged_paged_attention: needs S > 0 spans and "
                         "span_q > 0")
    if quantized and bs > 64:
        raise ValueError("ragged_paged_attention: the int8 kernel takes "
                         "block sizes up to 64; got %d" % bs)
    out = torch.zeros_like(q)
    c_qk, c_pv = _int8_folds(float(scale)) if quantized else (0.0, 0.0)
    fn = _ragged_entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
              key_scale.data_ptr() if quantized else None,
              value_scale.data_ptr() if quantized else None,
              block_tables.data_ptr(), q_offsets.data_ptr(),
              q_lens.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
              S, W, H, Hkv, D, bs, key_cache.stride(0), key_cache.stride(1),
              span_q, float(scale), c_qk, c_pv, _DTYPE_CODE[q.dtype],
              int(quantized), stream)
    _build.check(code, "ragged_paged_attention")
    if quantized:
        ragged_paged_attention.int8_launches += 1
    else:
        ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.int8_launches = 0


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
        fn.argtypes = [P] * 8 + [I] * 8 + [F, F, F, I, I, P]
        fn.restype = ctypes.c_int
    return fn


DECODE_MAX_GROUPS = 8
DECODE_MAX_BLOCK = 32


def paged_attention(q: torch.Tensor, key_cache: torch.Tensor,
                    value_cache: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor, scale=None, key_scale=None,
                    value_scale=None) -> torch.Tensor:
    """Decode attention over the paged cache: ``q`` [B, H, D] (one query
    per slot), pools [phys, bs, Hkv, D], ``block_tables`` [B, W] int32,
    ``seq_lens`` [B] int32 = the tokens each query sees (already counting
    its own).  ``key_scale``/``value_scale`` select the int8 variant.
    Returns [B, H, D] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise (it takes query-head groups of 1, 2, 4 or 8 and block sizes up
    to 32).  ``.launches`` counts the fp32/bf16-pool kernel,
    ``.int8_launches`` the int8 one."""
    B, H, D = q.shape
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
                      "seq_lens": (seq_lens, B)}, DECODE_MAX_GROUPS)
    bs, Hkv = key_cache.shape[1], key_cache.shape[2]
    W = block_tables.shape[1]
    if block_tables.shape[0] != B or B == 0 or W == 0:
        raise ValueError("paged_attention: block_tables %s for %d slots"
                         % (tuple(block_tables.shape), B))
    if H // Hkv not in (1, 2, 4, 8) or bs > DECODE_MAX_BLOCK:
        raise ValueError("paged_attention: query-head groups of 1, 2, 4 or "
                         "8 and block sizes up to %d; got %d and %d"
                         % (DECODE_MAX_BLOCK, H // Hkv, bs))
    out = torch.empty_like(q)
    c_qk, c_pv = _int8_folds(float(scale)) if quantized else (0.0, 0.0)
    fn = _decode_entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
              key_scale.data_ptr() if quantized else None,
              value_scale.data_ptr() if quantized else None,
              block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
              B, W, H, Hkv, D, bs, key_cache.stride(0), key_cache.stride(1),
              float(scale), c_qk, c_pv, _DTYPE_CODE[q.dtype],
              int(quantized), stream)
    _build.check(code, "paged_attention")
    if quantized:
        paged_attention.int8_launches += 1
    else:
        paged_attention.launches += 1
    return out


paged_attention.launches = 0
paged_attention.int8_launches = 0
