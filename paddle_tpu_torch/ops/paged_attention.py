"""Paged KV cache and ragged paged attention (counterpart of
``paddle_tpu/ops/paged_attention.py``).

The KV cache is a pool of fixed-size pages ``[phys, block_size, kv_heads,
head_dim]`` per layer on the device; sequences address it through block
tables.  The free list and refcounts are host state (allocation is
control flow, not compute).

Kernel: ``csrc/ragged_paged_attention.cu`` replaces
``_ragged_paged_kernel`` (``paddle_tpu/ops/pallas_kernels.py``, launched
by ``_ragged_paged_attention_pallas``) for fp32/bf16 pools.  Its source
note gives the design; in short: bytes bound for decode spans, fp32
CUDA-core bound for long chunk spans in this first version; one block per
(span, row tile, kv head); the pool is read in place, in its own dtype;
only a span's own rows are stored.
"""
from __future__ import annotations

import ctypes
import math
from typing import List

import torch

from .. import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


class PagedKVCache:
    """One layer's K/V page pools plus the host free list and refcounts
    (reference: ``PagedKVCache``).

    ``sink_block=True`` adds one extra physical page, never in the free
    list, exposed as ``.sink``: the fused step routes the writes of
    padding tokens there, so occupancy changes never corrupt live pages.
    Pages are refcounted; ``free_sequence`` is the single release path.
    """

    def __init__(self, num_blocks: int, block_size: int, num_kv_heads: int,
                 head_dim: int, dtype: torch.dtype = torch.float32,
                 sink_block: bool = False, device=None):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.sink = num_blocks if sink_block else -1
        phys = num_blocks + (1 if sink_block else 0)
        shape = (phys, block_size, num_kv_heads, head_dim)
        self.key_cache = torch.zeros(shape, dtype=dtype, device=device)
        self.value_cache = torch.zeros(shape, dtype=dtype, device=device)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref: dict = {}            # block id -> live reference count

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


def _entry():
    fn = _build.load("ragged_paged_attention").ptt_ragged_paged_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P] + [I] * 9 + [
            ctypes.c_float, I, P]
        fn.restype = ctypes.c_int
    return fn


def ragged_paged_attention(q: torch.Tensor, key_cache: torch.Tensor,
                           value_cache: torch.Tensor,
                           block_tables: torch.Tensor,
                           q_offsets: torch.Tensor, q_lens: torch.Tensor,
                           kv_lens: torch.Tensor, scale=None,
                           span_q: int = 0) -> torch.Tensor:
    """Ragged paged attention over packed spans: ``q`` [T, H, D], pools
    [phys, bs, Hkv, D], ``block_tables`` [S, W] int32, ``q_offsets`` /
    ``q_lens`` / ``kv_lens`` [S] int32.  ``span_q`` bounds every q_len
    (the step's static chunk size; the kernel tiles rows up to it).
    Returns [T, H, D] in q's dtype; rows outside every span are 0.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    T, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return _ragged_attention_plain(q, key_cache, value_cache,
                                       block_tables, q_offsets, q_lens,
                                       kv_lens, scale)
    if q.device.type != "cuda":
        raise ValueError("ragged_paged_attention: unsupported device %s"
                         % q.device)
    phys, bs, Hkv, Dk = key_cache.shape
    S, W = block_tables.shape
    if Hkv <= 0 or H % Hkv or H // Hkv > 32:
        raise ValueError("ragged_paged_attention: %d query heads must group "
                         "over %d kv heads, at most 32 per group" % (H, Hkv))
    if Dk != D or value_cache.shape != key_cache.shape:
        raise ValueError("ragged_paged_attention: q %s vs pools %s / %s"
                         % (tuple(q.shape), tuple(key_cache.shape),
                            tuple(value_cache.shape)))
    if D not in _HEAD_DIMS:
        raise ValueError("ragged_paged_attention: head_dim %d not in %s"
                         % (D, _HEAD_DIMS))
    if q.dtype not in _DTYPE_CODE or key_cache.dtype != q.dtype \
            or value_cache.dtype != q.dtype:
        raise ValueError("ragged_paged_attention: q and pools must share "
                         "one dtype of float32/bfloat16; got %s %s %s"
                         % (q.dtype, key_cache.dtype, value_cache.dtype))
    for name, t in (("block_tables", block_tables),
                    ("q_offsets", q_offsets), ("q_lens", q_lens),
                    ("kv_lens", kv_lens)):
        if t.dtype != torch.int32:
            raise ValueError("ragged_paged_attention: %s must be int32"
                             % name)
        if name != "block_tables" and tuple(t.shape) != (S,):
            raise ValueError("ragged_paged_attention: %s shape %s, want "
                             "(%d,)" % (name, tuple(t.shape), S))
    for name, t in (("q", q), ("key_cache", key_cache),
                    ("value_cache", value_cache),
                    ("block_tables", block_tables), ("q_offsets", q_offsets),
                    ("q_lens", q_lens), ("kv_lens", kv_lens)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("ragged_paged_attention: %s must be a "
                             "contiguous tensor on %s" % (name, q.device))
    span_q = int(span_q) if span_q else T
    if S == 0 or span_q <= 0:
        raise ValueError("ragged_paged_attention: needs S > 0 spans and "
                         "span_q > 0")
    out = torch.zeros_like(q)
    page_stride, slot_stride = key_cache.stride(0), key_cache.stride(1)
    fn = _entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
              block_tables.data_ptr(), q_offsets.data_ptr(),
              q_lens.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
              S, W, H, Hkv, D, bs, page_stride, slot_stride, span_q,
              float(scale), _DTYPE_CODE[q.dtype], stream)
    _build.check(code, "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
