"""Flash attention with fused neox rope, forward and backward (counterpart
of the flash section of ``paddle_tpu/ops/pallas_kernels.py``).

Kernels, all in ``csrc/flash_attention.cu`` (one library):

- ``flash_fwd`` replaces ``_flash_fwd_kernel`` (launched by
  ``_flash_attention_value``): online-softmax forward, optional neox rope
  on the q/k tiles, natural-log lse (``-inf`` for rows that see nothing).
- ``flash_bwd_fused`` replaces ``_flash_bwd_kv_kernel(emit_dq=True)``
  (launched by ``_flash_attention_bwd_fused``): one pass over the k tiles
  writes dk/dv and adds each tile's dq share into an fp32 workspace with
  atomics, then a small pass applies the inverse rope and the cast.  The
  order of those additions differs from run to run, so dq is not
  bitwise deterministic (dk and dv are).
- ``flash_bwd_two_kernel`` replaces ``_flash_bwd_dq_kernel`` +
  ``_flash_bwd_kv_kernel`` (launched by ``_flash_attention_bwd``): a dq
  kernel per q tile and a dk/dv kernel per k tile, no atomics, so the
  result is deterministic.

The layout of every tensor here is the public one, ``[B, S, H, D]``
(contiguous), with the lse ``[B, H, Sq]`` fp32; the kernels read the
heads in place, so nothing is transposed.  Causal masking is bottom-right
aligned: query row ``i`` sees key ``j`` iff ``j <= i + Sk - Sq``.

Rounding points (shared by the kernels and their plain versions, and
taken from the Pallas kernels): scores live in exp2 space, the roped q
is scaled by ``scale*log2(e)`` and cast to q's dtype, the roped k is cast
to k's dtype, p is cast to v's dtype before ``p @ v`` (and to dO's before
``p^T @ dO``), ds is cast to k's dtype; everything else is fp32.  In fp32
the casts are no-ops; in bf16 they make kernel and plain comparable.

Each wrapper takes the plain version for CPU tensors and counts nothing;
for CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_LANES = 128
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
# fused-backward routing (reference: _flash_bwd_auto): the fused form
# holds per-k-tile dq shares, so it is taken only for short key axes
_FUSED_BWD_MAX_SK = 8192
# bytes the plain versions may hold in score-sized temporaries at once
_PLAIN_CHUNK_BYTES = 2 << 30
# key block of the chunked fallback (the reference's default)
_CHUNK_K = 256

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _fit_block(want: int, total: int) -> int:
    """The reference's block arithmetic (``_fit_block``): the largest
    block ``<= want`` dividing ``total`` that is a multiple of 128, or at
    most 128 and (the whole axis or a multiple of 16); 0 if none.  The
    port uses it only to take the reference's routing decisions on the
    same shapes; the CUDA kernels tile on their own."""
    b = min(want, total)
    if total % b == 0 and (b % _LANES == 0
                           or (b <= _LANES and (b == total or b % 16 == 0))):
        return b
    for c in range((b // _LANES) * _LANES, 0, -_LANES):
        if total % c == 0:
            return c
    for c in range((min(b, _LANES) // 16) * 16, 0, -16):
        if total % c == 0:
            return c
    return 0


def rope_tables(seq_len: int, dim: int, base: float = 10000.0,
                position_offset: int = 0, device=None):
    """Neox cos/sin tables ``[seq_len, dim]`` fp32 (reference:
    ``rope_tables``; same expression, the library cos/sin may differ
    from XLA's by one ulp)."""
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=device) / dim))
    pos = torch.arange(position_offset, position_offset + seq_len,
                       dtype=torch.float32, device=device)
    freqs = pos[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
          neg_sin: bool = False) -> torch.Tensor:
    """Neox rotation of ``t`` [B, S, H, D] (already in the compute dtype)
    by ``cos``/``sin`` [S, D]: ``t*cos + rot*sin`` with ``rot = cat(-t[D/2:],
    t[:D/2])``; ``neg_sin`` gives the inverse rotation (the rope VJP).
    The reference's ``_rope_tile`` op for op."""
    half = t.shape[-1] // 2
    rot = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
    c = cos.to(t.dtype)[None, :, None, :]
    s = sin.to(t.dtype)[None, :, None, :]
    return t * c - rot * s if neg_sin else t * c + rot * s


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 math for fp32/bf16 inputs (as the kernels); fp64 stays fp64
    so that ``gradcheck`` can run the plain versions."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _rounded_operands(q, k, rope: Rope):
    """``(qs, kr, qr)`` in the compute dtype: the exp2-space q (roped,
    times ``scale*log2e``, cast to q's dtype), the roped k cast to k's
    dtype, and the roped q cast to q's dtype (the dk operand)."""
    acc = _acc_dtype(q.dtype)
    c = (1.0 / math.sqrt(q.shape[-1])) * _LOG2E
    qf, kf = q.to(acc), k.to(acc)
    if rope is not None:
        qf, kf = _rope(qf, *rope), _rope(kf, *rope)
    qs = (qf * c).to(q.dtype).to(acc)
    return qs, kf.to(k.dtype).to(acc), qf.to(q.dtype).to(acc)


def _head_chunks(B: int, H: int, Sq: int, Sk: int):
    """(b, h0, h1) blocks whose [h1-h0, Sq, Sk] fp32 temporaries (six of
    them in the backward) stay within ``_PLAIN_CHUNK_BYTES``."""
    hc = max(1, min(H, _PLAIN_CHUNK_BYTES // (6 * 4 * Sq * Sk)))
    for b in range(B):
        for h0 in range(0, H, hc):
            yield b, h0, min(H, h0 + hc)


def _visible(Sq: int, Sk: int, causal: bool, device) -> torch.Tensor:
    """[Sq, Sk] bool: query row i sees key j (bottom-right causal)."""
    if not causal:
        return torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    return torch.ones(Sq, Sk, dtype=torch.bool, device=device).tril(Sk - Sq)


def _heads(t: torch.Tensor, b: int, h0: int, h1: int) -> torch.Tensor:
    """[S, h1-h0, D] slice of batch row ``b`` as [h1-h0, S, D]."""
    return t[b, :, h0:h1].transpose(0, 1)


def _flash_fwd_plain(q, k, v, causal: bool, rope: Rope = None,
                     out_dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version of the forward kernel: ``(out, lse)`` with
    out [B, Sq, H, D] in q's dtype (or ``out_dtype``, which skips the
    last rounding) and lse [B, H, Sq] (natural log, ``-inf`` for rows
    that see nothing), full scores per head block."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    acc = _acc_dtype(q.dtype)
    qs, kr, _ = _rounded_operands(q, k, rope)
    vf = v.to(acc)
    vis = _visible(Sq, Sk, causal, q.device)
    out_dtype = out_dtype or q.dtype
    out = torch.empty(B, Sq, H, D, dtype=out_dtype, device=q.device)
    lse = torch.empty(B, H, Sq, dtype=acc, device=q.device)
    for b, h0, h1 in _head_chunks(B, H, Sq, Sk):
        s = _heads(qs, b, h0, h1) @ _heads(kr, b, h0, h1).transpose(1, 2)
        s = s.masked_fill(~vis, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - torch.where(torch.isfinite(m), m, 0.0))
        l = p.sum(dim=-1, keepdim=True)
        pv = p.to(v.dtype).to(acc) @ _heads(vf, b, h0, h1)
        l_inv = torch.where(l > 0, 1.0 / l, 0.0)
        out[b, :, h0:h1] = (pv * l_inv).to(out_dtype).transpose(0, 1)
        lse[b, h0:h1] = torch.where(l > 0, m * _LN2 + torch.log(l),
                                    float("-inf"))[..., 0]
    return out, lse


def _flash_bwd_plain(q, k, v, out, lse, g, causal: bool, rope: Rope = None,
                     out_dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version of both backward forms (they compute the
    same function): ``(dq, dk, dv)`` in the input dtypes (or all in
    ``out_dtype``, which skips the last rounding).  p is
    recomputed from the saved lse, ``delta = rowsum(dO * O)``, and the
    inverse rope is applied to dq and dk."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    acc = _acc_dtype(q.dtype)
    scale = 1.0 / math.sqrt(D)
    qs, kr, qr = _rounded_operands(q, k, rope)
    vf, gf = v.to(acc), g.to(acc)
    delta = (gf * out.to(acc)).sum(dim=-1)                 # [B, Sq, H]
    vis = _visible(Sq, Sk, causal, q.device)
    dq = torch.empty(B, Sq, H, D, dtype=acc, device=q.device)
    dk = torch.empty(B, Sk, H, D, dtype=acc, device=q.device)
    dv = torch.empty(B, Sk, H, D, dtype=acc, device=q.device)
    for b, h0, h1 in _head_chunks(B, H, Sq, Sk):
        g_h = _heads(gf, b, h0, h1)
        k_h = _heads(kr, b, h0, h1)
        s = _heads(qs, b, h0, h1) @ k_h.transpose(1, 2)
        s = s.masked_fill(~vis, float("-inf"))
        lse2 = (lse[b, h0:h1].to(acc) * _LOG2E)[..., None]
        p = torch.where(torch.isfinite(lse2), torch.exp2(s - lse2), 0.0)
        dp = g_h @ _heads(vf, b, h0, h1).transpose(1, 2)
        dlt = delta[b, :, h0:h1].transpose(0, 1)[..., None]
        ds = (p * (dp - dlt)).to(k.dtype).to(acc)
        dv[b, :, h0:h1] = (p.to(g.dtype).to(acc).transpose(1, 2)
                           @ g_h).transpose(0, 1)
        dq[b, :, h0:h1] = ((ds @ k_h) * scale).transpose(0, 1)
        dk[b, :, h0:h1] = ((ds.transpose(1, 2) @ _heads(qr, b, h0, h1))
                           * scale).transpose(0, 1)
    if rope is not None:
        dq, dk = _rope(dq, *rope, neg_sin=True), _rope(dk, *rope,
                                                       neg_sin=True)
    if out_dtype is not None:
        return dq.to(out_dtype), dk.to(out_dtype), dv.to(out_dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _chunked_sdpa(q, k, v, causal: bool):
    """The reference's memory-bounded fallback (``_chunked_sdpa``, no
    mask): fp32 online softmax over key blocks of ``_CHUNK_K``, in the
    layout [B, S, H, D].  Plain PyTorch, differentiable by autograd; taken
    for head dims over 128 (``_kernel_ok``)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qf = q.to(torch.float32).transpose(1, 2) * (1.0 / math.sqrt(D))
    kf = k.to(torch.float32).transpose(1, 2)
    vf = v.to(torch.float32).transpose(1, 2)
    rows = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, H, Sq), float("-inf"), device=q.device)
    l = torch.zeros(B, H, Sq, device=q.device)
    acc = torch.zeros(B, H, Sq, D, device=q.device)
    for c0 in range(0, Sk, _CHUNK_K):
        c1 = min(Sk, c0 + _CHUNK_K)
        s = qf @ kf[:, :, c0:c1].transpose(-1, -2)
        valid = torch.ones(Sq, c1 - c0, dtype=torch.bool, device=q.device)
        if causal:
            cols = torch.arange(c0, c1, device=q.device)[None, :]
            valid = rows + (Sk - Sq) >= cols
        s = s.masked_fill(~valid, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None]).masked_fill(~valid, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ vf[:, :, c0:c1]
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _rope_cast(t: torch.Tensor, cos, sin) -> torch.Tensor:
    """Graph-level rope on [B, S, H, D] in fp32, cast back (reference:
    ``_rope_xla``; the fallback path's rope)."""
    return _rope(t.to(torch.float32), cos, sin).to(t.dtype)


def _kernel_ok(q: torch.Tensor) -> bool:
    """The head-dim half of the reference's ``_pallas_ok`` (D <= 128):
    beyond it the reference takes ``_chunked_sdpa``, and so does the port.
    The other half (a usable Pallas block on both sequence axes) is not
    taken over: the CUDA kernels mask any sequence length, so such shapes
    run the kernels here where the reference falls back."""
    return q.shape[-1] <= 128


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _entries():
    lib = _build.load("flash_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, bwd = lib.ptt_flash_fwd, lib.ptt_flash_bwd
    if fwd.argtypes is None:
        fwd.argtypes = [P] * 7 + [I] * 7 + [F, I, P]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [P] * 12 + [I] * 7 + [F, F, I, I, P]
        bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(what: str, q, k, v, rope: Rope, more=()):
    """Raise ``ValueError`` on what the kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (what, q.device))
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError("%s: q %s, k %s, v %s must be [B, S, H, D] with "
                         "equal B, H, D" % (what, tuple(q.shape),
                                            tuple(k.shape), tuple(v.shape)))
    if D not in _HEAD_DIMS:
        raise ValueError("%s: head_dim %d not in %s" % (what, D, _HEAD_DIMS))
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("%s: q/k/v must share one dtype of float32/"
                         "bfloat16; got %s %s %s" % (what, q.dtype, k.dtype,
                                                     v.dtype))
    if Sq == 0 or Sk == 0:
        raise ValueError("%s: empty sequence axis" % what)
    tensors = [("q", q), ("k", k), ("v", v)] + list(more)
    if rope is not None:
        if Sq != Sk:
            raise ValueError("%s: in-kernel rope requires Sq == Sk" % what)
        for name, t in zip(("cos", "sin"), rope):
            if t.shape != (Sq, D) or t.dtype != torch.float32:
                raise ValueError("%s: %s must be [S, D] float32" % (what,
                                                                    name))
            tensors.append((name, t))
    for name, t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("%s: %s must be a contiguous tensor on %s"
                             % (what, name, q.device))


def _rope_ptrs(rope: Rope):
    return (None, None) if rope is None else (rope[0].data_ptr(),
                                              rope[1].data_ptr())


def flash_fwd(q, k, v, causal: bool, rope: Rope = None):
    """Flash forward: ``q`` [B, Sq, H, D], ``k``/``v`` [B, Sk, H, D],
    ``rope`` optional ``(cos, sin)`` [S, D] fp32 (needs Sq == Sk).
    Returns ``(out [B, Sq, H, D], lse [B, H, Sq] fp32)``."""
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, causal, rope)
    _check("flash_fwd", q, k, v, rope)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    fwd, _ = _entries()
    cos_p, sin_p = _rope_ptrs(rope)
    code = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos_p, sin_p,
               out.data_ptr(), lse.data_ptr(), B, H, Sq, Sk, D,
               int(causal), int(rope is not None),
               (1.0 / math.sqrt(D)) * _LOG2E, _DTYPE_CODE[q.dtype],
               torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def _flash_bwd(what, fused, q, k, v, out, lse, g, causal, rope):
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    _check(what, q, k, v, rope, more=[("out", out), ("g", g), ("lse", lse)])
    if out.shape != q.shape or g.shape != q.shape or out.dtype != q.dtype \
            or g.dtype != q.dtype:
        raise ValueError("%s: out/g must match q's shape and dtype" % what)
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError("%s: lse must be [B, H, Sq] float32" % what)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # fp32 dq workspace the fused kernel adds into (zeroed here)
    dq_acc = (torch.zeros(B, Sq, H, D, dtype=torch.float32, device=q.device)
              if fused else None)
    _, bwd = _entries()
    cos_p, sin_p = _rope_ptrs(rope)
    code = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               g.data_ptr(), lse.data_ptr(), cos_p, sin_p, dq.data_ptr(),
               dk.data_ptr(), dv.data_ptr(),
               dq_acc.data_ptr() if fused else None, B, H, Sq, Sk, D,
               int(causal), int(rope is not None),
               (1.0 / math.sqrt(D)) * _LOG2E, 1.0 / math.sqrt(D),
               _DTYPE_CODE[q.dtype], int(fused),
               torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, what)
    return dq, dk, dv


def flash_bwd_fused(q, k, v, out, lse, g, causal: bool, rope: Rope = None):
    """One-pass flash backward (dq shares added with fp32 atomics):
    ``(dq, dk, dv)``.  ``out``/``lse`` from :func:`flash_fwd`, ``g`` the
    gradient of ``out``."""
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, out, lse, g, causal, rope)
    res = _flash_bwd("flash_bwd_fused", True, q, k, v, out, lse, g, causal,
                     rope)
    flash_bwd_fused.launches += 1
    return res


def flash_bwd_two_kernel(q, k, v, out, lse, g, causal: bool,
                         rope: Rope = None):
    """Two-kernel (FlashAttention-2) backward, deterministic:
    ``(dq, dk, dv)``; arguments as :func:`flash_bwd_fused`."""
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, out, lse, g, causal, rope)
    res = _flash_bwd("flash_bwd_two_kernel", False, q, k, v, out, lse, g,
                     causal, rope)
    flash_bwd_two_kernel.launches += 1
    return res


flash_fwd.launches = 0
flash_bwd_fused.launches = 0
flash_bwd_two_kernel.launches = 0


def fused_bwd_taken(Sk: int) -> bool:
    """The reference's routing predicate on shapes (``_flash_bwd_auto``):
    the fused form for ``Sk <= 8192`` when the key axis splits into at
    most 4 blocks of ``_fit_block(max(1024, Sk // 4), Sk)``."""
    if Sk > _FUSED_BWD_MAX_SK:
        return False
    bk = _fit_block(max(1024, Sk // 4), Sk)
    return bool(bk) and Sk // bk <= 4


def flash_bwd_auto(q, k, v, out, lse, g, causal: bool, rope: Rope = None):
    """The backward the reference would take for these shapes."""
    if fused_bwd_taken(k.shape[1]):
        return flash_bwd_fused(q, k, v, out, lse, g, causal, rope)
    return flash_bwd_two_kernel(q, k, v, out, lse, g, causal, rope)


class FlashRopeAttention(torch.autograd.Function):
    """Neox rope + flash attention (reference: ``_flash_rope_sdpa``):
    the forward saves q, k, v, out and lse; the backward recomputes p from
    the lse in :func:`flash_bwd_auto` and returns no gradient for the
    tables."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, causal: bool):
        out, lse = flash_fwd(q, k, v, causal, rope=(cos, sin))
        ctx.save_for_backward(q, k, v, cos, sin, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, cos, sin, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_auto(q, k, v, out, lse, g.contiguous(),
                                    ctx.causal, rope=(cos, sin))
        return dq, dk, dv, None, None, None


class FlashAttention(torch.autograd.Function):
    """Flash attention without rope (reference: ``_flash_sdpa``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_auto(q, k, v, out, lse, g.contiguous(),
                                    ctx.causal)
        return dq, dk, dv, None


def flash_attention_rope(query, key, value, rotary_base: float = 10000.0,
                         is_causal: bool = True) -> torch.Tensor:
    """Fused neox rope + flash attention, layout [B, S, H, D] (reference:
    ``flash_attention_rope``).  k/v must already be head-repeated for
    GQA.  Head dims over 128 take the reference's ``_chunked_sdpa`` after
    a graph-level rope, as the reference does; on the card every other
    shape launches the kernels or raises."""
    S, D = query.shape[1], query.shape[3]
    if key.shape[1] != S:
        raise ValueError("flash_attention_rope: in-kernel rope requires "
                         "Sq == Sk; got %d and %d" % (S, key.shape[1]))
    cos, sin = rope_tables(S, D, rotary_base, device=query.device)
    if not _kernel_ok(query):
        return _chunked_sdpa(_rope_cast(query, cos, sin),
                             _rope_cast(key, cos, sin), value, is_causal)
    return FlashRopeAttention.apply(query.contiguous(), key.contiguous(),
                                    value.contiguous(), cos, sin, is_causal)


def flash_attention(query, key, value, is_causal: bool = False):
    """Flash attention without rope, layout [B, S, H, D] (reference:
    ``flash_attention_tpu`` without a mask)."""
    if not _kernel_ok(query):
        return _chunked_sdpa(query, key, value, is_causal)
    return FlashAttention.apply(query.contiguous(), key.contiguous(),
                                value.contiguous(), is_causal)
