"""Flash attention with fused neox rope, forward and backward (counterpart
of the flash section of ``paddle_tpu/ops/pallas_kernels.py``).

Kernels, in two libraries: ``csrc/flash_attention_sm90.cu`` (bf16, built
at head dims 64 and 128, on the tensor cores: the forward on ``wgmma``,
both backward forms on ``mma.sync`` tiles fed by ``ldmatrix``, behind a
``cp.async`` ring) and ``csrc/flash_attention.cu`` (fp32, built at head
dims 32, 64, 96 and 128, on the CUDA cores).  The wrappers choose by
dtype.  Every other head dim up to 128 runs the kernels padded
(:func:`kernel_head_dim`, :func:`_pad_to`): bf16 at 64 or 128, fp32 at
the next of 32, 64, 96 and 128, with the true ``1/sqrt(D)`` as the
scale and the outputs cut back to D.  The zero columns change no score.
An even D is padded per half, which keeps the neox rope's pairs (column
i with i + D/2); an odd D has no such pairs, so it takes no rope (the
reference's rope raises on it too) and is padded at its end.  Head dims
over 128 take ``_chunked_sdpa`` at the public entries, as the
reference's do; the kernel wrappers raise on them.

- ``flash_fwd`` replaces ``_flash_fwd_kernel`` (launched by
  ``_flash_attention_value``): online-softmax forward, optional neox rope
  on the q/k tiles, natural-log lse (``-inf`` for rows that see nothing).
- ``flash_bwd_fused`` replaces ``_flash_bwd_kv_kernel(emit_dq=True)``
  (launched by ``_flash_attention_bwd_fused``): one pass over the k tiles
  writes dk/dv and adds each k tile's dq share into an fp32 workspace in
  k-tile order (a counter per q-row block passes the turn; the reference
  sums per-k-block partials in order), then a small pass applies the
  inverse rope and the cast.  dq, dk and dv are bitwise deterministic.
- ``flash_bwd_two_kernel`` replaces ``_flash_bwd_dq_kernel`` +
  ``_flash_bwd_kv_kernel`` (launched by ``_flash_attention_bwd``): a dq
  kernel per q tile and a dk/dv kernel per k tile, no atomics, so the
  result is deterministic.

The layout of every tensor here is the public one, ``[B, S, H, D]``
(contiguous), with the lse ``[B, H, Sq]`` fp32; the kernels read the
heads in place, so nothing is transposed.  Causal masking is bottom-right
aligned: query row ``i`` sees key ``j`` iff ``j <= i + Sk - Sq``.

Rounding points (shared by the kernels and their plain versions, and
taken from the Pallas kernels): scores live in exp2 space with ``c =
scale*log2(e)`` on exactly one operand, multiplied in after the rope and
before the one cast to the input dtype.  The forward and the two-kernel
dq put c on q (``round(rope(q) c) . round(rope(k))``); dk, dv and the
fused dq put it on k (``round(rope(q)) . round(rope(k) c)``), as the
reference's dk/dv kernel folds c into its resident k tile.  p is cast to
v's dtype before ``p @ v`` (and to dO's before ``p^T @ dO``), ds is cast
to k's dtype; everything else is fp32.  In fp32 the casts are no-ops; in
bf16 they make kernel and plain comparable.

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
_HEAD_DIMS = (32, 64, 96, 128)      # fp32 head dims with a kernel
_TC_HEAD_DIMS = (64, 128)           # bf16 ones (the tensor cores)
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


def _rounded_operands(q, k, rope: Rope, scale: Optional[float] = None):
    """``(qs, kr, qr, ks)`` in the compute dtype, each rounded to its
    input's dtype once: the exp2-space q (roped, times ``c =
    scale*log2e``), the roped k, the roped q, and the exp2-space k (roped,
    times c).  Exactly one score operand carries c: the forward and the
    two-kernel dq use ``qs . kr``; dk, dv and the fused dq use
    ``qr . ks`` (the reference's dk/dv kernel folds c into its resident k
    tile).  ``scale`` defaults to ``1/sqrt(D)``."""
    acc = _acc_dtype(q.dtype)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    c = scale * _LOG2E
    qf, kf = q.to(acc), k.to(acc)
    if rope is not None:
        qf, kf = _rope(qf, *rope), _rope(kf, *rope)
    return ((qf * c).to(q.dtype).to(acc), kf.to(k.dtype).to(acc),
            qf.to(q.dtype).to(acc), (kf * c).to(k.dtype).to(acc))


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
                     out_dtype: Optional[torch.dtype] = None,
                     scale: Optional[float] = None):
    """Plain PyTorch version of the forward kernel: ``(out, lse)`` with
    out [B, Sq, H, D] in q's dtype (or ``out_dtype``, which skips the
    last rounding) and lse [B, H, Sq] (natural log, ``-inf`` for rows
    that see nothing), full scores per head block.  ``scale`` defaults to
    ``1/sqrt(D)`` (a padded call passes the true head dim's)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    acc = _acc_dtype(q.dtype)
    qs, kr, _, _ = _rounded_operands(q, k, rope, scale)
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


def _p_ds(a, b, g_h, v_h, lse2, dlt, vis, ds_dtype):
    """p = exp2(a . b^T - lse2) (0 where masked or the row sees nothing)
    and ds = p * (dO . v^T - delta) rounded to ``ds_dtype``, for one head
    block; ``a . b^T`` are exp2-space scores."""
    s = (a @ b.transpose(1, 2)).masked_fill(~vis, float("-inf"))
    p = torch.where(torch.isfinite(lse2), torch.exp2(s - lse2), 0.0)
    dp = g_h @ v_h.transpose(1, 2)
    return p, (p * (dp - dlt)).to(ds_dtype).to(p.dtype)


def _flash_bwd_plain(q, k, v, out, lse, g, causal: bool, rope: Rope = None,
                     *, form: str, out_dtype: Optional[torch.dtype] = None,
                     scale: Optional[float] = None):
    """Plain PyTorch version of the backward form ``form`` (``"fused"``
    or ``"two_kernel"``): ``(dq, dk, dv)`` in the input dtypes (or all in
    ``out_dtype``, which skips the last rounding).  p is recomputed from
    the saved lse, ``delta = rowsum(dO * O)``, and the inverse rope is
    applied to dq and dk.

    The forms compute one function and differ only in where they round
    (the reference's kernels): in both, dk and dv come from the scores
    ``qr . ks`` (c on the k operand), ``dk = ds^T qr * scale`` and
    ``dv = p^T dO`` with p rounded; the fused dq is ``ds ks / log2e``
    from the same scores, the two-kernel dq ``ds kr * scale`` from the
    scores ``qs . kr`` (c on the q operand).  ds is rounded to k's dtype
    in each.  ``scale`` as in :func:`_flash_fwd_plain`."""
    if form not in ("fused", "two_kernel"):
        raise ValueError("form must be 'fused' or 'two_kernel', got %r"
                         % (form,))
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    acc = _acc_dtype(q.dtype)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qs, kr, qr, ks = _rounded_operands(q, k, rope, scale)
    vf, gf = v.to(acc), g.to(acc)
    delta = (gf * out.to(acc)).sum(dim=-1)                 # [B, Sq, H]
    vis = _visible(Sq, Sk, causal, q.device)
    dq = torch.empty(B, Sq, H, D, dtype=acc, device=q.device)
    dk = torch.empty(B, Sk, H, D, dtype=acc, device=q.device)
    dv = torch.empty(B, Sk, H, D, dtype=acc, device=q.device)
    for b, h0, h1 in _head_chunks(B, H, Sq, Sk):
        g_h, v_h = _heads(gf, b, h0, h1), _heads(vf, b, h0, h1)
        qr_h, ks_h = _heads(qr, b, h0, h1), _heads(ks, b, h0, h1)
        lse2 = (lse[b, h0:h1].to(acc) * _LOG2E)[..., None]
        dlt = delta[b, :, h0:h1].transpose(0, 1)[..., None]
        p, ds = _p_ds(qr_h, ks_h, g_h, v_h, lse2, dlt, vis, k.dtype)
        dv[b, :, h0:h1] = (p.to(g.dtype).to(acc).transpose(1, 2)
                           @ g_h).transpose(0, 1)
        dk[b, :, h0:h1] = ((ds.transpose(1, 2) @ qr_h)
                           * scale).transpose(0, 1)
        if form == "fused":
            dq_h = (ds @ ks_h) * (1.0 / _LOG2E)
        else:
            del p, ds
            kr_h = _heads(kr, b, h0, h1)
            _, ds = _p_ds(_heads(qs, b, h0, h1), kr_h, g_h, v_h, lse2, dlt,
                          vis, k.dtype)
            dq_h = (ds @ kr_h) * scale
        dq[b, :, h0:h1] = dq_h.transpose(0, 1)
    if rope is not None:
        dq, dk = _rope(dq, *rope, neg_sin=True), _rope(dk, *rope,
                                                       neg_sin=True)
    if out_dtype is not None:
        return dq.to(out_dtype), dk.to(out_dtype), dv.to(out_dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _chunked_sdpa(q, k, v, causal: bool, mask=None):
    """The reference's memory-bounded fallback (``_chunked_sdpa``): fp32
    online softmax over key blocks of ``_CHUNK_K``, in the layout [B, S,
    H, D].  ``mask`` (broadcastable to [B, H, Sq, Sk]) is the reference's
    too: a bool mask keeps the keys it marks, a float one is added to the
    scaled scores.  Plain PyTorch, differentiable by autograd; taken for
    head dims over 128 (``_kernel_ok``) and for the API's masked
    attention."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qf = q.to(torch.float32).transpose(1, 2) * (1.0 / math.sqrt(D))
    kf = k.to(torch.float32).transpose(1, 2)
    vf = v.to(torch.float32).transpose(1, 2)
    if mask is not None and mask.dtype != torch.bool:
        mask = mask.to(torch.float32)
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
        if mask is not None:
            mb = mask[..., c0:c1]
            if mb.dtype == torch.bool:
                valid = valid & mb
            else:
                s = s + mb
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
    """The CUDA-core library's entries, fp32: the forward and the
    backward (both forms)."""
    lib = _build.load("flash_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, bwd = lib.ptt_flash_fwd, lib.ptt_flash_bwd
    if fwd.argtypes is None:
        fwd.argtypes = [P] * 7 + [I] * 7 + [F, I, P]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [P] * 13 + [I] * 7 + [F, F, I, I, P]
        bwd.restype = ctypes.c_int
    return fwd, bwd


def _tc_entries():
    """The tensor-core library's entries, bf16 at head dims 64 and 128:
    the forward, the two-kernel backward and the one-pass backward."""
    lib = _build.load("flash_attention_sm90")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, bwd = lib.ptt_flash_fwd_tc, lib.ptt_flash_bwd_two_kernel_tc
    fused = lib.ptt_flash_bwd_fused_tc
    if fwd.argtypes is None:
        fwd.argtypes = [P] * 8 + [I] * 7 + [F, P]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [P] * 15 + [I] * 7 + [F, F, P]
        bwd.restype = ctypes.c_int
        fused.argtypes = [P] * 16 + [I] * 7 + [F, F, P]
        fused.restype = ctypes.c_int
    return fwd, bwd, fused


def kernel_head_dim(D: int, dtype: torch.dtype) -> int:
    """The head dim the kernels run a call of head dim ``D`` at, which
    the wrapper pads it to: for every ``D`` up to 128, the next of 64 and
    128 in bf16 (the tensor cores), of 32, 64, 96 and 128 in fp32.  0 for
    ``D`` over 128: no kernel, the public entries take ``_chunked_sdpa``
    there (the reference's kernels stop at 128 too).  Raises
    ``ValueError`` naming ``D`` below 1."""
    if D < 1:
        raise ValueError("head_dim %d: the flash kernels need a head dim "
                         ">= 1" % D)
    if D > 128:
        return 0
    widths = _TC_HEAD_DIMS if dtype == torch.bfloat16 else _HEAD_DIMS
    return next(w for w in widths if w >= D)


def _pad_halves(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` [..., D] (D even) -> [..., width], each half padded with
    zeros on its own: ``[x1 | x2]`` -> ``[x1, 0 | x2, 0]``, so that the
    neox rope still pairs column i with column i + width/2.  Rope tables
    pad the same way (their padded columns multiply zeros)."""
    half, pad = t.shape[-1] // 2, (width - t.shape[-1]) // 2
    return torch.cat([torch.nn.functional.pad(t[..., :half], (0, pad)),
                      torch.nn.functional.pad(t[..., half:], (0, pad))],
                     dim=-1)


def _unpad_halves(t: torch.Tensor, D: int) -> torch.Tensor:
    """The inverse of :func:`_pad_halves`: [..., width] -> [..., D]."""
    half, mid = D // 2, t.shape[-1] // 2
    return torch.cat([t[..., :half], t[..., mid:mid + half]], dim=-1)


def _pad_to(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` [..., D] at the kernels' ``width``: per half for an even D
    (:func:`_pad_halves`), at the end for an odd D (which takes no
    rope)."""
    D = t.shape[-1]
    if D % 2:
        return torch.nn.functional.pad(t, (0, width - D))
    return _pad_halves(t, width)


def _unpad(t: torch.Tensor, D: int) -> torch.Tensor:
    """The inverse of :func:`_pad_to`: [..., width] -> [..., D]."""
    return t[..., :D].contiguous() if D % 2 else _unpad_halves(t, D)


def _padded(D: int, dtype, tensors, rope: Rope):
    """``(width, tensors, rope)``: the call's operands at the kernels'
    head dim (:func:`kernel_head_dim`), padded (:func:`_pad_to`) where it
    differs from ``D``."""
    width = kernel_head_dim(D, dtype)
    if width == D:
        return width, tensors, rope
    return (width, [_pad_to(t, width) for t in tensors],
            None if rope is None else tuple(_pad_to(t, width)
                                            for t in rope))


def _check_rope_dim(what: str, D: int) -> None:
    """The neox rope pairs column i with i + D/2: an odd head dim has no
    rope (the reference's raises on it as well)."""
    if D % 2:
        raise ValueError("%s: head_dim %d is odd; the neox rope pairs "
                         "column i with i + D/2 and needs an even head dim"
                         % (what, D))


def _on_tensor_cores(q) -> bool:
    """bf16 runs ``flash_attention_sm90.cu``, fp32 ``flash_attention.cu``."""
    return q.dtype == torch.bfloat16


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
    try:
        width = kernel_head_dim(D, q.dtype)
    except ValueError as e:
        raise ValueError("%s: %s" % (what, e)) from None
    if not width:
        raise ValueError("%s: head_dim %d: the flash kernels take head dims "
                         "up to 128 (the public entries take _chunked_sdpa "
                         "beyond)" % (what, D))
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("%s: q/k/v must share one dtype of float32/"
                         "bfloat16; got %s %s %s" % (what, q.dtype, k.dtype,
                                                     v.dtype))
    if Sq == 0 or Sk == 0:
        raise ValueError("%s: empty sequence axis" % what)
    tensors = [("q", q), ("k", k), ("v", v)] + list(more)
    if rope is not None:
        _check_rope_dim(what, D)
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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_fwd(q, k, v, causal: bool, rope: Rope = None):
    """Flash forward: ``q`` [B, Sq, H, D], ``k``/``v`` [B, Sk, H, D],
    ``rope`` optional ``(cos, sin)`` [S, D] fp32 (needs Sq == Sk).
    Returns ``(out [B, Sq, H, D], lse [B, H, Sq] fp32)``."""
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, causal, rope)
    _check("flash_fwd", q, k, v, rope)
    D0 = q.shape[-1]
    c = (1.0 / math.sqrt(D0)) * _LOG2E
    D, (q, k, v), rope = _padded(D0, q.dtype, (q, k, v), rope)
    B, Sq, H, _ = q.shape
    Sk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    cos_p, sin_p = _rope_ptrs(rope)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if _on_tensor_cores(q):
        fwd, _, _ = _tc_entries()
        # the roped k, written once per call by the kernel's pre-pass
        kr = torch.empty_like(k) if rope is not None else None
        code = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos_p, sin_p,
                   out.data_ptr(), lse.data_ptr(), _ptr(kr), B, H, Sq, Sk, D,
                   int(causal), int(rope is not None), c, stream)
    else:
        fwd, _ = _entries()
        code = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos_p, sin_p,
                   out.data_ptr(), lse.data_ptr(), B, H, Sq, Sk, D,
                   int(causal), int(rope is not None), c,
                   _DTYPE_CODE[q.dtype], stream)
    _build.check(code, "flash_fwd")
    flash_fwd.launches += 1
    return (_unpad(out, D0) if D != D0 else out), lse


def _flash_bwd(what, fused, q, k, v, out, lse, g, causal, rope):
    B, Sq, H, D0 = q.shape
    _check(what, q, k, v, rope, more=[("out", out), ("g", g), ("lse", lse)])
    if out.shape != q.shape or g.shape != q.shape or out.dtype != q.dtype \
            or g.dtype != q.dtype:
        raise ValueError("%s: out/g must match q's shape and dtype" % what)
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError("%s: lse must be [B, H, Sq] float32" % what)
    c, scale = (1.0 / math.sqrt(D0)) * _LOG2E, 1.0 / math.sqrt(D0)
    D, (q, k, v, out, g), rope = _padded(D0, q.dtype, (q, k, v, out, g),
                                         rope)
    grads = _flash_bwd_launch(fused, q, k, v, out, lse, g, causal, rope, c,
                              scale, what)
    if D == D0:
        return grads
    return tuple(_unpad(t, D0) for t in grads)


def _flash_bwd_launch(fused, q, k, v, out, lse, g, causal, rope, c, scale,
                      what):
    """Launch a backward form on checked operands at a kernel head dim."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    cos_p, sin_p = _rope_ptrs(rope)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tc = _on_tensor_cores(q)
    dq_acc = dq_turn = None
    if fused:
        # the fp32 dq workspace and the counters that order its adds (a
        # ticket, then one per b*h and q-row block: 64 rows, or 32 on the
        # tensor cores), zeroed together
        n_acc = B * Sq * H * D
        n_turn = 1 + B * H * (2 if tc else 1) * -(-Sq // 64)
        ws = torch.zeros(n_acc + n_turn, dtype=torch.float32,
                         device=q.device)
        dq_acc, dq_turn = ws[:n_acc], ws[n_acc:].view(torch.int32)
    if tc:
        # scratch of the tensor-core pre-passes: delta and lse * log2(e)
        # per row, and with rope the roped q (and k, two-kernel form)
        delta, lse2 = (torch.empty(B, H, Sq, dtype=torch.float32,
                                   device=q.device) for _ in range(2))
        qr = torch.empty_like(q) if rope is not None else None
        _, two_kernel, one_pass = _tc_entries()
        if fused:
            code = one_pass(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                g.data_ptr(), lse.data_ptr(), cos_p, sin_p, dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), _ptr(qr), delta.data_ptr(),
                lse2.data_ptr(), dq_acc.data_ptr(), dq_turn.data_ptr(), B,
                H, Sq, Sk, D, int(causal), int(rope is not None), c, scale,
                stream)
        else:
            kr = torch.empty_like(k) if rope is not None else None
            code = two_kernel(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                g.data_ptr(), lse.data_ptr(), cos_p, sin_p, dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), _ptr(kr), _ptr(qr),
                delta.data_ptr(), lse2.data_ptr(), B, H, Sq, Sk, D,
                int(causal), int(rope is not None), c, scale, stream)
        _build.check(code, what)
        return dq, dk, dv
    _, bwd = _entries()
    code = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               g.data_ptr(), lse.data_ptr(), cos_p, sin_p, dq.data_ptr(),
               dk.data_ptr(), dv.data_ptr(), _ptr(dq_acc), _ptr(dq_turn), B,
               H, Sq, Sk, D, int(causal), int(rope is not None), c, scale,
               _DTYPE_CODE[q.dtype], int(fused), stream)
    _build.check(code, what)
    return dq, dk, dv


def flash_bwd_fused(q, k, v, out, lse, g, causal: bool, rope: Rope = None):
    """One-pass flash backward (dq shares summed in k-tile order, so the
    result is deterministic): ``(dq, dk, dv)``.  ``out``/``lse`` from
    :func:`flash_fwd`, ``g`` the gradient of ``out``."""
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, out, lse, g, causal, rope,
                                form="fused")
    res = _flash_bwd("flash_bwd_fused", True, q, k, v, out, lse, g, causal,
                     rope)
    flash_bwd_fused.launches += 1
    return res


def flash_bwd_two_kernel(q, k, v, out, lse, g, causal: bool,
                         rope: Rope = None):
    """Two-kernel (FlashAttention-2) backward, deterministic:
    ``(dq, dk, dv)``; arguments as :func:`flash_bwd_fused`."""
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, out, lse, g, causal, rope,
                                form="two_kernel")
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
    _check_rope_dim("flash_attention_rope", D)
    if key.shape[1] != S:
        raise ValueError("flash_attention_rope: in-kernel rope requires "
                         "Sq == Sk; got %d and %d" % (S, key.shape[1]))
    cos, sin = rope_tables(S, D, rotary_base, device=query.device)
    return flash_rope_sdpa(query, key, value, cos, sin, is_causal)


def flash_rope_sdpa(q, k, v, cos, sin, causal: bool = True) -> torch.Tensor:
    """:func:`flash_attention_rope` with the rope tables given (reference:
    ``_flash_rope_sdpa``), for callers that build them once per step.  An
    odd head dim raises on every device (no neox pairs)."""
    _check_rope_dim("flash_rope_sdpa", q.shape[-1])
    if not _kernel_ok(q):
        return _chunked_sdpa(_rope_cast(q, cos, sin), _rope_cast(k, cos, sin),
                             v, causal)
    return FlashRopeAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), cos, sin, causal)


def flash_attention(query, key, value, is_causal: bool = False):
    """Flash attention without rope, layout [B, S, H, D] (reference:
    ``flash_attention_tpu`` without a mask)."""
    if not _kernel_ok(query):
        return _chunked_sdpa(query, key, value, is_causal)
    return FlashAttention.apply(query.contiguous(), key.contiguous(),
                                value.contiguous(), is_causal)
