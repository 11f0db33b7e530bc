"""Fused RoPE + QKV epilogue (counterpart of the rope section of
``paddle_tpu/ops/pallas_kernels.py``).

Kernel: ``csrc/rope_qkv.cu`` replaces ``_rope_qkv_kernel``
(``paddle_tpu/ops/pallas_kernels.py``, launched by ``rope_qkv_epilogue``).
It rotates q and k at each token's global position in one pass over the
projection outputs and, with ``with_amax``, also writes the per-token,
per-head absmax of the stored k and of v (the int8 pools' quantize-on-write
input; same pass).

Bound on the H100: bytes.  Each element is read once and written once with
a handful of fp32 operations, far below the ~295 operations per byte where
the card turns compute bound, so the design is one block per token row,
one warp per head row, neighbouring lanes on neighbouring elements, with
no shared memory and nothing kept between rows.  At the serving shapes the
pass is a few MB, so launch latency, not bandwidth, dominates it.

Bit identity: the reference keeps this pass bit-identical to its XLA
version.  The kernel writes ``x*cos + rot*sin`` with ``__fmul_rn`` and
``__fadd_rn`` so that ``nvcc`` cannot contract it into an FMA, and casts
with round-to-nearest-even, so it equals :func:`_rope_qkv_epilogue_plain`
bit for bit for the same cos/sin tables.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rope_tables_for_positions(positions: torch.Tensor, dim: int,
                              base: float = 10000.0):
    """Neox cos/sin tables for a token-indexed position vector:
    ``positions`` [N] int -> ``(cos, sin)`` [N, dim] fp32.  The same
    expression as the reference's ``rope_tables_for_positions`` (same
    inverse frequencies, same fp32 order of operations); the library
    ``cos``/``sin`` may differ from XLA's by one ulp."""
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=positions.device) / dim))
    freqs = positions.to(torch.float32)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rope_rows(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Neox rotation of token-major rows ``t`` [N, Hx, D] by ``cos``/``sin``
    [N, D] (broadcast over heads), in fp32: ``t*cos + rot*sin`` with
    ``rot = cat(-t[..., D/2:], t[..., :D/2])`` — the reference's
    ``_rope_rows`` op for op."""
    tf = t.to(torch.float32)
    half = tf.shape[-1] // 2
    rot = torch.cat([-tf[..., half:], tf[..., :half]], dim=-1)
    return tf * cos[:, None, :] + rot * sin[:, None, :]


def _rope_qkv_epilogue_plain(q, k, v, cos, sin, with_amax: bool):
    """The plain PyTorch version of the kernel (reference:
    ``_rope_qkv_epilogue_xla``): same fp32 expressions, then the cast."""
    q_rot = _rope_rows(q, cos, sin).to(q.dtype)
    k_rot = _rope_rows(k, cos, sin).to(k.dtype)
    if not with_amax:
        return q_rot, k_rot, None, None
    k_amax = k_rot.to(torch.float32).abs().amax(dim=-1)
    v_amax = v.to(torch.float32).abs().amax(dim=-1)
    return q_rot, k_rot, k_amax, v_amax


def _entry():
    fn = _build.load("rope_qkv").ptt_rope_qkv
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def rope_qkv_epilogue(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cos: torch.Tensor, sin: torch.Tensor,
                      with_amax: bool = False):
    """Fused pre-attention epilogue: ``q`` [N, H, D], ``k``/``v``
    [N, Hkv, D] token-major projection outputs, ``cos``/``sin`` [N, D]
    fp32 from :func:`rope_tables_for_positions`.  Returns ``(q_rot, k_rot,
    k_amax, v_amax)``; the amaxes are ``None`` unless ``with_amax``.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.device.type == "cpu":
        return _rope_qkv_epilogue_plain(q, k, v, cos, sin, with_amax)
    if q.device.type != "cuda":
        raise ValueError("rope_qkv_epilogue: unsupported device %s"
                         % q.device)
    N, H, D = q.shape
    Hkv = k.shape[1]
    if (k.shape != (N, Hkv, D) or v.shape != k.shape
            or cos.shape != (N, D) or sin.shape != (N, D)):
        raise ValueError("rope_qkv_epilogue: shapes q %s k %s v %s cos %s "
                         "sin %s" % (tuple(q.shape), tuple(k.shape),
                                     tuple(v.shape), tuple(cos.shape),
                                     tuple(sin.shape)))
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("rope_qkv_epilogue: q/k/v must share one dtype of "
                         "float32/bfloat16; got %s %s %s"
                         % (q.dtype, k.dtype, v.dtype))
    if cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise ValueError("rope_qkv_epilogue: cos/sin must be float32")
    if N == 0 or D % 2:
        raise ValueError("rope_qkv_epilogue: needs N > 0 rows and an even "
                         "head_dim; got N=%d D=%d" % (N, D))
    for name, t in (("q", q), ("k", k), ("v", v), ("cos", cos),
                    ("sin", sin)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("rope_qkv_epilogue: %s must be a contiguous "
                             "tensor on %s" % (name, q.device))
    q_rot = torch.empty_like(q)
    k_rot = torch.empty_like(k)
    if with_amax:
        k_amax = torch.empty(N, Hkv, dtype=torch.float32, device=q.device)
        v_amax = torch.empty(N, Hkv, dtype=torch.float32, device=q.device)
    else:
        k_amax = v_amax = None
    fn = _entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
              sin.data_ptr(), q_rot.data_ptr(), k_rot.data_ptr(),
              k_amax.data_ptr() if with_amax else None,
              v_amax.data_ptr() if with_amax else None,
              N, H, Hkv, D, _DTYPE_CODE[q.dtype], int(with_amax), stream)
    _build.check(code, "rope_qkv_epilogue")
    rope_qkv_epilogue.launches += 1
    return q_rot, k_rot, k_amax, v_amax


rope_qkv_epilogue.launches = 0
