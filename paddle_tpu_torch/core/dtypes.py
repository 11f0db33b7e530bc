"""Dtypes (counterpart of ``paddle_tpu/core/dtypes.py``).

The names are the reference's paddle-style names; each maps to a
``torch.dtype``.  The rules are the reference's, which are JAX's with x64
on, not torch's:

- Python floats become the default float dtype (float32), Python ints
  int64, an explicit ``np.float64`` stays float64 (:func:`default_cast`);
- two operands promote on JAX's lattice for non-weak types
  (:func:`promote`): bf16 with f16 gives f32, an int with a float gives
  the float, a signed int with an unsigned one the next signed int that
  holds both;
- an op that needs an inexact type takes int64 (and uint64) to float64
  and every narrower int or bool to float32 (:func:`to_inexact`), so
  int64 / int64 is float64 where torch gives float32.
"""
from __future__ import annotations

import numpy as np
import torch

bfloat16 = torch.bfloat16
float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
uint16 = torch.uint16
uint32 = torch.uint32
uint64 = torch.uint64
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

_NAME_TO_DTYPE = {
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float16": float16, "fp16": float16, "half": float16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int64": int64,
    "int": int32, "long": int64,
    "uint8": uint8, "uint16": uint16, "uint32": uint32, "uint64": uint64,
    "bool": bool_,
    "complex64": complex64, "complex128": complex128,
    "float8_e4m3fn": float8_e4m3fn, "float8_e5m2": float8_e5m2,
}
_DTYPE_TO_NAME = {}
for _n, _d in _NAME_TO_DTYPE.items():
    _DTYPE_TO_NAME.setdefault(_d, _n)

_NP_TO_TORCH = {np.dtype(k): v for k, v in (
    (np.bool_, bool_), (np.uint8, uint8), (np.int8, int8),
    (np.int16, int16), (np.int32, int32), (np.int64, int64),
    (np.uint16, uint16), (np.uint32, uint32), (np.uint64, uint64),
    (np.float16, float16), (np.float32, float32), (np.float64, float64),
    (np.complex64, complex64), (np.complex128, complex128))}


def convert_dtype(dtype):
    """A user's dtype (a name, a ``torch.dtype``, a numpy dtype or type)
    as a ``torch.dtype``; None stays None."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _NAME_TO_DTYPE[dtype]
        except KeyError:
            raise ValueError("Unknown dtype name: %r" % (dtype,))
    if dtype is bool:
        return bool_
    if dtype is int:
        return int64
    if dtype is float:
        return float32
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None)
    if name == "bfloat16":
        return bfloat16
    try:
        return _NP_TO_TORCH[np.dtype(dtype)]
    except (TypeError, KeyError):
        raise ValueError("Unknown dtype: %r" % (dtype,))


def dtype_name(dtype) -> str:
    """The canonical paddle-style name of a dtype."""
    return _DTYPE_TO_NAME[convert_dtype(dtype)]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_complex(dtype) -> bool:
    return convert_dtype(dtype).is_complex


def is_inexact(dtype) -> bool:
    d = convert_dtype(dtype)
    return d.is_floating_point or d.is_complex


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d == bool_)


_DEFAULT_DTYPE = [float32]


def get_default_dtype():
    return _DEFAULT_DTYPE[0]


def set_default_dtype(dtype):
    d = convert_dtype(dtype)
    if not d.is_floating_point:
        raise TypeError("default dtype must be floating point, got %s" % d)
    _DEFAULT_DTYPE[0] = d


# -- promotion (JAX's lattice for non-weak types, x64 on) --------------------
_SIGNED = {int8: 8, int16: 16, int32: 32, int64: 64}
_UNSIGNED = {uint8: 8, uint16: 16, uint32: 32, uint64: 64}
_SIGNED_BY_BITS = {8: int8, 16: int16, 32: int32, 64: int64}
_FLOATS = (float16, bfloat16, float32, float64)


def _float_rank(d):
    return {float16: 1, bfloat16: 1, float32: 2, float64: 3}[d]


def promote(a, b):
    """The result dtype of a binary op on dtypes ``a`` and ``b`` (the
    reference's ``jnp.promote_types``)."""
    if a == b:
        return a
    if a == bool_:
        return b
    if b == bool_:
        return a
    if a.is_complex or b.is_complex:
        wide = any(d in (float64, complex128) for d in (a, b))
        return complex128 if wide else complex64
    fa, fb = a.is_floating_point, b.is_floating_point
    if fa and fb:
        if {a, b} == {float16, bfloat16}:
            return float32
        return a if _float_rank(a) >= _float_rank(b) else b
    if fa:
        return a
    if fb:
        return b
    if a in _SIGNED and b in _SIGNED:
        return a if _SIGNED[a] >= _SIGNED[b] else b
    if a in _UNSIGNED and b in _UNSIGNED:
        return a if _UNSIGNED[a] >= _UNSIGNED[b] else b
    s, u = (a, b) if a in _SIGNED else (b, a)
    if _SIGNED[s] > _UNSIGNED[u]:
        return s
    if _UNSIGNED[u] >= 64:
        return float64
    return _SIGNED_BY_BITS[_UNSIGNED[u] * 2]


def result_type(*dtypes):
    out = dtypes[0]
    for d in dtypes[1:]:
        out = promote(out, d)
    return out


def to_inexact(d):
    """The dtype an op that needs an inexact input computes in: floats
    and complexes as they are, int64/uint64 as float64, every other int
    and bool as float32 (the reference's ``promote_args_inexact``)."""
    if d.is_floating_point or d.is_complex:
        return d
    if d in (int64, uint64):
        return float64
    return float32


def default_cast(data) -> np.ndarray:
    """``np.asarray`` with the reference's defaults: Python floats (and
    float lists) take the default float dtype; an explicit ``np.float64``
    array or scalar is kept."""
    arr = np.asarray(data)
    if arr.dtype == np.float64 and not isinstance(data,
                                                  (np.ndarray, np.generic)):
        arr = arr.astype(np.float32 if get_default_dtype() == float32
                         else _TORCH_TO_NP[get_default_dtype()])
    return arr


_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}

