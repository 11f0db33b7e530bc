"""The paddle API's op families, port against reference: the same seeded
numpy inputs go through ``paddle_tpu.<op>`` and ``paddle_tpu_torch.<op>``
on the CPU.  The forward must agree to 1e-6 (fp32) with the same output
dtype; for a differentiable float op, the gradient of ``sum(out * c)``
(``c`` a seeded cotangent) must agree to 1e-5.  Random ops cannot match
JAX's bits: they are held to the reference's shapes and dtypes, to the
seed contract and to their distribution.  A coverage test requires every
op the reference registers in these families to exist in the port."""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu.ops import registry as ref_registry
from paddle_tpu_torch.core.device import device_guard
from torch_api_parity import compare_outputs, run_both, run_cases, seed_of
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

FWD_TOL = 1e-6
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    with device_guard("cpu"):
        yield


def F(*shape):
    return lambda r: r.randn(*shape).astype(np.float32)


def U(*shape, lo=-0.9, hi=0.9):
    return lambda r: r.uniform(lo, hi, shape).astype(np.float32)


def POS(*shape):
    return U(*shape, lo=0.5, hi=3.0)


def I(*shape, lo=0, hi=5, dtype=np.int64):
    return lambda r: r.randint(lo, hi, shape).astype(dtype)


def B(*shape):
    return lambda r: r.rand(*shape) > 0.5


def CONST(value):
    return lambda r: value


def L(*makers):
    return lambda r: [m(r) for m in makers]


def SPECIAL(r):
    return np.array([[1.0, np.nan, np.inf, -np.inf], [0.5, -2.0, 0.0, 3.0]],
                    np.float32)


def SORTED(r):
    return np.sort(r.randn(6)).astype(np.float32)


def SORTED5(r):
    return np.sort(r.randn(5)).astype(np.float32)


def NOZERO(*shape):
    return lambda r: (r.uniform(0.5, 2.0, shape) * np.where(
        r.rand(*shape) > 0.5, 1, -1)).astype(np.float32)


def UNIQUE_ROWS(n, hi):
    return lambda r: r.permutation(hi)[:n].astype(np.int64)


def ROW_IDX(rows, k, hi):
    return lambda r: np.stack([r.permutation(hi)[:k] for _ in range(rows)]
                              ).astype(np.int64)


# (case id, op name, input makers, kwargs); grads are checked where the
# output is float and some input is float
CASES = [
    # -- math: unary --------------------------------------------------------
    ("abs", "abs", [NOZERO(3, 4)], {}),
    ("acos", "acos", [U(3, 4)], {}),
    ("asin", "asin", [U(3, 4)], {}),
    ("atan", "atan", [F(3, 4)], {}),
    ("acosh", "acosh", [U(3, 4, lo=1.2, hi=3.0)], {}),
    ("asinh", "asinh", [F(3, 4)], {}),
    ("atanh", "atanh", [U(3, 4)], {}),
    ("ceil", "ceil", [F(3, 4)], {}),
    ("floor", "floor", [F(3, 4)], {}),
    ("cos", "cos", [F(3, 4)], {}),
    ("cosh", "cosh", [F(3, 4)], {}),
    ("sin", "sin", [F(3, 4)], {}),
    ("sinh", "sinh", [F(3, 4)], {}),
    ("tan", "tan", [U(3, 4)], {}),
    ("tanh", "tanh", [F(3, 4)], {}),
    ("exp", "exp", [F(3, 4)], {}),
    ("expm1", "expm1", [F(3, 4)], {}),
    ("log", "log", [POS(3, 4)], {}),
    ("log2", "log2", [POS(3, 4)], {}),
    ("log10", "log10", [POS(3, 4)], {}),
    ("log1p", "log1p", [POS(3, 4)], {}),
    ("sqrt", "sqrt", [POS(3, 4)], {}),
    ("sqrt_int64", "sqrt", [I(3, 4, lo=1, hi=9)], {}),
    ("sqrt_int32", "sqrt", [I(3, 4, lo=1, hi=9, dtype=np.int32)], {}),
    ("rsqrt", "rsqrt", [POS(3, 4)], {}),
    ("square", "square", [F(3, 4)], {}),
    ("reciprocal", "reciprocal", [NOZERO(3, 4)], {}),
    ("sign", "sign", [NOZERO(3, 4)], {}),
    ("erf", "erf", [F(3, 4)], {}),
    ("erfinv", "erfinv", [U(3, 4)], {}),
    ("sigmoid", "sigmoid", [F(3, 4)], {}),
    ("lgamma", "lgamma", [POS(3, 4)], {}),
    ("digamma", "digamma", [POS(3, 4)], {}),
    ("i0", "i0", [F(3, 4)], {}),
    ("i0e", "i0e", [F(3, 4)], {}),
    ("i1", "i1", [F(3, 4)], {}),
    ("i1e", "i1e", [F(3, 4)], {}),
    ("angle", "angle", [NOZERO(3, 4)], {}),
    ("conj", "conj", [F(3, 4)], {}),
    ("trunc", "trunc", [F(3, 4)], {}),
    ("frac", "frac", [F(3, 4)], {}),
    ("neg", "neg", [F(3, 4)], {}),
    ("deg2rad", "deg2rad", [F(3, 4)], {}),
    ("rad2deg", "rad2deg", [F(3, 4)], {}),
    ("round", "round", [F(3, 4)], {}),
    ("isnan", "isnan", [SPECIAL], {}),
    ("isinf", "isinf", [SPECIAL], {}),
    ("isfinite", "isfinite", [SPECIAL], {}),
    ("isneginf", "isneginf", [SPECIAL], {}),
    ("isposinf", "isposinf", [SPECIAL], {}),
    ("isreal", "isreal", [F(3, 4)], {}),
    ("signbit", "signbit", [F(3, 4)], {}),
    ("logical_not", "logical_not", [B(3, 4)], {}),
    ("bitwise_not", "bitwise_not", [I(3, 4)], {}),
    # -- math: binary ---------------------------------------------------------
    ("add", "add", [F(3, 4), F(4)], {}),
    ("add_int_float", "add", [I(3, 4), F(3, 4)], {}),
    ("add_int32_int64", "add", [I(3, 4, dtype=np.int32), I(3, 4)], {}),
    ("subtract", "subtract", [F(3, 4), F(3, 4)], {}),
    ("multiply", "multiply", [F(3, 4), F(3, 1)], {}),
    ("multiply_scalar", "multiply", [I(3, 4), CONST(0.5)], {}),
    ("divide", "divide", [F(3, 4), NOZERO(3, 4)], {}),
    ("divide_int64", "divide", [I(3, 4), I(3, 4, lo=1)], {}),
    ("divide_int32", "divide", [I(3, 4, dtype=np.int32),
                                I(3, 4, lo=1, dtype=np.int32)], {}),
    ("floor_divide", "floor_divide", [F(3, 4), POS(3, 4)], {}),
    ("floor_divide_int", "floor_divide", [I(3, 4, lo=-5), I(3, 4, lo=1)],
     {}),
    ("mod", "mod", [F(3, 4), POS(3, 4)], {}),
    ("remainder", "remainder", [I(3, 4, lo=-5), I(3, 4, lo=1)], {}),
    ("floor_mod", "floor_mod", [F(3, 4), POS(3, 4)], {}),
    ("maximum", "maximum", [F(3, 4), F(3, 4)], {}),
    ("minimum", "minimum", [F(3, 4), F(3, 4)], {}),
    ("fmax", "fmax", [F(3, 4), F(3, 4)], {}),
    ("fmin", "fmin", [F(3, 4), F(3, 4)], {}),
    ("atan2", "atan2", [F(3, 4), F(3, 4)], {}),
    ("logaddexp", "logaddexp", [F(3, 4), F(3, 4)], {}),
    ("hypot", "hypot", [F(3, 4), F(3, 4)], {}),
    ("copysign", "copysign", [F(3, 4), NOZERO(3, 4)], {}),
    ("nextafter", "nextafter", [F(3, 4), F(3, 4)], {}),
    ("heaviside", "heaviside", [NOZERO(3, 4), F(3, 4)], {}),
    ("gcd", "gcd", [I(3, 4, lo=1, hi=30), I(3, 4, lo=1, hi=30)], {}),
    ("lcm", "lcm", [I(3, 4, lo=1, hi=30), I(3, 4, lo=1, hi=30)], {}),
    ("ldexp", "ldexp", [F(3, 4), I(3, 4, lo=-3, hi=3)], {}),
    ("polygamma", "polygamma", [POS(3, 4), CONST(np.int64(1))], {}),
    ("equal", "equal", [I(3, 4, hi=3), I(3, 4, hi=3)], {}),
    ("not_equal", "not_equal", [I(3, 4, hi=3), I(3, 4, hi=3)], {}),
    ("greater_than", "greater_than", [F(3, 4), F(3, 4)], {}),
    ("greater_equal", "greater_equal", [I(3, 4), I(3, 4)], {}),
    ("less_than", "less_than", [F(3, 4), F(3, 4)], {}),
    ("less_equal", "less_equal", [I(3, 4), F(3, 4)], {}),
    ("logical_and", "logical_and", [B(3, 4), B(3, 4)], {}),
    ("logical_or", "logical_or", [B(3, 4), B(3, 4)], {}),
    ("logical_xor", "logical_xor", [B(3, 4), B(3, 4)], {}),
    ("bitwise_and", "bitwise_and", [I(3, 4, hi=16), I(3, 4, hi=16)], {}),
    ("bitwise_or", "bitwise_or", [I(3, 4, hi=16), I(3, 4, hi=16)], {}),
    ("bitwise_xor", "bitwise_xor", [I(3, 4, hi=16), I(3, 4, hi=16)], {}),
    ("bitwise_left_shift", "bitwise_left_shift",
     [I(3, 4, hi=16), I(3, 4, hi=4)], {}),
    ("bitwise_right_shift", "bitwise_right_shift",
     [I(3, 4, lo=-16, hi=16), I(3, 4, hi=4)], {}),
    ("pow", "pow", [POS(3, 4), F(3, 4)], {}),
    ("pow_scalar", "pow", [F(3, 4), CONST(2.0)], {}),
    ("scale", "scale", [F(3, 4)], dict(scale=2.0, bias=1.0)),
    ("scale_bias_first", "scale", [F(3, 4)],
     dict(scale=-1.5, bias=0.5, bias_after_scale=False)),
    ("clip", "clip", [F(3, 4)], dict(min=-0.5, max=0.5)),
    ("clip_max_only", "clip", [F(3, 4)], dict(max=0.2)),
    ("clamp", "clamp", [F(3, 4)], dict(min=-0.3)),
    ("stanh", "stanh", [F(3, 4)], {}),
    ("multiplex", "multiplex", [L(F(3, 4), F(3, 4), F(3, 4)),
                                I(3, 1, hi=3)], {}),
    ("add_n", "add_n", [L(F(3, 4), F(3, 4), F(3, 4))], {}),
    ("nan_to_num", "nan_to_num", [SPECIAL], {}),
    ("lerp", "lerp", [F(3, 4), F(3, 4), U(3, 4, lo=0.0, hi=1.0)], {}),
    ("logit", "logit", [U(3, 4, lo=0.1, hi=0.9)], {}),
    ("logit_eps", "logit", [U(3, 4, lo=0.01, hi=0.99)], dict(eps=0.05)),
    ("log_normalize", "log_normalize", [F(3, 4)], {}),
    ("real", "real", [F(3, 4)], {}),
    ("imag", "imag", [F(3, 4)], {}),
    ("diff", "diff", [F(3, 5)], dict(axis=1)),
    ("diff_prepend", "diff", [F(3, 5)], dict(n=2, axis=0)),
    ("trapezoid", "trapezoid", [F(3, 5)], dict(dx=0.5)),
    ("trapezoid_x", "trapezoid", [F(3, 5), SORTED5], {}),
    ("positive", "positive", [F(3, 4)], {}),
    # -- creation -------------------------------------------------------------
    ("zeros", "zeros", [CONST([2, 3])], {}),
    ("ones", "ones", [CONST([2, 3])], dict(dtype="int32")),
    ("full", "full", [CONST([2, 3]), CONST(1.5)], {}),
    ("full_int", "full", [CONST([2, 3]), CONST(3)], {}),
    ("zeros_like", "zeros_like", [F(3, 4)], {}),
    ("ones_like", "ones_like", [I(3, 4)], {}),
    ("full_like", "full_like", [F(3, 4), CONST(2.0)], {}),
    ("empty", "empty", [CONST([2, 3])], {}),
    ("empty_like", "empty_like", [F(3, 4)], {}),
    ("arange_int", "arange", [CONST(0), CONST(10), CONST(3)], {}),
    ("arange_float", "arange", [CONST(0.0), CONST(1.0), CONST(0.25)], {}),
    ("arange_end", "arange", [CONST(5)], {}),
    ("linspace", "linspace", [CONST(0), CONST(1), CONST(5)], {}),
    ("linspace_f32", "linspace", [CONST(-1.0), CONST(2.0), CONST(7)],
     dict(dtype="float32")),
    ("logspace", "logspace", [CONST(0), CONST(2), CONST(5)],
     dict(dtype="float32")),
    ("eye", "eye", [CONST(3), CONST(4)], {}),
    ("meshgrid", "meshgrid", [F(3), F(4)], {}),
    ("diag_vector", "diag", [F(3)], dict(offset=1)),
    ("diag_padded", "diag", [F(3)], dict(padding_value=2.0)),
    ("diag_matrix", "diag", [F(3, 4)], {}),
    ("diagflat", "diagflat", [F(2, 2)], {}),
    ("diag_embed", "diag_embed", [F(2, 3)], {}),
    ("diagonal", "diagonal", [F(3, 4)], dict(offset=1)),
    ("tril", "tril", [F(4, 4)], {}),
    ("triu", "triu", [F(4, 4)], dict(diagonal=1)),
    ("tril_indices", "tril_indices", [CONST(4), CONST(4)], {}),
    ("triu_indices", "triu_indices", [CONST(4), CONST(5)],
     dict(offset=1)),
    ("assign", "assign", [F(3, 4)], {}),
    ("numel", "numel", [F(3, 4)], {}),
    ("one_hot", "one_hot", [I(5)], dict(num_classes=6)),
    ("complex", "complex", [F(3), F(3)], {}),
    ("as_complex", "as_complex", [F(3, 2)], {}),
    ("as_real", "as_real",
     [lambda r: (r.randn(3) + 1j * r.randn(3)).astype(np.complex64)], {}),
    ("clone", "clone", [F(3, 4)], {}),
    ("cast", "cast", [F(3, 4)], dict(dtype="int32")),
    ("cast_f64", "cast", [F(3, 4)], dict(dtype="float64")),
    # -- reduction -------------------------------------------------------------
    ("sum", "sum", [F(3, 4)], dict(axis=1)),
    ("sum_all", "sum", [F(3, 4)], {}),
    ("sum_int32", "sum", [I(3, 4, dtype=np.int32)], {}),
    ("sum_keepdim", "sum", [F(2, 3, 4)], dict(axis=[0, 2], keepdim=True)),
    ("mean", "mean", [F(3, 4)], dict(axis=0)),
    ("mean_int", "mean", [I(3, 4)], {}),
    ("prod", "prod", [F(3, 4)], dict(axis=1)),
    ("nansum", "nansum", [F(3, 4)], dict(axis=1)),
    ("nanmean", "nanmean", [F(3, 4)], dict(axis=1)),
    ("amax", "amax", [F(3, 4)], dict(axis=1)),
    ("amin", "amin", [F(3, 4)], dict(axis=1, keepdim=True)),
    ("max", "max", [F(3, 4)], dict(axis=0)),
    ("min", "min", [F(3, 4)], {}),
    ("all", "all", [B(3, 4)], dict(axis=1)),
    ("any", "any", [B(3, 4)], {}),
    ("argmax", "argmax", [F(3, 4)], dict(axis=1)),
    ("argmin", "argmin", [F(3, 4)], {}),
    ("cumsum", "cumsum", [F(3, 4)], dict(axis=1)),
    ("cumsum_flat_int32", "cumsum", [I(3, 4, dtype=np.int32)], {}),
    ("cumprod", "cumprod", [F(3, 4)], dict(dim=1)),
    ("cummax", "cummax", [F(3, 4)], dict(axis=1)),
    ("cummin", "cummin", [F(3, 4)], dict(axis=0)),
    ("logsumexp", "logsumexp", [F(3, 4)], dict(axis=1)),
    ("logcumsumexp", "logcumsumexp", [F(3, 4)], dict(axis=1)),
    ("std", "std", [F(3, 4)], dict(axis=1)),
    ("var", "var", [F(3, 4)], dict(unbiased=False)),
    ("median", "median", [F(3, 4)], dict(axis=1)),
    ("median_min", "median", [F(3, 5)], dict(axis=1, mode="min")),
    ("nanmedian", "nanmedian", [F(3, 4)], dict(axis=1)),
    ("quantile", "quantile", [F(3, 4)], dict(q=0.3, axis=1)),
    ("nanquantile", "nanquantile", [F(3, 4)], dict(q=0.7, axis=0)),
    ("kthvalue", "kthvalue", [F(3, 4)], dict(k=2)),
    ("mode", "mode", [I(3, 6, hi=3)], {}),
    ("count_nonzero", "count_nonzero", [I(3, 4, hi=2)], dict(axis=1)),
    ("histogram", "histogram", [F(20)], dict(bins=5)),
    ("histogramdd", "histogramdd", [F(10, 2)], dict(bins=3)),
    ("bincount", "bincount", [I(12, hi=6)], {}),
    # -- logic -----------------------------------------------------------------
    ("allclose", "allclose", [F(3, 4), F(3, 4)], {}),
    ("isclose", "isclose", [F(3, 4), F(3, 4)], dict(atol=0.5)),
    ("equal_all", "equal_all", [I(3, 4, hi=1), I(3, 4, hi=1)], {}),
    ("is_empty", "is_empty", [F(0, 3)], {}),
    ("is_tensor", "is_tensor", [F(3)], {}),
    ("in_dynamic_mode", "in_dynamic_mode", [], {}),
    # -- manipulation ----------------------------------------------------------
    ("reshape", "reshape", [F(3, 4)], dict(shape=[4, 3])),
    ("view", "view", [F(3, 4)], dict(shape=[2, -1])),
    ("transpose", "transpose", [F(2, 3, 4)], dict(perm=[2, 0, 1])),
    ("moveaxis", "moveaxis", [F(2, 3, 4)], dict(source=0, destination=2)),
    ("swapaxes", "swapaxes", [F(2, 3, 4)], dict(axis1=0, axis2=2)),
    ("swapdims", "swapdims", [F(2, 3, 4)], dict(axis1=1, axis2=2)),
    ("flatten", "flatten", [F(2, 3, 4)], dict(start_axis=1)),
    ("squeeze", "squeeze", [F(3, 1, 4)], dict(axis=1)),
    ("unsqueeze", "unsqueeze", [F(3, 4)], dict(axis=[0, 2])),
    ("concat", "concat", [L(F(2, 3), F(1, 3))], {}),
    ("concat_mixed", "concat", [L(F(2, 3), I(1, 3))], {}),
    ("concatenate", "concatenate", [L(F(2, 3), F(2, 3))], dict(axis=1)),
    ("stack", "stack", [L(F(2, 3), F(2, 3))], dict(axis=1)),
    ("split", "split", [F(4, 3)], dict(num_or_sections=2)),
    ("split_sections", "split", [F(3, 6)],
     dict(num_or_sections=[1, -1, 2], axis=1)),
    ("chunk", "chunk", [F(4, 3)], dict(chunks=2)),
    ("unbind", "unbind", [F(3, 4)], dict(axis=1)),
    ("unstack", "unstack", [F(3, 4)], {}),
    ("tile", "tile", [F(2, 3)], dict(repeat_times=[2, 1])),
    ("expand", "expand", [F(1, 3)], dict(shape=[2, -1])),
    ("expand_as", "expand_as", [F(1, 3), F(4, 3)], {}),
    ("broadcast_to", "broadcast_to", [F(3)], dict(shape=[2, 3])),
    ("broadcast_tensors", "broadcast_tensors", [L(F(1, 3), F(2, 1))], {}),
    ("flip", "flip", [F(3, 4)], dict(axis=[0, 1])),
    ("rot90", "rot90", [F(3, 4)], {}),
    ("roll", "roll", [F(3, 4)], dict(shifts=1, axis=0)),
    ("roll_flat", "roll", [F(3, 4)], dict(shifts=2)),
    ("gather", "gather", [F(5, 3), I(4, hi=5)], {}),
    ("gather_axis", "gather", [F(3, 5), I(2, hi=5)], dict(axis=1)),
    ("gather_nd", "gather_nd", [F(4, 5), I(3, 2, hi=4)], {}),
    ("scatter", "scatter", [F(5, 3), UNIQUE_ROWS(2, 5), F(2, 3)], {}),
    ("scatter_add", "scatter", [F(5, 3), I(4, hi=5), F(4, 3)],
     dict(overwrite=False)),
    ("scatter_nd_add", "scatter_nd_add", [F(4, 3), I(5, 1, hi=4), F(5, 3)],
     {}),
    ("scatter_nd", "scatter_nd", [I(5, 1, hi=4), F(5, 3)],
     dict(shape=[4, 3])),
    ("index_select", "index_select", [F(5, 3), I(4, hi=5)], {}),
    ("index_sample", "index_sample", [F(3, 5), I(3, 2, hi=5)], {}),
    ("index_add", "index_add", [F(5, 3), I(4, hi=5)],
     dict(axis=0, value=np.ones((4, 3), np.float32))),
    ("index_put", "index_put", [F(5, 3), L(UNIQUE_ROWS(2, 5)), F(2, 3)],
     {}),
    ("take_along_axis", "take_along_axis", [F(3, 5), ROW_IDX(3, 2, 5)],
     dict(axis=1)),
    ("put_along_axis", "put_along_axis", [F(3, 5), ROW_IDX(3, 2, 5),
                                          F(3, 2)], dict(axis=1)),
    ("put_along_axis_add", "put_along_axis", [F(3, 5), ROW_IDX(3, 2, 5),
                                              F(3, 2)],
     dict(axis=1, reduce="add")),
    ("take", "take", [F(3, 4), I(5, hi=12)], {}),
    ("masked_select", "masked_select", [F(3, 4), B(3, 4)], {}),
    ("masked_fill", "masked_fill", [F(3, 4), B(3, 4)], dict(value=0.5)),
    ("masked_scatter", "masked_scatter", [F(3, 4), B(3, 4), F(12)], {}),
    ("where", "where", [B(3, 4), F(3, 4), F(3, 4)], {}),
    ("nonzero", "nonzero", [I(3, 4, hi=2)], {}),
    ("sort", "sort", [F(3, 4)], dict(axis=1)),
    ("sort_descending", "sort", [F(3, 4)], dict(axis=0, descending=True)),
    ("argsort", "argsort", [F(3, 4)], {}),
    ("topk", "topk", [F(3, 5)], dict(k=2)),
    ("topk_smallest", "topk", [F(3, 5)], dict(k=3, largest=False)),
    ("searchsorted", "searchsorted", [SORTED, F(5)], {}),
    ("bucketize", "bucketize", [F(5), SORTED], dict(right=True)),
    ("unique", "unique", [I(10, hi=4)], dict(return_counts=True)),
    ("unique_consecutive", "unique_consecutive", [I(10, hi=3)],
     dict(return_counts=True)),
    ("repeat_interleave", "repeat_interleave", [F(3, 2)],
     dict(repeats=2, axis=0)),
    ("pad", "pad", [F(1, 2, 3, 4)], dict(pad=[1, 1, 2, 0])),
    ("pad_reflect", "pad", [F(1, 2, 4, 5)], dict(pad=[1, 2, 1, 1],
                                                 mode="reflect")),
    ("slice", "slice", [F(4, 5)], dict(axes=[0, 1], starts=[1, 0],
                                        ends=[3, -1])),
    ("strided_slice", "strided_slice", [F(4, 6)],
     dict(axes=[1], starts=[0], ends=[6], strides=[2])),
    ("crop", "crop", [F(4, 5)], dict(shape=[2, 3], offsets=[1, 1])),
    ("shard_index", "shard_index", [I(6, 1, hi=20)],
     dict(index_num=20, nshards=2, shard_id=0)),
    ("kron", "kron", [F(2, 2), F(2, 3)], {}),
    ("view_as", "view_as", [F(3, 4), F(4, 3)], {}),
    ("as_strided", "as_strided", [F(3, 4)], dict(shape=[2, 2],
                                                 stride=[1, 2])),
    ("tensordot", "tensordot", [F(2, 3, 4), F(4, 3, 2)],
     dict(axes=[[1, 2], [1, 0]])),
    ("atleast_1d", "atleast_1d", [CONST(np.float32(2.0))], {}),
    ("atleast_2d", "atleast_2d", [F(3)], {}),
    ("atleast_3d", "atleast_3d", [F(2, 3)], {}),
    ("block_diag", "block_diag", [L(F(2, 2), F(1, 3))], {}),
    ("pdist", "pdist", [F(4, 3)], {}),
    ("cartesian_prod", "cartesian_prod", [L(F(2), F(3))], {}),
    ("hstack", "hstack", [L(F(2, 3), F(2, 1))], {}),
    ("vstack", "vstack", [L(F(2, 3), F(1, 3))], {}),
    ("dstack", "dstack", [L(F(2, 3), F(2, 3))], {}),
    ("column_stack", "column_stack", [L(F(3), F(3, 2))], {}),
    ("row_stack", "row_stack", [L(F(3), F(3))], {}),
    # -- the matmul family -----------------------------------------------------
    ("matmul", "matmul", [F(2, 3), F(3, 4)], {}),
    ("matmul_transpose", "matmul", [F(3, 2), F(4, 3)],
     dict(transpose_x=True, transpose_y=True)),
    ("matmul_batched", "matmul", [F(2, 3, 4), F(4, 5)], {}),
    ("mm", "mm", [F(2, 3), F(3, 4)], {}),
    ("dot", "dot", [F(2, 3), F(2, 3)], {}),
    ("bmm", "bmm", [F(2, 3, 4), F(2, 4, 2)], {}),
    ("mv", "mv", [F(3, 4), F(4)], {}),
    ("t", "t", [F(3, 4)], {}),
    ("addmm", "addmm", [F(2, 4), F(2, 3), F(3, 4)],
     dict(beta=0.5, alpha=2.0)),
    ("einsum", "einsum", [CONST("ij,jk->ik"), F(2, 3), F(3, 4)], {}),
]


def _check_case(case):
    _, name, makers, kwargs = case
    # the reference has no derivative of nextafter
    ref, port = run_both(name, makers, kwargs, seed=seed_of(case[0]),
                         grad=name != "nextafter")
    compare_outputs(ref, port, FWD_TOL, GRAD_TOL)


# the cases in groups of 11 a test: a file of many tests is handed to an
# xdist worker before the suite's long files (--dist loadfile), so the
# file stays under 39 tests; a group reports every case that failed
GROUPS = [CASES[i:i + 11] for i in range(0, len(CASES), 11)]


@pytest.mark.parametrize("group", GROUPS,
                         ids=["%s-%s" % (g[0][0], g[-1][0]) for g in GROUPS])
def test_ops_match_reference(group):
    run_cases(group, _check_case)


RANDOM = [("rand", ([2, 3],), {}), ("randn", ([2, 3],), {}),
          ("standard_normal", ([4],), {}),
          ("normal", (), dict(mean=1.0, std=2.0, shape=[3])),
          ("uniform", ([2, 3],), dict(min=-2.0, max=2.0)),
          ("randint", (0, 5), dict(shape=[3])),
          ("randperm", (6,), {})]


@pytest.mark.parametrize("name,args,kwargs", RANDOM,
                         ids=[r[0] for r in RANDOM])
def test_random_op_shapes_dtypes_and_seed(name, args, kwargs):
    want = getattr(R, name)(*args, **kwargs)
    P.seed(7)
    a = getattr(P, name)(*args, **kwargs)
    b = getattr(P, name)(*args, **kwargs)
    P.seed(7)
    a2 = getattr(P, name)(*args, **kwargs)
    P.seed(8)
    c = getattr(P, name)(*args, **kwargs)
    assert a.shape == list(want.shape)
    assert P.core.dtypes.dtype_name(a.dtype) == str(np.dtype(want.dtype))
    np.testing.assert_array_equal(a.numpy(), a2.numpy())
    assert not np.array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), c.numpy())


def test_random_distributions():
    P.seed(1)
    n = 20000
    u = P.uniform([n], min=-2.0, max=2.0).numpy()
    assert u.min() >= -2.0 and u.max() < 2.0 and abs(u.mean()) < 0.05
    g = P.normal(1.0, 2.0, [n]).numpy()
    assert abs(g.mean() - 1.0) < 0.06 and abs(g.std() - 2.0) < 0.06
    r = P.randint(0, 5, [n]).numpy()
    assert set(np.unique(r)) == set(range(5))
    assert sorted(P.randperm(9).numpy().tolist()) == list(range(9))
    p = P.to_tensor(np.full([n], 0.3, np.float32))
    assert abs(P.bernoulli(p).numpy().mean() - 0.3) < 0.02
    lam = P.to_tensor(np.full([n], 3.0, np.float32))
    assert abs(P.poisson(lam).numpy().mean() - 3.0) < 0.08
    probs = P.to_tensor(np.array([0.1, 0.0, 0.9], np.float32))
    m = P.multinomial(probs, 2000, replacement=True).numpy()
    assert 1 not in m and abs((m == 2).mean() - 0.9) < 0.04
    x = P.zeros([n])
    P.normal_(x, 0.0, 3.0)
    assert abs(x.numpy().std() - 3.0) < 0.1
    P.uniform_(x, 0.0, 1.0)
    assert 0.45 < x.numpy().mean() < 0.55
    P.exponential_(x, 2.0)
    assert abs(x.numpy().mean() - 0.5) < 0.03
    y = P.zeros([n])
    P.bernoulli_(y, 0.25)
    assert abs(y.numpy().mean() - 0.25) < 0.02
    z = P.to_tensor(np.zeros([3, 4], np.int32))
    assert P.randint_like(z, 0, 3).dtype == P.int32
    assert P.rand_like(P.zeros([2, 2], "float64")).dtype == P.float64
    assert P.randn_like(P.zeros([2, 2])).shape == [2, 2]
    s1 = P.uniform([4], seed=11).numpy()
    s2 = P.uniform([4], seed=11).numpy()
    assert not np.array_equal(s1, s2)


# the families this slice ports and the matmul family of linalg
FAMILIES = ("paddle_tpu.ops.math", "paddle_tpu.ops.creation",
            "paddle_tpu.ops.reduction", "paddle_tpu.ops.logic",
            "paddle_tpu.ops.manipulation", "paddle_tpu.ops.random")
MATMUL_FAMILY = ("matmul", "mm", "bmm", "dot", "mv", "addmm", "einsum", "t")


def _family_of(name, opdef):
    """The module that defines the op: ``_helpers`` makes the table ops
    (``def_unary``/``def_binary``) for the module that calls it."""
    mod = opdef.fn.__module__
    if mod == "paddle_tpu.ops._helpers":
        return "paddle_tpu.ops.math" if name in vars(R.ops.math) else None
    return mod


def test_every_reference_op_of_the_families_exists_in_the_port():
    names = sorted(n for n, d in ref_registry.registered_ops().items()
                   if _family_of(n, d) in FAMILIES) + list(MATMUL_FAMILY)
    assert len(names) > 200
    missing = [n for n in names if not hasattr(P, n)]
    assert not missing, missing
    # ... and each Tensor method and in-place variant the reference
    # attaches for them
    methods = [d.method_name for n, d in ref_registry.registered_ops().items()
               if n in names and d.tensor_method]
    assert not [m for m in methods if not hasattr(P.Tensor, m)]
    tested = {c[1] for c in CASES} | {r[0] for r in RANDOM} | {
        "bernoulli", "bernoulli_", "poisson", "multinomial", "normal_",
        "uniform_", "exponential_", "randint_like", "rand_like",
        "randn_like"}
    assert not [n for n in names if n not in tested]
