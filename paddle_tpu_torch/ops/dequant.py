"""Dequant-on-use of the serving engine's int8 weights (the port's
counterpart of the dequant the reference's compiled steps trace from
``paddle_tpu/quantization/functional.py`` ``dequantize_param_tree``).

Kernel: ``csrc/dequant_int8.cu``.  It replaces no Pallas kernel: the
reference dequantizes its whole int8 tree inside each compiled step and
XLA fuses the expression into the matmuls.  The port runs its steps
eagerly, so :class:`Int8Weights` keeps each decoder layer's seven
quantized weights (a Llama layer's projections; a Mixtral layer's four
attention projections and three expert banks, each expert stored
transposed so that its per-column scales fall on rows, the kernel's one
scale a row) as ONE contiguous int8 buffer with ONE fp32 scale
buffer, and before a layer runs, one launch writes the layer's weights in
the model dtype into a scratch buffer that every layer reuses (one more
launch for the LM head).  The matmuls stay ``F.linear``.  The model's
own parameters are never written, and no whole fp tree is ever held.

Bound on the H100: bytes.  One pass reads each code once and writes each
output once (3 bytes an element in bf16); the expression in torch would
take three passes through an fp32 intermediate.

Bit identity: the kernel computes ``q * (scale / 127)`` in fp32 with an
IEEE division and product and rounds to nearest even, so it equals
:func:`_dequant_int8_plain` (``quantization.functional.
dequantize_weight``, whose division is elementwise between tensors and so
correctly rounded on the card too) bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import _build
from ..models.llama import inner_model
from ..quantization.functional import (WEIGHT_SCALE_SUFFIX,
                                       dequantize_weight, ptq_quantizable,
                                       quantize_param_tree)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SEGMENTS = 8


def _dequant_int8_plain(codes: torch.Tensor, scales: torch.Tensor,
                        segments: Sequence[Tuple[int, int]],
                        out: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: each ``[rows, cols]`` segment of
    ``codes`` through :func:`dequantize_weight` with its rows' scales (an
    expert bank's segment holds its experts transposed, so this is the
    bank's own expression, transposed)."""
    e = r = 0
    for rows, cols in segments:
        q = codes[e:e + rows * cols].view(rows, cols)
        out[e:e + rows * cols].view(rows, cols).copy_(
            dequantize_weight(q, scales[r:r + rows], out.dtype))
        e += rows * cols
        r += rows
    return out


def _entry():
    fn = _build.load("dequant_int8").ptt_dequant_int8
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def dequant_int8(codes: torch.Tensor, scales: torch.Tensor,
                 segments: Sequence[Tuple[int, int]],
                 out: torch.Tensor) -> torch.Tensor:
    """Dequantize ``codes`` (int8, 1-D, the row-major ``[rows, cols]``
    weights of ``segments`` back to back) with one fp32 scale a row
    (``scales``, 1-D) into ``out`` (float32 or bfloat16, at least as long
    as ``codes``), in place; returns ``out``.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  ``.launches`` counts the launches."""
    segments = [(int(r), int(c)) for r, c in segments]
    n = sum(r * c for r, c in segments)
    rows = sum(r for r, _ in segments)
    if (codes.dtype != torch.int8 or scales.dtype != torch.float32
            or out.dtype not in _DTYPE_CODE):
        raise ValueError("dequant_int8: codes int8, scales float32, out "
                         "float32/bfloat16; got %s %s %s"
                         % (codes.dtype, scales.dtype, out.dtype))
    if (codes.ndim != 1 or scales.ndim != 1 or out.ndim != 1
            or codes.numel() != n or scales.numel() != rows
            or out.numel() < n or not segments
            or min(min(s) for s in segments) < 1):
        raise ValueError("dequant_int8: segments %s need 1-D codes of %d, "
                         "scales of %d and out of >= %d elements; got %s %s "
                         "%s" % (segments, n, rows, n, tuple(codes.shape),
                                 tuple(scales.shape), tuple(out.shape)))
    if codes.device.type == "cpu":
        return _dequant_int8_plain(codes, scales, segments, out)
    if codes.device.type != "cuda":
        raise ValueError("dequant_int8: unsupported device %s"
                         % codes.device)
    if len(segments) > MAX_SEGMENTS:
        raise ValueError("dequant_int8: at most %d segments a launch; got "
                         "%d" % (MAX_SEGMENTS, len(segments)))
    for name, t in (("codes", codes), ("scales", scales), ("out", out)):
        if t.device != codes.device or not t.is_contiguous():
            raise ValueError("dequant_int8: %s must be a contiguous tensor "
                             "on %s" % (name, codes.device))
    seg = (ctypes.c_longlong * (2 * len(segments)))(
        *[v for s in segments for v in s])
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    code = _entry()(codes.data_ptr(), scales.data_ptr(), out.data_ptr(), seg,
                    len(segments), _DTYPE_CODE[out.dtype], stream)
    _build.check(code, "dequant_int8")
    dequant_int8.launches += 1
    return out


dequant_int8.launches = 0

# a decoder layer's projections, in buffer order: (module path, name)
LAYER_PROJECTIONS = (("self_attn", "q_proj"), ("self_attn", "k_proj"),
                     ("self_attn", "v_proj"), ("self_attn", "o_proj"),
                     ("mlp", "gate_proj"), ("mlp", "up_proj"),
                     ("mlp", "down_proj"))
# a Mixtral layer's: the attention's, then the three expert banks (the
# router stays fp, as in the reference)
MOE_LAYER_PROJECTIONS = LAYER_PROJECTIONS[:4] + (
    ("block_sparse_moe", "w_gate"), ("block_sparse_moe", "w_up"),
    ("block_sparse_moe", "w_down"))


def layer_weights(layer) -> List[Tuple[str, torch.Tensor]]:
    """``(parameter suffix, weight)`` of each quantized weight of a layer,
    in buffer order: ``self_attn.q_proj.weight`` for a projection,
    ``block_sparse_moe.w_gate`` for an expert bank."""
    projections = (MOE_LAYER_PROJECTIONS
                   if hasattr(layer, "block_sparse_moe")
                   else LAYER_PROJECTIONS)
    out = []
    for mod, name in projections:
        t = getattr(getattr(layer, mod), name)
        if isinstance(t, torch.nn.Parameter):          # an expert bank
            out.append(("%s.%s" % (mod, name), t))
        else:
            out.append(("%s.%s.weight" % (mod, name), t.weight))
    return out


def _segment(shape) -> Tuple[int, int]:
    """The ``[rows, cols]`` a weight takes in a group, one scale a row: a
    2-D ``[out, in]`` weight as it is, an expert bank ``[E, in, out]`` as
    ``[E * out, in]`` (each expert transposed, so that its per-column
    scales fall on rows)."""
    if len(shape) == 2:
        return shape
    E, n_in, n_out = shape
    return E * n_out, n_in


class _Group:
    """One launch's worth of weights: the int8 codes and fp32 scales of
    ``keys`` back to back (an expert bank's codes transposed per expert to
    ``[E, out, in]``), their ``[rows, cols]`` segments, and the element
    offset of each weight."""

    def __init__(self, qtree: Dict[str, torch.Tensor], keys: List[str]):
        self.keys = keys
        self.shapes = [tuple(qtree[k].shape) for k in keys]
        self.segments = [_segment(s) for s in self.shapes]
        self.codes = torch.cat([
            (qtree[k] if qtree[k].ndim == 2
             else qtree[k].transpose(1, 2)).reshape(-1) for k in keys])
        self.scales = torch.cat([qtree[k + WEIGHT_SCALE_SUFFIX].reshape(-1)
                                 for k in keys])
        self.offsets, e = [], 0
        for r, c in self.segments:
            self.offsets.append(e)
            e += r * c

    @property
    def numel(self) -> int:
        return self.codes.numel()

    def _views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Each weight of ``flat`` (laid out as the codes) in its own
        shape: ``[out, in]``, or a bank ``[E, in, out]`` (a transposed
        view of its ``[E, out, in]`` rows)."""
        out = []
        for o, shape, (r, c) in zip(self.offsets, self.shapes,
                                    self.segments):
            t = flat[o:o + r * c]
            out.append(t.view(r, c) if len(shape) == 2 else
                       t.view(shape[0], shape[2], shape[1]).transpose(1, 2))
        return out

    def dequant(self, scratch: torch.Tensor) -> List[torch.Tensor]:
        dequant_int8(self.codes, self.scales, self.segments, scratch)
        return self._views(scratch)

    def tree(self) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        r = 0
        for k, v, shape, (rows, _c) in zip(self.keys, self._views(
                self.codes), self.shapes, self.segments):
            out[k] = v
            sc = self.scales[r:r + rows]
            out[k + WEIGHT_SCALE_SUFFIX] = (
                sc if len(shape) == 2 else sc.view(shape[0], 1, shape[2]))
            r += rows
        return out


class Int8Weights:
    """The serving engine's int8 weight tree (``weight_quant="int8"``):
    the model's PTQ codes and scales (:func:`quantize_param_tree`, built
    once, one layer at a time), held per decoder layer as one contiguous
    int8 buffer and one fp32 scale buffer, with one scratch buffer in the
    model dtype that every layer's dequant reuses, and the LM head (when
    the model has an untied one) with a scratch of its own.  A Mixtral
    layer's group holds its four attention projections and its three
    expert banks (seven segments, one launch); its router stays fp.

    ``layer(i)`` launches layer ``i``'s dequant and returns its weights by
    name (``q_proj`` ... ``down_proj``, or ``w_gate``/``w_up``/``w_down``
    as ``[E, in, out]`` views; valid until the next ``layer`` call);
    ``lm_head()`` the LM head's, or None when it stays fp.  ``tree()`` is
    the PTQ tree itself (views of the buffers, the reference's keys and
    layouts); ``nbytes`` counts codes and scales.

    ``tp`` (a rank of a sharded engine, ``jit.spmd.TPContext``): the
    model is the rank's shard, and each row-sharded weight's scales take
    the max over the tp ranks, so the rank's codes and scales are the
    slice of the one-card tree by the PTQ tree's specs."""

    def __init__(self, model, tp=None):
        from ..quantization.functional import (ensure_quant_specs,
                                               tp_scale_reduce)
        reduce = tp_scale_reduce(tp)
        stack = inner_model(model)
        prefix = "mixtral" if stack is getattr(model, "mixtral", None) \
            else "llama"
        dtype = model.config.torch_dtype
        self.layers: List[_Group] = []
        self._names: List[List[str]] = []
        for i, layer in enumerate(stack.layers):
            weights = layer_weights(layer)
            vals = {"%s.layers.%d.%s" % (prefix, i, suffix): w.detach()
                    for suffix, w in weights}
            if not all(ptq_quantizable(k, v) for k, v in vals.items()):
                raise ValueError("a decoder layer's projections must all be "
                                 "2-D weights or 3-D expert banks")
            q = quantize_param_tree(vals, scale_reduce=reduce)
            ensure_quant_specs(tp, q)
            self.layers.append(_Group(q, list(vals)))
            self._names.append([suffix.split(".")[1]
                                for suffix, _w in weights])
        self.head = None
        if model.lm_head is not None:
            vals = {"lm_head.weight": model.lm_head.weight.detach()}
            q = quantize_param_tree(vals, scale_reduce=reduce)
            ensure_quant_specs(tp, q)
            self.head = _Group(q, list(vals))
        dev = stack.embed_tokens.weight.device
        self._scratch = torch.empty(max(g.numel for g in self.layers),
                                    dtype=dtype, device=dev)
        self._head_scratch = (None if self.head is None else
                              torch.empty(self.head.numel, dtype=dtype,
                                          device=dev))

    @property
    def nbytes(self) -> int:
        groups = self.layers + ([self.head] if self.head else [])
        return sum(g.codes.numel() + 4 * g.scales.numel() for g in groups)

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        ws = self.layers[i].dequant(self._scratch)
        return dict(zip(self._names[i], ws))

    def lm_head(self) -> Optional[torch.Tensor]:
        if self.head is None:
            return None
        return self.head.dequant(self._head_scratch)[0]

    def tree(self) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for g in self.layers + ([self.head] if self.head else []):
            out.update(g.tree())
        return out
