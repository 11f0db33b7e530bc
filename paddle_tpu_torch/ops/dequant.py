"""Dequant-on-use of the serving engine's int8 weights (the port's
counterpart of the dequant the reference's compiled steps trace from
``paddle_tpu/quantization/functional.py`` ``dequantize_param_tree``).

Kernel: ``csrc/dequant_int8.cu``.  It replaces no Pallas kernel: the
reference dequantizes its whole int8 tree inside each compiled step and
XLA fuses the expression into the matmuls.  The port runs its steps
eagerly, so :class:`Int8Weights` keeps each decoder layer's seven
projection weights as ONE contiguous int8 buffer with ONE fp32 scale
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
from ..quantization.functional import (WEIGHT_SCALE_SUFFIX,
                                       dequantize_weight, ptq_quantizable,
                                       quantize_param_tree)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SEGMENTS = 8


def _dequant_int8_plain(codes: torch.Tensor, scales: torch.Tensor,
                        segments: Sequence[Tuple[int, int]],
                        out: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: each ``[rows, cols]`` segment of
    ``codes`` through :func:`dequantize_weight` with its rows' scales."""
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

# a decoder layer's projections, in buffer order: (module path, key)
LAYER_PROJECTIONS = (("self_attn", "q_proj"), ("self_attn", "k_proj"),
                     ("self_attn", "v_proj"), ("self_attn", "o_proj"),
                     ("mlp", "gate_proj"), ("mlp", "up_proj"),
                     ("mlp", "down_proj"))


class _Group:
    """One launch's worth of weights: the int8 codes and fp32 scales of
    ``keys`` back to back, their ``[rows, cols]`` segments, and the
    element offset of each weight."""

    def __init__(self, qtree: Dict[str, torch.Tensor], keys: List[str]):
        self.keys = keys
        self.segments = [tuple(qtree[k].shape) for k in keys]
        self.codes = torch.cat([qtree[k].reshape(-1) for k in keys])
        self.scales = torch.cat([qtree[k + WEIGHT_SCALE_SUFFIX]
                                 for k in keys])
        self.offsets, e = [], 0
        for r, c in self.segments:
            self.offsets.append(e)
            e += r * c

    @property
    def numel(self) -> int:
        return self.codes.numel()

    def dequant(self, scratch: torch.Tensor) -> List[torch.Tensor]:
        dequant_int8(self.codes, self.scales, self.segments, scratch)
        return [scratch[o:o + r * c].view(r, c)
                for o, (r, c) in zip(self.offsets, self.segments)]


class Int8Weights:
    """The serving engine's int8 weight tree (``weight_quant="int8"``):
    the model's PTQ codes and scales (:func:`quantize_param_tree`, built
    once, one layer at a time), held per decoder layer as one contiguous
    int8 buffer and one fp32 scale buffer, with one scratch buffer in the
    model dtype that every layer's dequant reuses, and the LM head (when
    the model has an untied one) with a scratch of its own.

    ``layer(i)`` launches layer ``i``'s dequant and returns its weights by
    projection name (views into the scratch, valid until the next
    ``layer`` call); ``lm_head()`` the LM head's, or None when it stays fp.
    ``tree()`` is the PTQ tree itself (views of the buffers, the
    reference's keys); ``nbytes`` counts codes and scales."""

    def __init__(self, model):
        llama = model.llama
        dtype = model.config.torch_dtype
        self.layers: List[_Group] = []
        for i, layer in enumerate(llama.layers):
            vals = {"llama.layers.%d.%s.%s.weight" % (i, mod, name):
                    getattr(getattr(layer, mod), name).weight.detach()
                    for mod, name in LAYER_PROJECTIONS}
            keys = list(vals)
            if not all(ptq_quantizable(k, v) for k, v in vals.items()):
                raise ValueError("a decoder layer's projections must all be "
                                 "2-D weights")
            self.layers.append(_Group(quantize_param_tree(vals), keys))
        self.head = None
        if model.lm_head is not None:
            vals = {"lm_head.weight": model.lm_head.weight.detach()}
            self.head = _Group(quantize_param_tree(vals), list(vals))
        dev = llama.embed_tokens.weight.device
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
        return {name: w for (_m, name), w in zip(LAYER_PROJECTIONS, ws)}

    def lm_head(self) -> Optional[torch.Tensor]:
        if self.head is None:
            return None
        return self.head.dequant(self._head_scratch)[0]

    def tree(self) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for g in self.layers + ([self.head] if self.head else []):
            r = 0
            for k, o, (rows, cols) in zip(g.keys, g.offsets, g.segments):
                out[k] = g.codes[o:o + rows * cols].view(rows, cols)
                out[k + WEIGHT_SCALE_SUFFIX] = g.scales[r:r + rows]
                r += rows
        return out
