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


def _view(flat: torch.Tensor, shape) -> torch.Tensor:
    """A weight's codes or values laid out as in a group, in its own shape:
    ``[out, in]``, or a bank ``[E, in, out]`` (a transposed view of its
    ``[E, out, in]`` rows)."""
    if len(shape) == 2:
        return flat.view(shape)
    return flat.view(shape[0], shape[2], shape[1]).transpose(1, 2)


class _Group:
    """One launch's worth of weights: the int8 codes and fp32 scales of
    ``keys`` back to back (an expert bank's codes transposed per expert to
    ``[E, out, in]``), their ``[rows, cols]`` segments, and the element
    offset of each weight.

    ``fsdp`` (``(AxisComm, {key: dim or None})``, a rank of an fsdp mesh):
    of each weight whose codes split over fsdp on ``dim``, only this
    rank's slice is kept, the slices back to back in ``stored``; the rest
    (an expert bank) stay whole.  :meth:`dequant` then gathers the slices
    over the fsdp ranks into a codes scratch first (one all-gather)."""

    def __init__(self, qtree: Dict[str, torch.Tensor], keys: List[str],
                 fsdp=None):
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
        self.numel = e
        self.comm = None
        if fsdp is not None:
            self._keep_slices(*fsdp)

    def _keep_slices(self, comm, dims) -> None:
        F, i = comm.size, comm.index
        self.comm = comm
        self.sliced, self.resident, pieces, at = [], [], [], 0
        for k, o, (r, c) in zip(self.keys, self.offsets, self.segments):
            flat = self.codes[o:o + r * c]
            d = dims[k]
            if d is None:
                self.resident.append((k, o, flat.clone()))
                continue
            n = (r, c)[d] // F
            piece = flat.view(r, c).narrow(d, i * n, n).contiguous()
            self.sliced.append((k, o, (r, c), d, tuple(piece.shape), at))
            pieces.append(piece.reshape(-1))
            at += piece.numel()
        self.stored = (torch.cat(pieces) if pieces
                       else self.codes.new_empty(0))
        self.codes = None

    @property
    def code_bytes(self) -> int:
        """The int8 codes this rank keeps."""
        if self.comm is None:
            return self.codes.numel()
        return self.stored.numel() + sum(t.numel()
                                         for _k, _o, t in self.resident)

    def gathered_bytes(self) -> int:
        """Bytes one dequant receives over the fsdp ranks."""
        if self.comm is None:
            return 0
        return self.stored.numel() * (self.comm.size - 1)

    def _codes(self, codes_scratch, wire) -> torch.Tensor:
        """The group's whole codes: its own buffer, or under fsdp the
        slices gathered into ``codes_scratch`` through ``wire``."""
        if self.comm is None:
            return self.codes
        from ..jit.spmd import unslice
        F, n = self.comm.size, self.stored.numel()
        rows = wire[:F * n].view(F, n)
        self.comm.all_gather_rows(rows, self.stored)
        for _k, o, (r, c), d, shape, at in self.sliced:
            unslice(rows, at, shape, d, codes_scratch[o:o + r * c])
        for _k, o, t in self.resident:
            codes_scratch[o:o + t.numel()].copy_(t)
        return codes_scratch[:self.numel]

    def dequant(self, scratch: torch.Tensor, codes_scratch=None,
                wire=None) -> List[torch.Tensor]:
        dequant_int8(self._codes(codes_scratch, wire), self.scales,
                     self.segments, scratch)
        return [_view(scratch[o:o + r * c], shape) for o, shape, (r, c)
                in zip(self.offsets, self.shapes, self.segments)]

    def _kept_codes(self) -> Dict[str, torch.Tensor]:
        """Each weight's codes as this rank keeps them: whole, or under
        fsdp its slice."""
        if self.comm is None:
            return {k: _view(self.codes[o:o + r * c], shape)
                    for k, o, shape, (r, c) in zip(
                        self.keys, self.offsets, self.shapes,
                        self.segments)}
        shapes = dict(zip(self.keys, self.shapes))
        out = {k: self.stored[at:at + shape[0] * shape[1]].view(shape)
               for k, _o, _rc, _d, shape, at in self.sliced}
        out.update({k: _view(t, shapes[k]) for k, _o, t in self.resident})
        return out

    def tree(self) -> Dict[str, torch.Tensor]:
        codes = self._kept_codes()
        out: Dict[str, torch.Tensor] = {}
        r = 0
        for k, shape, (rows, _c) in zip(self.keys, self.shapes,
                                        self.segments):
            out[k] = codes[k]
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
    slice of the one-card tree by the PTQ tree's specs.  Under an fsdp
    axis each weight is first gathered to its tp compute shard (once, to
    quantize it), the rank keeps its fsdp slice of the codes, and each
    ``layer``/``lm_head`` call gathers the slices back into a codes scratch
    that every group reuses before its dequant (the reference's fsdp
    prologue over its int8 tree); ``param_names`` are the model parameters
    the tree stands in for."""

    def __init__(self, model, tp=None):
        from ..jit.spmd import _fsdp_dim, fsdp_gather, port_spec
        from ..quantization.functional import (ensure_quant_specs,
                                               tp_scale_reduce)
        reduce = tp_scale_reduce(tp)
        comm = tp.fsdp_comm if tp is not None else None
        stack = inner_model(model)
        prefix = "mixtral" if stack is getattr(model, "mixtral", None) \
            else "llama"
        dtype = model.config.torch_dtype

        def group(vals):
            dims = None
            if comm is not None:
                specs = {k: port_spec(k, tp.specs[k]) for k in vals}
                vals = {k: fsdp_gather(v, specs[k], comm)
                        for k, v in vals.items()}
                dims = {k: _fsdp_dim(specs[k], comm.name) for k in vals}
            q = quantize_param_tree(vals, scale_reduce=reduce)
            ensure_quant_specs(tp, q)
            return _Group(q, list(vals), None if comm is None
                          else (comm, dims))
        self.layers: List[_Group] = []
        self._names: List[List[str]] = []
        for i, layer in enumerate(stack.layers):
            weights = layer_weights(layer)
            vals = {"%s.layers.%d.%s" % (prefix, i, suffix): w.detach()
                    for suffix, w in weights}
            if not all(ptq_quantizable(k, v) for k, v in vals.items()):
                raise ValueError("a decoder layer's projections must all be "
                                 "2-D weights or 3-D expert banks")
            self.layers.append(group(vals))
            self._names.append([suffix.split(".")[1]
                                for suffix, _w in weights])
        self.head = None
        if model.lm_head is not None:
            self.head = group({"lm_head.weight":
                               model.lm_head.weight.detach()})
        groups = self.layers + ([self.head] if self.head else [])
        self.param_names = [k for g in groups for k in g.keys]
        dev = stack.embed_tokens.weight.device
        self._scratch = torch.empty(max(g.numel for g in self.layers),
                                    dtype=dtype, device=dev)
        self._head_scratch = (None if self.head is None else
                              torch.empty(self.head.numel, dtype=dtype,
                                          device=dev))
        self._codes = self._wire = None
        if comm is not None:
            self._codes = torch.empty(max(g.numel for g in groups),
                                      dtype=torch.int8, device=dev)
            self._wire = torch.empty(comm.size * max(
                g.stored.numel() for g in groups), dtype=torch.int8,
                device=dev)

    @property
    def nbytes(self) -> int:
        groups = self.layers + ([self.head] if self.head else [])
        return sum(g.code_bytes + 4 * g.scales.numel() for g in groups)

    def gathered_bytes(self) -> int:
        """Bytes one dispatch receives over the fsdp ranks (every group's
        codes once; 0 without fsdp)."""
        groups = self.layers + ([self.head] if self.head else [])
        return sum(g.gathered_bytes() for g in groups)

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        ws = self.layers[i].dequant(self._scratch, self._codes, self._wire)
        return dict(zip(self._names[i], ws))

    def lm_head(self) -> Optional[torch.Tensor]:
        if self.head is None:
            return None
        return self.head.dequant(self._head_scratch, self._codes,
                                 self._wire)[0]

    def tree(self) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for g in self.layers + ([self.head] if self.head else []):
            out.update(g.tree())
        return out
