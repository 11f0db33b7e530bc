"""Shape, layout and indexing ops (counterpart of
``paddle_tpu/ops/manipulation.py``).  Ops whose output shape depends on
the data (``nonzero``, ``unique``, ``masked_scatter``, ...) compute on the
host as the reference does; the rest run as PyTorch functions under
``apply_op``."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from .registry import register, register_op
from ._helpers import as_value, promote, targ, wrap


def _static_shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(v) for v in shape.numpy())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _int(v):
    return int(v.item()) if isinstance(v, Tensor) else int(v)


def _host(x) -> np.ndarray:
    v = as_value(x).detach()
    return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()


def _dev(x):
    return as_value(x).device


def _long(i):
    return i.to(torch.int64)


@register_op("reshape", category="manipulation", tensor_method=True,
             inplace_alias=True)
def reshape(x, shape, name=None):
    shp = _static_shape(shape)
    return apply_op("reshape", lambda v: torch.reshape(v, shp), (x,))


view = reshape
register("view", reshape, category="manipulation", tensor_method=True,
         method_name="view")


@register_op("transpose", category="manipulation", tensor_method=True)
def transpose(x, perm=None, name=None):
    if perm is None:
        perm = list(range(as_value(x).dim()))[::-1]
    perm = tuple(int(p) for p in perm)
    return apply_op("transpose", lambda v: v.permute(perm), (x,))


@register_op("moveaxis", category="manipulation", tensor_method=True)
def moveaxis(x, source, destination, name=None):
    return apply_op("moveaxis",
                    lambda v: torch.movedim(v, source, destination), (x,))


@register_op("swapaxes", category="manipulation", tensor_method=True)
def swapaxes(x, axis1, axis2, name=None):
    return apply_op("swapaxes",
                    lambda v: torch.swapaxes(v, axis1, axis2), (x,))


register("swapdims", swapaxes, tensor_method=True, method_name="swapdims")


@register_op("flatten", category="manipulation", tensor_method=True,
             inplace_alias=True)
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def fn(v):
        nd = v.dim()
        if nd == 0:
            return v.reshape(1)
        s, e = start_axis % nd, stop_axis % nd
        return v.reshape(tuple(v.shape[:s]) + (-1,) + tuple(v.shape[e + 1:]))
    return apply_op("flatten", fn, (x,))


@register_op("squeeze", category="manipulation", tensor_method=True,
             inplace_alias=True)
def squeeze(x, axis=None, name=None):
    def fn(v):
        if axis is None:
            return v.squeeze()
        ax = axis if isinstance(axis, (list, tuple)) else [axis]
        ax = tuple(a % v.dim() for a in ax if v.shape[a % v.dim()] == 1)
        return v.squeeze(ax) if ax else v.clone()
    return apply_op("squeeze", fn, (x,))


@register_op("unsqueeze", category="manipulation", tensor_method=True,
             inplace_alias=True)
def unsqueeze(x, axis, name=None):
    def fn(v):
        ax = axis if isinstance(axis, (list, tuple)) else [axis]
        out = v
        for a in sorted(_int(a) for a in ax):
            out = out.unsqueeze(a)
        return out
    return apply_op("unsqueeze", fn, (x,))


@register_op("concat", category="manipulation")
def concat(x, axis=0, name=None):
    ax = _int(axis)
    return apply_op("concat", lambda *vs: torch.cat(promote(*vs), ax),
                    tuple(targ(t) for t in x))


register("concatenate", concat)


@register_op("stack", category="manipulation")
def stack(x, axis=0, name=None):
    return apply_op("stack", lambda *vs: torch.stack(promote(*vs),
                                                     int(axis)),
                    tuple(targ(t) for t in x))


@register_op("split", category="manipulation", tensor_method=True)
def split(x, num_or_sections, axis=0, name=None):
    ax = _int(axis)
    n = as_value(x).shape[ax]
    if isinstance(num_or_sections, int):
        if n % num_or_sections != 0:
            raise ValueError(
                "split: axis dim %d is not divisible by num_or_sections=%d"
                % (n, num_or_sections))
        sizes = [n // num_or_sections] * num_or_sections
    else:
        sizes = [int(s) for s in num_or_sections]
        neg = [i for i, s in enumerate(sizes) if s < 0]
        if neg:
            sizes[neg[0]] = n - builtins.sum(s for s in sizes if s >= 0)
    return list(apply_op("split", lambda v: tuple(
        t.clone() for t in torch.split(v, sizes, ax)), (x,)))


@register_op("chunk", category="manipulation", tensor_method=True)
def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


@register_op("unbind", category="manipulation", tensor_method=True)
def unbind(x, axis=0, name=None):
    return list(apply_op("unbind", lambda v: tuple(
        t.clone() for t in torch.unbind(v, axis)), (x,)))


register("unstack", unbind)


@register_op("tile", category="manipulation", tensor_method=True)
def tile(x, repeat_times, name=None):
    reps = _static_shape(repeat_times)
    return apply_op("tile", lambda v: torch.tile(v, reps), (x,))


@register_op("expand", category="manipulation", tensor_method=True)
def expand(x, shape, name=None):
    shp = _static_shape(shape)

    def fn(v):
        tgt = tuple(v.shape[i - (len(shp) - v.dim())] if s == -1 else s
                    for i, s in enumerate(shp))
        return torch.broadcast_to(v, tgt).clone()
    return apply_op("expand", fn, (x,))


@register_op("expand_as", category="manipulation", tensor_method=True)
def expand_as(x, y, name=None):
    tgt = tuple(as_value(y).shape)
    return apply_op("expand_as",
                    lambda v: torch.broadcast_to(v, tgt).clone(), (x,))


@register_op("broadcast_to", category="manipulation", tensor_method=True)
def broadcast_to(x, shape, name=None):
    return expand(x, shape)


@register_op("broadcast_tensors", category="manipulation")
def broadcast_tensors(inputs, name=None):
    return list(apply_op("broadcast_tensors", lambda *vs: tuple(
        t.clone() for t in torch.broadcast_tensors(*vs)), tuple(inputs)))


@register_op("flip", category="manipulation", tensor_method=True)
def flip(x, axis, name=None):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return apply_op("flip", lambda v: torch.flip(v, ax), (x,))


@register_op("rot90", category="manipulation", tensor_method=True)
def rot90(x, k=1, axes=(0, 1), name=None):
    return apply_op("rot90", lambda v: torch.rot90(v, k, list(axes)), (x,))


@register_op("roll", category="manipulation", tensor_method=True)
def roll(x, shifts, axis=None, name=None):
    def fn(v):
        if axis is None:
            return torch.roll(v.reshape(-1), shifts).reshape(v.shape)
        return torch.roll(v, shifts, axis)
    return apply_op("roll", fn, (x,))


@register_op("gather", category="manipulation", tensor_method=True)
def gather(x, index, axis=0, name=None):
    ax = _int(axis)

    def fn(v, idx):
        idx = _long(idx.reshape(-1) if idx.dim() > 1 else idx)
        out = torch.index_select(v, ax, idx.reshape(-1))
        return out.squeeze(ax) if idx.dim() == 0 else out
    return apply_op("gather", fn, (x, targ(index)))


def _nd_index(idx):
    return tuple(_long(i) for i in torch.movedim(idx, -1, 0))


@register_op("gather_nd", category="manipulation", tensor_method=True)
def gather_nd(x, index, name=None):
    return apply_op("gather_nd", lambda v, idx: v[_nd_index(idx)],
                    (x, targ(index)))


@register_op("scatter", category="manipulation", tensor_method=True,
             inplace_alias=True)
def scatter(x, index, updates, overwrite=True, name=None):
    def fn(v, idx, upd):
        idx = _long(idx.reshape(-1))
        upd = upd.to(v.dtype)
        if overwrite:
            return v.index_put((idx,), upd)
        zeroed = v.index_put((idx,), torch.zeros_like(upd))
        return zeroed.index_put((idx,), upd, accumulate=True)
    return apply_op("scatter", fn, (x, targ(index), targ(updates)))


@register_op("scatter_nd_add", category="manipulation", tensor_method=True)
def scatter_nd_add(x, index, updates, name=None):
    return apply_op("scatter_nd_add", lambda v, idx, upd: v.index_put(
        _nd_index(idx), upd.to(v.dtype), accumulate=True),
        (x, targ(index), targ(updates)))


@register_op("scatter_nd", category="manipulation")
def scatter_nd(index, updates, shape, name=None):
    shp = _static_shape(shape)

    def fn(idx, upd):
        return torch.zeros(shp, dtype=upd.dtype, device=upd.device
                           ).index_put(_nd_index(idx), upd, accumulate=True)
    return apply_op("scatter_nd", fn, (targ(index), targ(updates)))


@register_op("index_select", category="manipulation", tensor_method=True)
def index_select(x, index, axis=0, name=None):
    return apply_op("index_select", lambda v, i: torch.index_select(
        v, int(axis), _long(i)), (x, targ(index)))


@register_op("index_sample", category="manipulation", tensor_method=True)
def index_sample(x, index, name=None):
    return apply_op("index_sample", lambda v, i: torch.gather(
        v, 1, _long(i)), (x, targ(index)))


@register_op("index_add", category="manipulation", tensor_method=True,
             inplace_alias=True)
def index_add(x, index, axis, value, name=None):
    return apply_op("index_add", lambda v, idx, val: torch.index_add(
        v, axis, _long(idx), val.to(v.dtype)),
        (x, targ(index), targ(value)))


@register_op("index_put", category="manipulation", tensor_method=True,
             inplace_alias=True)
def index_put(x, indices, value, accumulate=False, name=None):
    def fn(v, val, *idx):
        idx = tuple(i if i.dtype == torch.bool else _long(i) for i in idx)
        return v.index_put(idx, val.to(v.dtype), accumulate=accumulate)
    return apply_op("index_put", fn,
                    (x, targ(value)) + tuple(targ(i) for i in indices))


def _take_along(v, i, axis):
    i = _long(i)
    shape = list(np.broadcast_shapes(
        tuple(s for d, s in enumerate(v.shape) if d != axis % v.dim()),
        tuple(s for d, s in enumerate(i.shape) if d != axis % v.dim())))
    shape.insert(axis % v.dim(), None)
    vs = [v.shape[axis % v.dim()] if s is None else s for s in shape]
    is_ = [i.shape[axis % v.dim()] if s is None else s for s in shape]
    return v.expand(vs), i.expand(is_)


@register_op("take_along_axis", category="manipulation", tensor_method=True)
def take_along_axis(x, indices, axis, broadcast=True, name=None):
    def fn(v, i):
        v, i = _take_along(v, i, axis)
        return torch.gather(v, axis, i)
    return apply_op("take_along_axis", fn, (x, targ(indices)))


@register_op("put_along_axis", category="manipulation", tensor_method=True,
             inplace_alias=True)
def put_along_axis(x, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    def fn(v, idx, val):
        idx = _long(idx)
        val = torch.broadcast_to(val.to(v.dtype), idx.shape) if broadcast \
            else val.to(v.dtype)
        if reduce == "assign":
            return torch.scatter(v, axis, idx, val)
        mode = {"add": "sum", "multiply": "prod", "mul": "prod",
                "amin": "amin", "amax": "amax"}[reduce]
        return torch.scatter_reduce(v, axis, idx, val, mode,
                                    include_self=True)
    return apply_op("put_along_axis", fn,
                    (x, targ(indices), targ(values)))


@register_op("take", category="manipulation", tensor_method=True)
def take(x, index, mode="raise", name=None):
    def fn(v, i):
        flat = v.reshape(-1)
        n = flat.shape[0]
        i = _long(i)
        j = torch.remainder(i, n) if mode == "wrap" else torch.clamp(
            i, 0, n - 1)
        return flat[j.reshape(-1)].reshape(i.shape)
    return apply_op("take", fn, (x, targ(index)))


@register_op("masked_select", category="manipulation", tensor_method=True)
def masked_select(x, mask, name=None):
    v = as_value(x)
    m = torch.broadcast_to(as_value(mask).to(v.device), v.shape)
    return apply_op("masked_select", lambda t, mm: t[mm], (x, m))


@register_op("masked_fill", category="manipulation", tensor_method=True,
             inplace_alias=True)
def masked_fill(x, mask, value, name=None):
    def fn(v, m, val):
        v2, val = promote(v, val)
        return torch.where(m.to(torch.bool), val, v2)
    return apply_op("masked_fill", fn, (x, targ(mask), targ(value)))


@register_op("masked_scatter", category="manipulation", tensor_method=True,
             inplace_alias=True)
def masked_scatter(x, mask, value, name=None):
    v = _host(x).copy()
    m = np.broadcast_to(_host(mask).astype(bool), v.shape)
    vals = _host(value).reshape(-1)
    v[m] = vals[: int(m.sum())]
    return wrap(torch.from_numpy(v).to(_dev(x), as_value(x).dtype))


@register_op("where", category="manipulation", tensor_method=True)
def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)

    def fn(c, a, b):
        a, b = promote(a, b)
        return torch.where(c.to(torch.bool), a, b)
    return apply_op("where", fn, (targ(condition), targ(x), targ(y)))


@register_op("nonzero", category="manipulation", tensor_method=True)
def nonzero(x, as_tuple=False, name=None):
    nz = np.nonzero(_host(x))
    dev = _dev(x)
    if as_tuple:
        return tuple(wrap(torch.from_numpy(i[:, None].astype(np.int64)).to(
            dev)) for i in nz)
    return wrap(torch.from_numpy(np.stack(nz, -1).astype(np.int64)).to(dev))


@register_op("sort", category="manipulation", tensor_method=True)
def sort(x, axis=-1, descending=False, stable=False, name=None):
    def fn(v):
        out = torch.sort(v, dim=axis, stable=True).values
        return torch.flip(out, (axis,)) if descending else out
    return apply_op("sort", fn, (x,))


@register_op("argsort", category="manipulation", tensor_method=True)
def argsort(x, axis=-1, descending=False, stable=False, name=None):
    def fn(v):
        out = torch.sort(v, dim=axis, stable=True).indices
        return torch.flip(out, (axis,)) if descending else out
    return apply_op("argsort", fn, (x,))


@register_op("topk", category="manipulation", tensor_method=True)
def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    kk = _int(k)

    def fn(v):
        vals, idx = torch.topk(v, kk, dim=axis, largest=largest,
                               sorted=True)
        return vals, idx.to(torch.int64)
    return apply_op("topk", fn, (x,))


@register_op("searchsorted", category="manipulation")
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    def fn(s, v):
        s, v = promote(s, v)
        return torch.searchsorted(s, v, right=right, out_int32=out_int32)
    return apply_op("searchsorted", fn,
                    (targ(sorted_sequence), targ(values)))


@register_op("bucketize", category="manipulation", tensor_method=True)
def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


@register_op("unique", category="manipulation", tensor_method=True)
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    res = np.unique(_host(x), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    dev, d = _dev(x), as_value(x).dtype
    if not isinstance(res, tuple):
        return wrap(torch.from_numpy(res).to(dev, d))
    outs = [torch.from_numpy(res[0]).to(dev, d)] + [
        torch.from_numpy(np.asarray(r)).to(dev) for r in res[1:]]
    return tuple(wrap(o) for o in outs)


@register_op("unique_consecutive", category="manipulation", tensor_method=True)
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    v = _host(x)
    if axis is not None:
        raise NotImplementedError("unique_consecutive with axis")
    v = v.reshape(-1)
    change = np.concatenate([[True], v[1:] != v[:-1]])
    dev, d = _dev(x), as_value(x).dtype
    rets = [wrap(torch.from_numpy(v[change].copy()).to(dev, d))]
    if return_inverse:
        rets.append(wrap(torch.from_numpy(
            (np.cumsum(change) - 1).astype(np.int64)).to(dev)))
    if return_counts:
        idx = np.nonzero(change)[0]
        counts = np.diff(np.concatenate([idx, [len(v)]])).astype(np.int64)
        rets.append(wrap(torch.from_numpy(counts).to(dev)))
    return rets[0] if len(rets) == 1 else tuple(rets)


@register_op("repeat_interleave", category="manipulation", tensor_method=True)
def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, Tensor):
        r = _long(repeats._value)
        return apply_op("repeat_interleave", lambda v: torch.repeat_interleave(
            v.reshape(-1) if axis is None else v, r.to(v.device),
            dim=0 if axis is None else axis), (x,))
    return apply_op("repeat_interleave", lambda v: torch.repeat_interleave(
        v.reshape(-1) if axis is None else v, repeats,
        dim=0 if axis is None else axis), (x,))


@register_op("pad", category="manipulation")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",
        pad_from_left_axis=True, name=None):
    pad_list = _static_shape(pad) if not isinstance(pad, (list, tuple)) \
        else [_int(p) for p in pad]

    def fn(v):
        nd = v.dim()
        if len(pad_list) == 2 * nd:
            pairs = [(pad_list[2 * i], pad_list[2 * i + 1])
                     for i in range(nd)]
        else:
            k = len(pad_list) // 2
            pairs = [(0, 0)] * nd
            spatial = list(range(2, 2 + k)) if data_format.startswith("NC") \
                else list(range(1, 1 + k))
            for i, d in enumerate(reversed(spatial)):
                pairs[d] = (pad_list[2 * i], pad_list[2 * i + 1])
        flat = []
        for lo, hi in reversed(pairs):
            flat += [lo, hi]
        if mode == "constant":
            return torch.nn.functional.pad(v, flat, value=value)
        tmode = {"reflect": "reflect", "replicate": "replicate",
                 "circular": "circular"}[mode]
        # torch pads only the trailing dims of a batched input
        live = [d for d, p in enumerate(pairs) if p != (0, 0)]
        lead = live[0] if live else nd
        n_tail = nd - lead
        sq = v.reshape((-1,) + tuple(v.shape[lead:])).unsqueeze(0) \
            if lead > 0 else v.reshape((1, 1) + tuple(v.shape))
        out = torch.nn.functional.pad(sq, flat[:2 * n_tail], mode=tmode)
        return out.reshape(tuple(v.shape[:lead]) + tuple(out.shape[-n_tail:]))
    return apply_op("pad", fn, (x,))


@register_op("slice", category="manipulation")
def slice(input, axes, starts, ends, name=None):
    def fn(v):
        sl = [builtins.slice(None)] * v.dim()
        for ax, s, e in zip(axes, starts, ends):
            n = v.shape[ax]
            s, e = _int(s), _int(e)
            s = builtins.max(builtins.min(s + n if s < 0 else s, n), 0)
            e = builtins.max(builtins.min(e + n if e < 0 else e, n), 0)
            sl[ax] = builtins.slice(s, e)
        return v[tuple(sl)].clone()
    return apply_op("slice", fn, (input,))


@register_op("strided_slice", category="manipulation")
def strided_slice(x, axes, starts, ends, strides, name=None):
    def fn(v):
        sl = [builtins.slice(None)] * v.dim()
        flips = []
        for ax, s, e, st in zip(axes, starts, ends, strides):
            s, e, st = int(s), int(e), int(st)
            if st > 0:
                sl[ax] = builtins.slice(s, e, st)
            else:
                # torch slices take no negative step: index explicitly
                idx = np.arange(v.shape[ax])[s:e:st]
                flips.append((ax, torch.as_tensor(idx, device=v.device)))
        out = v[tuple(sl)]
        for ax, idx in flips:
            out = torch.index_select(out, ax, idx)
        return out.clone()
    return apply_op("strided_slice", fn, (x,))


@register_op("crop", category="manipulation")
def crop(x, shape=None, offsets=None, name=None):
    shp = _static_shape(shape)
    offs = _static_shape(offsets) if offsets is not None else (0,) * len(shp)

    def fn(v):
        sl = tuple(builtins.slice(o, o + (s if s != -1 else v.shape[i] - o))
                   for i, (o, s) in enumerate(zip(offs, shp)))
        return v[sl].clone()
    return apply_op("crop", fn, (x,))


@register_op("shard_index", category="manipulation")
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    """``paddle.shard_index`` (the distributed embedding's index map)."""
    size = (index_num + nshards - 1) // nshards

    def fn(v):
        shard = torch.div(v, size, rounding_mode="floor")
        local = torch.remainder(v, size)
        return torch.where(shard == shard_id, local,
                           torch.full_like(v, ignore_value))
    return apply_op("shard_index", fn, (input,))


@register_op("kron", category="manipulation", tensor_method=True)
def kron(x, y, name=None):
    return apply_op("kron", lambda a, b: torch.kron(*promote(a, b)),
                    (x, targ(y)))


@register_op("view_as", category="manipulation", tensor_method=True)
def view_as(x, other, name=None):
    shp = tuple(as_value(other).shape)
    return apply_op("view_as", lambda v: v.reshape(shp), (x,))


@register_op("as_strided", category="manipulation", tensor_method=True)
def as_strided(x, shape, stride, offset=0, name=None):
    # a host-side copy with no gradient, as the reference's
    v = as_value(x).detach().contiguous()
    return wrap(torch.as_strided(v, tuple(shape), tuple(stride),
                                 offset).clone())


@register_op("tensordot", category="manipulation")
def tensordot(x, y, axes=2, name=None):
    def fn(a, b):
        ax = axes
        if isinstance(ax, (list, tuple)) and len(ax) == 2 and all(
                isinstance(t, (list, tuple)) for t in ax):
            ax = (list(ax[0]), list(ax[1]))
        return torch.tensordot(*promote(a, b), dims=ax)
    return apply_op("tensordot", fn, (x, targ(y)))


def _atleast(name, tfn):
    def op(*inputs, name=None):
        outs = [apply_op(name_, lambda v: tfn(v).clone(), (targ(t),))
                for t in inputs]
        return outs[0] if len(outs) == 1 else outs
    name_ = name
    op.__name__ = op.__qualname__ = name
    register(name, op, category="manipulation")
    return op


atleast_1d = _atleast("atleast_1d", torch.atleast_1d)
atleast_2d = _atleast("atleast_2d", torch.atleast_2d)
atleast_3d = _atleast("atleast_3d", torch.atleast_3d)


@register_op("block_diag", category="manipulation")
def block_diag(inputs, name=None):
    """``paddle.block_diag``: the block-diagonal matrix of 2-D (or
    promotable) tensors."""
    return apply_op("block_diag", lambda *vs: torch.block_diag(
        *promote(*(torch.atleast_2d(v) for v in vs))), tuple(inputs))


@register_op("pdist", category="manipulation")
def pdist(x, p=2.0, name=None):
    """``paddle.pdist``: condensed pairwise p-distances of the rows."""
    def fn(v):
        n = v.shape[0]
        iu, ju = torch.triu_indices(n, n, 1, device=v.device)
        d = v[iu] - v[ju]
        if p == 2.0:
            return torch.sqrt(torch.sum(d * d, dim=-1))
        if p == float("inf"):
            return torch.amax(torch.abs(d), dim=-1)
        return torch.sum(torch.abs(d) ** p, dim=-1) ** (1.0 / p)
    return apply_op("pdist", fn, (x,))


@register_op("cartesian_prod", category="manipulation")
def cartesian_prod(x, name=None):
    """``paddle.cartesian_prod`` of 1-D tensors (itertools order)."""
    def fn(*vals):
        grids = torch.meshgrid(*promote(*vals), indexing="ij")
        return torch.stack([g.reshape(-1) for g in grids], dim=-1)
    return apply_op("cartesian_prod", fn, tuple(x))


@register_op("positive", category="math", tensor_method=True)
def positive(x, name=None):
    """``paddle.positive`` (+x; a bool tensor raises, as the reference's
    does)."""
    if as_value(x).dtype == torch.bool:
        raise TypeError("positive is not supported for bool tensors")
    return apply_op("positive", lambda v: v.clone(), (x,))


def _stacker(name, tfn):
    def op(x, name=None):
        return apply_op(name_, lambda *vs: tfn(promote(*vs)),
                        tuple(targ(t) for t in x))
    name_ = name
    op.__name__ = op.__qualname__ = name
    register(name, op, category="manipulation")
    return op


hstack = _stacker("hstack", torch.hstack)
vstack = _stacker("vstack", torch.vstack)
dstack = _stacker("dstack", torch.dstack)
column_stack = _stacker("column_stack", torch.column_stack)
row_stack = vstack
register("row_stack", vstack, category="manipulation")
