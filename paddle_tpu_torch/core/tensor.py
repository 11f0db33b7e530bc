"""The eager Tensor (counterpart of ``paddle_tpu/core/tensor.py``).

A Tensor holds one ``torch.Tensor`` (``_value``), as the reference's holds
one ``jax.Array``; its autograd is torch's.  ``stop_gradient`` is the
reference's name for ``not requires_grad``: ``to_tensor`` gives True, a
``Parameter`` False, and an op's output stops when all of its inputs do
(torch's own rule).  Non-float tensors cannot require grad in torch; their
flag is kept on the wrapper and no gradient reaches them, as in the
reference, whose tape skips them.  ``.grad`` is the leaf's accumulated
gradient, summed across ``backward`` calls.  Most methods are attached by
the op library (``ops/_table.py``), as the reference attaches them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import dtypes as _dt
from .device import current_device, place_device, place_of


def _inexact(v: torch.Tensor) -> bool:
    return v.is_floating_point() or v.is_complex()


def value_from_data(data, dtype=None, device=None) -> torch.Tensor:
    """A ``torch.Tensor`` from user data with the reference's defaults
    (:func:`dtypes.default_cast`), on ``device`` (the current device when
    None)."""
    dev = current_device() if device is None else device
    if isinstance(data, Tensor):
        v = data._value.detach()
    elif isinstance(data, torch.Tensor):
        v = data.detach()
    else:
        if isinstance(data, (list, tuple)) and data and any(
                isinstance(x, Tensor) for x in data):
            data = [x.numpy() if isinstance(x, Tensor) else x for x in data]
        arr = _dt.default_cast(data)
        if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
            # an ml_dtypes bfloat16 array: its bits through a uint16 view
            v = torch.from_numpy(np.ascontiguousarray(arr).view(
                np.int16).copy()).view(torch.bfloat16)
        else:
            v = torch.from_numpy(np.array(arr, copy=True))
    v = v.to(dev)
    if dtype is not None:
        d = _dt.convert_dtype(dtype)
        if v.dtype != d:
            v = v.to(d)
    return v


class Tensor:
    """The paddle API's eager tensor over one ``torch.Tensor``."""

    _next_id = [0]

    def __init__(self, data=None, dtype=None, place=None, stop_gradient=True,
                 name=None):
        if data is None:
            data = np.zeros((), np.float32)
        self._value = value_from_data(
            data, dtype, None if place is None else place_device(place))
        self._sg = True
        self.stop_gradient = stop_gradient
        self.persistable = False
        self.trainable = not stop_gradient
        self._leaf = None
        if name is None:
            Tensor._next_id[0] += 1
            name = "generated_tensor_%d" % Tensor._next_id[0]
        self.name = name

    @classmethod
    def _from_value(cls, value: torch.Tensor) -> "Tensor":
        t = cls.__new__(cls)
        t._value = value
        t._sg = True
        t.persistable = False
        t.trainable = False
        t._leaf = None
        Tensor._next_id[0] += 1
        t.name = "generated_tensor_%d" % Tensor._next_id[0]
        return t

    # -- stop_gradient <-> requires_grad ---------------------------------
    @property
    def stop_gradient(self) -> bool:
        v = self._value
        return (not v.requires_grad) if _inexact(v) else self._sg

    @stop_gradient.setter
    def stop_gradient(self, flag):
        flag = bool(flag)
        self._sg = flag
        v = self._value
        if not _inexact(v) or v.requires_grad != flag:
            return
        if flag:
            # a non-leaf's edge is pruned by detaching it, as the
            # reference's engine skips a stop_gradient input
            if v.grad_fn is not None:
                self._value = v.detach()
            else:
                v.requires_grad_(False)
        elif v.grad_fn is None:
            v.requires_grad_(True)

    # -- metadata ---------------------------------------------------------
    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def ndim(self):
        return self._value.dim()

    dim = ndim

    @property
    def size(self):
        return int(self._value.numel())

    @property
    def place(self):
        return place_of(self._value.device)

    @property
    def device(self):
        return self._value.device

    @property
    def is_leaf(self) -> bool:
        return self._value.grad_fn is None

    def numel(self):
        return self.size

    def element_size(self):
        return self._value.element_size()

    # -- values -----------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """The values as numpy.  bf16 has no numpy dtype in torch, so a
        bf16 tensor comes back as float32 (exactly its values)."""
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            v = v.to(torch.float32)
        return v.cpu().numpy()

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._value.item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    # -- autograd ---------------------------------------------------------
    def _grad_holder(self) -> torch.Tensor:
        """The torch leaf this tensor's ``.grad`` lives on (the leaf it was
        before an in-place op rebound it)."""
        if self._leaf is not None and self._value.grad_fn is not None:
            return self._leaf
        return self._value

    @property
    def grad(self) -> Optional["Tensor"]:
        h = self._grad_holder()
        if h.grad_fn is not None or h.grad is None:
            return None
        return Tensor._from_value(h.grad)

    @grad.setter
    def grad(self, value):
        h = self._grad_holder()
        h.grad = None if value is None else (
            value._value if isinstance(value, Tensor)
            else torch.as_tensor(value, device=h.device))

    @property
    def _grad(self):
        h = self._grad_holder()
        return None if h.grad_fn is not None else h.grad

    def backward(self, grad_tensor=None, retain_graph=False):
        """Reverse accumulation from this tensor (reference:
        ``Tensor.backward``)."""
        from ..autograd.tape import run_backward
        run_backward([self], [grad_tensor], retain_graph=retain_graph)

    def clear_grad(self):
        self._grad_holder().grad = None

    def clear_gradient(self, set_to_zero=False):
        h = self._grad_holder()
        if set_to_zero and h.grad is not None:
            h.grad.zero_()
        else:
            h.grad = None

    def zero_grad(self):
        self.clear_grad()

    def register_hook(self, hook):
        """A hook on the gradient flowing into this tensor: it gets the
        gradient as a Tensor and may return a replacement."""
        def torch_hook(g):
            out = hook(Tensor._from_value(g))
            if out is None:
                return None
            return out._value if isinstance(out, Tensor) else out
        self._value.register_hook(torch_hook)
        return hook

    def detach(self) -> "Tensor":
        return Tensor._from_value(self._value.detach())

    def detach_(self):
        self.stop_gradient = True
        return self

    def clone(self) -> "Tensor":
        from .dispatch import apply_op
        return apply_op("clone", lambda v: v.clone(), (self,))

    def astype(self, dtype) -> "Tensor":
        from .dispatch import apply_op
        d = _dt.convert_dtype(dtype)
        return apply_op("cast", lambda v: v.to(d), (self,))

    def cast(self, dtype) -> "Tensor":
        return self.astype(dtype)

    def to(self, device=None, dtype=None, blocking=None):
        """A copy on ``device`` and/or in ``dtype`` (differentiable)."""
        from .dispatch import apply_op
        if isinstance(device, (str, torch.dtype)) and dtype is None:
            try:
                dtype, device = _dt.convert_dtype(device), None
            except ValueError:
                pass
        dev = None if device is None else place_device(device)
        d = _dt.convert_dtype(dtype)
        return apply_op("to", lambda v: v.to(device=dev, dtype=d), (self,))

    def cpu(self):
        return self.to("cpu")

    def cuda(self, device_id=None, blocking=True):
        return self.to("gpu" if device_id is None else "gpu:%d" % device_id)

    def pin_memory(self):
        return self

    # -- in-place updates ---------------------------------------------------
    def _inplace_assign(self, out: "Tensor"):
        """Rebind this tensor to ``out``'s value (the reference's in-place
        ops compute and rebind).  A parameter keeps its storage object
        (optimizers hold it) and takes the new data; a leaf that requires
        grad keeps receiving its pre-assignment gradient."""
        if isinstance(getattr(self, "_value", None), torch.nn.Parameter):
            self._value.data = out._value.detach()
            return self
        old = self._value
        if self._leaf is None and old.grad_fn is None and old.requires_grad \
                and out._value.grad_fn is not None:
            self._leaf = old
        self._value = out._value
        self._sg = out._sg
        return self

    def _set_data(self, v: torch.Tensor):
        """Replace the values, keeping the autograd flag, the accumulated
        gradient and (for a parameter) the storage object."""
        if isinstance(self._value, torch.nn.Parameter):
            with torch.no_grad():
                if self._value.shape == v.shape:
                    self._value.copy_(v)
                else:
                    self._value.data = v.detach().clone()
            return self
        old = self._value
        new = v.detach().to(old.device, old.dtype).clone()
        if old.grad_fn is None and old.requires_grad:
            new.requires_grad_(True)
            new.grad = old.grad
        self._value = new
        return self

    def set_value(self, value):
        if isinstance(value, Tensor):
            v = value._value
        elif isinstance(value, torch.Tensor):
            v = value
        else:
            v = value_from_data(value, device=self._value.device)
        if tuple(v.shape) != tuple(self._value.shape):
            raise ValueError("set_value shape mismatch: %s vs %s"
                             % (tuple(v.shape), tuple(self._value.shape)))
        return self._set_data(v.to(self._value.dtype))

    def get_tensor(self):
        return self

    def copy_(self, other, *a):
        return self.set_value(other)

    def fill_(self, value):
        return self._set_data(torch.full_like(self._value.detach(), value))

    def zero_(self):
        return self._set_data(torch.zeros_like(self._value.detach()))

    # -- printing ---------------------------------------------------------
    def __repr__(self):
        body = np.array2string(self.numpy(), **_print_options())
        return ("Tensor(shape=%s, dtype=%s, place=%s, stop_gradient=%s,\n"
                "       %s)" % (self.shape, _dt.dtype_name(self.dtype),
                                self.place, self.stop_gradient, body))

    __str__ = __repr__

    # -- python protocol --------------------------------------------------
    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    def __bool__(self):
        return bool(self._value.detach())

    def __int__(self):
        return int(self._value.detach())

    def __float__(self):
        return float(self._value.detach())

    def __index__(self):
        return int(self._value.detach())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __hash__(self):
        return id(self)

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return str(self)

    def ndimension(self):
        return self.ndim

    def contiguous(self):
        return self

    def is_contiguous(self):
        return True

    def apply_(self, func):
        if not self.stop_gradient:
            raise RuntimeError(
                "apply_ cannot be used on a tensor that requires grad")
        out = func(self)
        return self._set_data(out._value if isinstance(out, Tensor)
                              else torch.as_tensor(out))

    def apply(self, func):
        if not self.stop_gradient:
            raise RuntimeError(
                "apply cannot be used on a tensor that requires grad (the "
                "callable runs outside autograd)")
        out = func(self)
        return out if isinstance(out, Tensor) else Tensor(out)


_PRINT_OPTS = {"precision": 6, "threshold": 40, "edgeitems": 3,
               "linewidth": 75, "sci_mode": None}


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """``paddle.set_printoptions``."""
    for k, v in (("precision", precision), ("threshold", threshold),
                 ("edgeitems", edgeitems), ("sci_mode", sci_mode),
                 ("linewidth", linewidth)):
        if v is not None:
            _PRINT_OPTS[k] = v


def _print_options():
    opts = dict(precision=_PRINT_OPTS["precision"],
                threshold=_PRINT_OPTS["threshold"],
                edgeitems=_PRINT_OPTS["edgeitems"],
                max_line_width=_PRINT_OPTS["linewidth"])
    if _PRINT_OPTS["sci_mode"] is not None:
        p = _PRINT_OPTS["precision"]
        opts["formatter"] = {"float_kind": (
            (lambda x: "%.*e" % (p, x)) if _PRINT_OPTS["sci_mode"]
            else (lambda x: "%.*f" % (p, x)))}
    return opts


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """``paddle.to_tensor``: a new leaf on ``place`` (the current device
    when None: the card unless ``set_device("cpu")``)."""
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)
