"""``nn.Layer`` and ``nn.Parameter`` (counterpart of
``paddle_tpu/nn/layer_base.py``).

``Layer`` is a ``torch.nn.Module``.  An API ``Parameter`` is a Tensor whose
value is a real ``torch.nn.Parameter``, registered on the module under
the attribute's name, so the module's structured names are the
reference's (``blocks.0.attn.q_proj.weight``), ``state_dict`` has the
reference's keys, ``.to()`` and ``.float()`` work, and the port's
optimizers take API parameters as they take torch ones.  Sublayers are the
module's children; buffers are API tensors over the module's buffers.
Hooks are torch's (the reference's pre- and post-hooks have torch's
signatures).  ``state_dict`` and ``named_parameters`` give API tensors,
as in the reference.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..core import dtypes as _dt
from ..core.device import place_device
from ..core.tensor import Tensor, value_from_data


class Parameter(Tensor):
    """A trainable tensor (reference: ``Parameter``): ``stop_gradient`` is
    ``not trainable``; its value is a ``torch.nn.Parameter``."""

    def __init__(self, data, trainable=True, name=None):
        v = value_from_data(data)
        grad_ok = v.is_floating_point() or v.is_complex()
        self._value = torch.nn.Parameter(v, requires_grad=bool(
            trainable and grad_ok))
        self._sg = not trainable
        self._leaf = None
        self.trainable = trainable
        self.persistable = True
        self.is_distributed = False
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.do_model_average = None
        self.need_clip = True
        if name is None:
            Tensor._next_id[0] += 1
            name = "generated_tensor_%d" % Tensor._next_id[0]
        self.name = name


class Layer(torch.nn.Module):
    """The base building block (reference: ``Layer``)."""

    _param_counter = 0

    def __init__(self, name_scope=None, dtype="float32"):
        torch.nn.Module.__init__(self)
        object.__setattr__(self, "_api_params", OrderedDict())
        object.__setattr__(self, "_api_buffers", OrderedDict())
        object.__setattr__(self, "_non_persistable_buffer_names", set())
        self._dtype = _dt.convert_dtype(dtype)
        self._name_scope = name_scope or self.__class__.__name__.lower()

    # -- attribute routing ---------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_api_params")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ first")
            self.__dict__.pop(name, None)
            self._api_buffers.pop(name, None)
            self._buffers.pop(name, None)
            torch.nn.Module.register_parameter(self, name, value._value)
            params[name] = value
            return
        if params is not None and name in params:
            if value is None:
                params[name] = None
                self._parameters[name] = None
                return
            raise TypeError("cannot assign %s to parameter %r (a Parameter "
                            "or None)" % (type(value).__name__, name))
        bufs = self.__dict__.get("_api_buffers")
        if bufs is not None and name in bufs:
            if value is not None and not isinstance(value, Tensor):
                value = Tensor(value)
            bufs[name] = value
            self._buffers[name] = None if value is None else value._value
            return
        torch.nn.Module.__setattr__(self, name, value)

    def __getattr__(self, name):
        d = self.__dict__
        for store in ("_api_params", "_api_buffers"):
            s = d.get(store)
            if s is not None and name in s:
                return s[name]
        return torch.nn.Module.__getattr__(self, name)

    def __delattr__(self, name):
        for store in ("_api_params", "_api_buffers"):
            s = self.__dict__.get(store)
            if s is not None and name in s:
                del s[name]
                self._parameters.pop(name, None)
                self._buffers.pop(name, None)
                return
        torch.nn.Module.__delattr__(self, name)

    def _apply(self, fn, recurse=True):
        # torch may replace buffers (and parameters it cannot update in
        # place): point the API tensors at what the module now holds
        out = torch.nn.Module._apply(self, fn, recurse)
        for name, p in self._api_params.items():
            if p is not None and self._parameters.get(name) is not None:
                p._value = self._parameters[name]
        for name, b in self._api_buffers.items():
            if b is not None:
                b._value = self._buffers[name]
        return out

    # -- registration --------------------------------------------------------
    def add_parameter(self, name: str, parameter):
        if parameter is not None and not isinstance(parameter, Parameter):
            raise TypeError("add_parameter expects a Parameter")
        if parameter is None:
            self._api_params[name] = None
            self._parameters[name] = None
        else:
            setattr(self, name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True):
        if tensor is not None and not isinstance(tensor, Tensor):
            tensor = Tensor(tensor)
        torch.nn.Module.register_buffer(
            self, name, None if tensor is None else tensor._value,
            persistent=persistable)
        self._api_buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        return tensor

    def create_parameter(self, shape, dtype=None, default_initializer=None,
                         attr=None, is_bias=False) -> Parameter:
        """An initialized parameter (reference precedence: a ``ParamAttr``
        initializer, then the global one, then the layer's default, then
        zeros for a bias and Xavier-uniform for a weight)."""
        from . import initializer as I
        dtype = _dt.convert_dtype(dtype) if dtype else self._dtype
        init = name = None
        if attr is not None and attr is not False:
            init = getattr(attr, "initializer", None)
            name = getattr(attr, "name", None)
        if init is None:
            init = I._global_initializer(is_bias)
        if init is None:
            init = default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierUniform()
        value = init(list(shape), dtype)
        if name is None:
            Layer._param_counter += 1
            name = "%s_%d.%s_0" % (self._name_scope, Layer._param_counter,
                                   "b" if is_bias else "w")
        return Parameter(value, name=name)

    # -- traversal -----------------------------------------------------------
    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True
                         ) -> Iterator[Tuple[str, Parameter]]:
        seen = set()
        for name, layer in ([(prefix, self)] + (
                list(self.named_sublayers(prefix)) if include_sublayers
                else [])):
            params = getattr(layer, "_api_params", {})
            for pname, p in params.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield ("%s.%s" % (name, pname) if name else pname), p

    def parameters(self, include_sublayers=True, recurse=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers and recurse)]

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True):
        for name, layer in ([(prefix, self)] + (
                list(self.named_sublayers(prefix)) if include_sublayers
                else [])):
            for bname, b in getattr(layer, "_api_buffers", {}).items():
                if b is not None:
                    yield ("%s.%s" % (name, bname) if name else bname), b

    def buffers(self, include_sublayers=True, recurse=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers and recurse)]

    def named_sublayers(self, prefix="", include_self=False):
        if include_self:
            yield prefix, self
        for name, layer in self._modules.items():
            if layer is None:
                continue
            sub = "%s.%s" % (prefix, name) if prefix else name
            yield sub, layer
            if isinstance(layer, Layer):
                yield from layer.named_sublayers(sub, False)

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    @property
    def _sub_layers(self):
        return self._modules

    # -- hooks ----------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after each forward; a non-None
        return replaces the outputs."""
        return self.register_forward_hook(hook)

    # -- state dict -----------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        """Parameters and persistable buffers by structured name, as API
        tensors (the reference's keys)."""
        dest = OrderedDict() if destination is None else destination
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers):
            dest[structured_name_prefix + name] = p
        for name, layer in [("", self)] + list(self.named_sublayers()):
            skip = getattr(layer, "_non_persistable_buffer_names", set())
            for bname, b in getattr(layer, "_api_buffers", {}).items():
                if b is not None and bname not in skip:
                    key = "%s.%s" % (name, bname) if name else bname
                    dest[structured_name_prefix + key] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy values in by structured name; returns ``(missing,
        unexpected)`` keys.  Values may be API tensors, torch tensors or
        numpy arrays (cast to each target's dtype)."""
        own = dict(self.named_parameters())
        own.update(dict(self.named_buffers()))
        unexpected = []
        for k, v in state_dict.items():
            tgt = own.get(k)
            if tgt is None:
                unexpected.append(k)
                continue
            if isinstance(v, Tensor):
                v = v._value
            elif not isinstance(v, torch.Tensor):
                v = value_from_data(np.asarray(v), device=tgt._value.device)
            tgt.set_value(v.to(tgt._value.device, tgt._value.dtype))
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- dtype / device -------------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        """Move and/or cast the parameters (every one, as the reference)
        and the float buffers in place: the API tensors and the module's
        torch parameters stay the same objects."""
        if isinstance(device, torch.dtype) or (
                isinstance(device, str) and device in _dt._NAME_TO_DTYPE):
            device, dtype = None, device
        dev = None if device is None else place_device(device)
        d = _dt.convert_dtype(dtype)
        with torch.no_grad():
            for p in self.parameters():
                p._value.data = p._value.data.to(
                    device=dev, dtype=d if d is not None else None)
            for name, layer in [("", self)] + list(self.named_sublayers()):
                for bname, b in getattr(layer, "_api_buffers", {}).items():
                    if b is None:
                        continue
                    bd = d if (d is not None and b._value.is_floating_point()
                               ) else None
                    b._value = b._value.to(device=dev, dtype=bd)
                    layer._buffers[bname] = b._value
        if d is not None:
            self._dtype = d
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    # -- functionalization ----------------------------------------------------
    def functional_state(self) -> Dict[str, torch.Tensor]:
        """Parameter and buffer values by structured name."""
        return {k: v._value for k, v in self.state_dict().items()}

    @contextlib.contextmanager
    def bind_state(self, state: Dict[str, torch.Tensor]):
        """Temporarily run the layer on other values (``functional_call``)."""
        sd = self.state_dict()
        old = {k: sd[k]._value for k in state if k in sd}
        try:
            for k, v in state.items():
                if k in sd:
                    sd[k]._value = v._value if isinstance(v, Tensor) else v
            yield self
        finally:
            for k, v in old.items():
                sd[k]._value = v

    def functional_call(self, state, *args, **kwargs):
        with self.bind_state(state):
            return self(*args, **kwargs)

    # -- misc ----------------------------------------------------------------
    def full_name(self):
        return self._name_scope

    def clear_gradients(self, set_to_zero=False):
        for p in self.parameters():
            p.clear_gradient(set_to_zero)
