"""Automatic mixed precision (counterpart of ``paddle_tpu/amp``):
``auto_cast`` (O1 by the white and black lists, O2 everything but the
black list), ``decorate`` (O2 casts the model's parameters and gives the
optimizer fp32 master weights) and ``GradScaler`` (dynamic loss
scaling).  The cast happens in ``core.dispatch.apply_op``, the one door
every API op goes through; torch's autograd carries each gradient back to
its input's dtype.  ``amp.debugging`` holds the tensor checker and the
operator statistics."""
from __future__ import annotations

import contextlib

import torch

from ..core import dispatch as _dispatch
from ..core import dtypes as _dt
from ..core.tensor import Tensor
from .amp_lists import BLACK_LIST, WHITE_LIST

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "is_bfloat16_supported", "is_float16_supported"]


def is_bfloat16_supported(device=None):
    return True


def is_float16_supported(device=None):
    return True


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """``paddle.amp.auto_cast``: ops run in ``dtype`` by the lists of
    ``level``; the previous state comes back on exit."""
    st = _dispatch._amp_state
    old = dict(st)
    white, black = set(WHITE_LIST), set(BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    st.update(enabled=bool(enable), dtype=_dt.convert_dtype(dtype),
              level=level, white=frozenset(white), black=frozenset(black))
    try:
        yield
    finally:
        st.clear()
        st.update(old)


amp_guard = auto_cast


def amp_dtype_for_op(name: str, level: str, dtype: str, custom_white=(),
                     custom_black=()):
    """The dtype op ``name`` runs in under ``level`` and ``dtype`` (None:
    as it comes), the lists applied as ``auto_cast`` applies them."""
    target = _dt.convert_dtype(dtype)
    white = (frozenset(WHITE_LIST) | frozenset(custom_white)) \
        - frozenset(custom_black)
    black = (frozenset(BLACK_LIST) | frozenset(custom_black)) \
        - frozenset(custom_white)
    return _dispatch.amp_policy(name, level, target, white, black)


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """``paddle.amp.decorate``: at O2 the models' float parameters are
    cast to ``dtype`` in place and the optimizers keep fp32 master
    weights (unless ``master_weight=False``)."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        d = _dt.convert_dtype(dtype)
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p._value.is_floating_point():
                        p._value.data = p._value.data.to(d)
        if optimizers is not None:
            opts = optimizers if isinstance(optimizers, (list, tuple)) \
                else [optimizers]
            for opt in opts:
                opt._multi_precision = True if master_weight is None \
                    else bool(master_weight)
    if optimizers is None:
        return models if single_model else model_list
    return (models if single_model else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling (reference: ``GradScaler``), over the port's
    optimizers: ``unscale_`` divides every gradient by the scale in fp32
    and notes any non-finite value; ``step`` skips the update after one;
    ``update`` moves the scale."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._opt_states = {}

    def scale(self, var: Tensor) -> Tensor:
        if not self._enable:
            return var
        from ..ops import math as _m
        return _m.multiply(var, float(self._scale))

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        rec = self._opt_states.get(id(optimizer))
        if rec is not None and rec["state"] == "UNSCALED":
            raise RuntimeError(
                "unscale_() has already been called on this optimizer "
                "since the last update().")
        if rec is not None and rec["state"] == "STEPPED":
            raise RuntimeError("unscale_() is being called after step().")
        inv = 1.0 / self._scale
        found = False
        for _, p in optimizer._params:
            if p.grad is not None:
                g = p.grad.to(torch.float32) * inv
                if not bool(torch.isfinite(g).all()):
                    found = True
                p.grad.copy_(g.to(p.grad.dtype))
        self._opt_states[id(optimizer)] = {"state": "UNSCALED",
                                           "found_inf": found}
        self._found_inf = self._found_inf or found

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        rec = self._opt_states.get(id(optimizer))
        if rec is not None and rec["state"] == "STEPPED":
            raise RuntimeError(
                "step() has already been called since the last update().")
        if rec is None or rec["state"] != "UNSCALED":
            self.unscale_(optimizer)
        if not self._opt_states[id(optimizer)]["found_inf"]:
            optimizer.step()
        self._opt_states[id(optimizer)]["state"] = "STEPPED"

    def update(self):
        self._opt_states.clear()
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return Tensor(torch.tensor(self._scale, dtype=torch.float32))

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": self._good_steps,
                "decr_count": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("incr_count", 0)
        self._bad_steps = sd.get("decr_count", 0)


from . import debugging  # noqa: E402,F401  (paddle.amp.debugging)
