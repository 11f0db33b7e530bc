"""``paddle.nn.utils`` (counterpart of ``paddle_tpu/nn/utils``): the
``weight_norm`` and ``spectral_norm`` reparametrisations as forward
pre-hooks on the layer (a ``torch.nn.Module``) under the reference's
names (``weight_g``/``weight_v``, ``weight_orig``), the
parameter/vector packing and the gradient clips.  torch's own
``torch.nn.utils`` versions name and compose differently and are not
used."""
from __future__ import annotations

import numpy as np
import torch

from ...core.dispatch import apply_op
from ...core.tensor import Tensor
from ..layer_base import Layer, Parameter

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters",
           "clip_grad_norm_", "clip_grad_value_"]


def _norm_except(w, dim):
    """The L2 norm over every axis but ``dim`` (``dim=None``: the whole
    tensor's)."""
    if dim is None:
        return torch.sqrt(torch.sum(torch.square(w)))
    axes = tuple(i for i in range(w.dim()) if i != dim)
    return torch.sqrt(torch.sum(torch.square(w), dim=axes, keepdim=True))


class _WeightNormHook:
    def __init__(self, layer: Layer, name: str, dim):
        self.name = name
        self.dim = dim
        w = getattr(layer, name)
        with torch.no_grad():
            g = Parameter(_norm_except(w._value, dim), name=f"{w.name}_g")
            v = Parameter(w._value.clone(), name=f"{w.name}_v")
        delattr(layer, name)
        layer.add_parameter(name + "_g", g)
        layer.add_parameter(name + "_v", v)
        self._compose(layer)

    def _compose(self, layer):
        """The weight ``g * v / ||v||`` as a plain attribute, recomputed
        each forward so the gradients reach ``g`` and ``v``."""
        g = getattr(layer, self.name + "_g")
        v = getattr(layer, self.name + "_v")
        norm = apply_op("weight_norm_norm",
                        lambda x: _norm_except(x, self.dim), (v,))
        object.__setattr__(layer, self.name, g * (v / norm))

    def __call__(self, layer, inputs):
        self._compose(layer)


def weight_norm(layer: Layer, name: str = "weight", dim: int = 0):
    """Reparametrise ``layer.<name>`` as ``g * v / ||v||`` (``g`` and
    ``v`` trainable), recomposed every forward."""
    hook = _WeightNormHook(layer, name, dim)
    handle = layer.register_forward_pre_hook(hook)
    object.__setattr__(layer, "_weight_norm_hook", (hook, handle))
    return layer


def remove_weight_norm(layer: Layer, name: str = "weight"):
    """Bake the composed weight back into one parameter."""
    hook, handle = layer._weight_norm_hook
    hook._compose(layer)
    w = layer.__dict__.pop(name)
    delattr(layer, name + "_g")
    delattr(layer, name + "_v")
    handle.remove()
    layer.add_parameter(name, Parameter(w._value.detach().clone()))
    object.__delattr__(layer, "_weight_norm_hook")
    return layer


class _SpectralNormHook:
    """Divides the weight by its largest singular value, estimated by
    ``n`` power iterations from a fixed ``u`` (drawn once from a seeded
    generator: the reference's comes from ``PRNGKey(0)``, whose bits torch
    cannot draw; a parity check sets ``_u``)."""

    def __init__(self, layer, name, n_power_iterations, eps, dim):
        self.name = name
        self.n = n_power_iterations
        self.eps = eps
        self.dim = dim
        w = getattr(layer, name)._value
        rows = w.shape[dim]
        u = torch.randn(rows, generator=torch.Generator().manual_seed(0))
        self._u = u / (torch.linalg.norm(u) + eps)

    def __call__(self, layer, inputs):
        w = getattr(layer, self.name + "_orig")

        def fn(wv):
            wm = torch.movedim(wv, self.dim, 0).reshape(wv.shape[self.dim],
                                                        -1)
            u = self._u.to(wm.device, wm.dtype)
            for _ in range(self.n):
                v = wm.T @ u
                v = v / (torch.linalg.norm(v) + self.eps)
                u = wm @ v
                u = u / (torch.linalg.norm(u) + self.eps)
            return wv / (u @ wm @ v)

        object.__setattr__(layer, self.name, apply_op(
            "spectral_norm_reparam", fn, (w,)))


def spectral_norm(layer: Layer, name: str = "weight",
                  n_power_iterations: int = 1, eps: float = 1e-12,
                  dim=None):
    """Divide ``layer.<name>`` by its largest singular value each forward
    (the parameter becomes ``<name>_orig``)."""
    if dim is None:
        dim = 1 if layer.__class__.__name__ in ("Linear", "Embedding") \
            else 0
    hook = _SpectralNormHook(layer, name, n_power_iterations, eps, dim)
    w = getattr(layer, name)
    delattr(layer, name)
    layer.add_parameter(name + "_orig", w)
    hook(layer, None)
    layer.register_forward_pre_hook(hook)
    return layer


def parameters_to_vector(parameters, name=None) -> Tensor:
    return Tensor._from_value(torch.cat(
        [p._value.detach().reshape(-1) for p in parameters]))


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of ``vec`` into ``parameters``."""
    v = vec._value if isinstance(vec, Tensor) else torch.as_tensor(
        np.asarray(vec))
    off = 0
    for p in parameters:
        n = p._value.numel()
        p._value.copy_(v[off:off + n].reshape(p._value.shape).to(
            p._value.device, p._value.dtype))
        off += n
    if off != v.shape[0]:
        raise ValueError(
            f"vector has {v.shape[0]} elements but parameters take {off}")


def _live_grads(parameters):
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    return [p for p in parameters
            if not p.stop_gradient and p._grad is not None]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Clip every ``.grad`` in place by the global norm; returns the
    norm."""
    live = _live_grads(parameters)
    if not live:
        return Tensor._from_value(torch.zeros(()))
    grads = [p._grad for p in live]
    if norm_type == float("inf"):
        total = torch.max(torch.stack([g.abs().max() for g in grads]))
    else:
        total = torch.sum(torch.stack(
            [torch.sum(torch.abs(g.to(torch.float32)) ** norm_type)
             for g in grads])) ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("the total norm for gradients is non-finite")
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p, g in zip(live, grads):
        p.grad = (g * scale).to(g.dtype)
    return Tensor._from_value(total)


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp every ``.grad`` to ``[-clip_value, clip_value]``."""
    cv = abs(float(clip_value))
    for p in _live_grads(parameters):
        p.grad = torch.clamp(p._grad, -cv, cv)
