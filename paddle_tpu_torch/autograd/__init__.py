"""Autograd public API (counterpart of ``paddle_tpu/autograd``): backward,
grad, the grad switches and ``PyLayer``, on ``torch.autograd``."""
from .tape import (enable_grad, grad, is_grad_enabled, no_grad,  # noqa
                   run_backward, set_grad_enabled)
from .py_layer import PyLayer, PyLayerContext, LegacyPyLayer  # noqa: F401


def backward(tensors, grad_tensors=None, retain_graph=False):
    """``paddle.autograd.backward``: reverse accumulation from each of
    ``tensors`` (seeded by ``grad_tensors``)."""
    run_backward(tensors, grad_tensors, retain_graph=retain_graph)


__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled", "PyLayer", "PyLayerContext"]
