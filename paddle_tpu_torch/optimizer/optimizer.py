"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``):
the base with learning rate, weight decay and fp32 master weights, Adam
with a moment dtype, and AdamW with decoupled decay.

The update is a plain function over tensors (:func:`adam_update`),
applied to each parameter in place under ``torch.no_grad``: the math runs
in fp32 in the reference's order of operations, the moments are stored in
``moment_dtype``, and the beta powers are kept per parameter.  In place
is the port's choice where the reference returns new arrays: it keeps one
copy of the parameters and moments on the card.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch
from torch import nn

_MOMENT_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
                  "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}

Params = Iterable[Union[nn.Parameter, Tuple[str, nn.Parameter]]]


class Optimizer:
    """Base optimizer.  ``parameters`` are ``nn.Parameter`` s or
    ``(name, parameter)`` pairs (``model.named_parameters()``); a name is
    what ``AdamW``'s ``apply_decay_param_fun`` sees.  With
    ``multi_precision``, a bf16/fp16 parameter keeps an fp32 master copy in
    its state and is updated from it."""

    def __init__(self, learning_rate: float = 0.001,
                 parameters: Optional[Params] = None, weight_decay=None,
                 multi_precision: bool = False):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self._params: List[Tuple[str, nn.Parameter]] = []
        for i, item in enumerate(parameters):
            name, p = item if isinstance(item, tuple) else ("param_%d" % i,
                                                            item)
            self._params.append((name, p))
        self._learning_rate = float(learning_rate)
        self._weight_decay = weight_decay
        self._multi_precision = multi_precision
        self._state: Dict[str, Dict[str, torch.Tensor]] = {}
        self._global_step = 0

    def get_lr(self) -> float:
        return self._learning_rate

    @property
    def params(self) -> List[Tuple[str, nn.Parameter]]:
        return list(self._params)

    def state(self, name: str) -> Dict[str, torch.Tensor]:
        """The state of the parameter ``name``, created at first use."""
        st = self._state.get(name)
        if st is None:
            p = dict(self._params)[name]
            st = self._init_state(name, p)
            if self._multi_precision and p.dtype in (torch.bfloat16,
                                                     torch.float16):
                st["master"] = p.detach().to(torch.float32)
            self._state[name] = st
        return st

    def _init_state(self, name: str, p: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        return {}

    def _update_rule(self, p: torch.Tensor, g: torch.Tensor,
                     state: Dict[str, torch.Tensor], lr: float) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self) -> None:
        """Update every parameter that has a gradient, in place."""
        lr = self.get_lr()
        for name, p in self._params:
            if p.grad is not None:
                self._update_rule(p, p.grad, self.state(name), lr)
        self._global_step += 1

    def clear_grad(self) -> None:
        for _, p in self._params:
            p.grad = None


def adam_update(p: torch.Tensor, g: torch.Tensor,
                state: Dict[str, torch.Tensor], lr: float, beta1: float,
                beta2: float, eps: float, weight_decay: float = 0.0,
                decoupled: bool = False) -> None:
    """One Adam(W) step of ``p`` in place (reference: ``Adam._update_rule``,
    op for op in fp32).  ``state`` holds ``moment1``/``moment2`` (in the
    moment dtype), the fp32 ``beta1_pow``/``beta2_pow`` scalars, ``wd``
    for the decoupled form and optionally the fp32 ``master``; each is
    updated in place.  ``weight_decay`` is the L2 coefficient of the
    coupled form (added to the gradient)."""
    g32 = g.to(torch.float32)
    base = state["master"] if "master" in state else p.to(torch.float32)
    if not decoupled and weight_decay:
        g32 = g32 + weight_decay * base
    b1p = state["beta1_pow"] * beta1
    b2p = state["beta2_pow"] * beta2
    m1 = beta1 * state["moment1"].to(torch.float32) + (1 - beta1) * g32
    m2 = beta2 * state["moment2"].to(torch.float32) \
        + (1 - beta2) * g32.square()
    mhat = m1 / (1 - b1p)
    vhat = m2 / (1 - b2p)
    if decoupled:
        base = base * (1.0 - lr * state["wd"])
    new = base - lr * mhat / (vhat.sqrt() + eps)
    state["moment1"].copy_(m1)
    state["moment2"].copy_(m2)
    state["beta1_pow"].copy_(b1p)
    state["beta2_pow"].copy_(b2p)
    if "master" in state:
        state["master"].copy_(new)
    p.copy_(new)


class Adam(Optimizer):
    """Adam with fp32 math and moments stored in ``moment_dtype``
    (``"float32"`` or ``"bfloat16"``: bf16 moments halve the optimizer
    memory, the recipe for a 7B model on one card)."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters: Optional[Params] = None, weight_decay=None,
                 multi_precision: bool = False,
                 moment_dtype: str = "float32"):
        super().__init__(learning_rate, parameters, weight_decay,
                         multi_precision)
        if str(moment_dtype) not in _MOMENT_DTYPES:
            raise ValueError("moment_dtype must be one of %s; got %r"
                             % (sorted(_MOMENT_DTYPES), moment_dtype))
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._moment_dtype = _MOMENT_DTYPES[str(moment_dtype)]

    def _init_state(self, name, p):
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros_like(p, dtype=self._moment_dtype),
                "moment2": torch.zeros_like(p, dtype=self._moment_dtype),
                "beta1_pow": one.clone(), "beta2_pow": one.clone()}

    def _update_rule(self, p, g, state, lr):
        wd = self._weight_decay
        adam_update(p, g, state, lr, self._beta1, self._beta2, self._eps,
                    weight_decay=float(wd) if wd else 0.0)


class AdamW(Adam):
    """Adam with decoupled weight decay, ``base * (1 - lr * wd)`` before
    the step; ``apply_decay_param_fun(name)`` False exempts a parameter
    (its ``wd`` state is 0)."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters: Optional[Params] = None,
                 weight_decay: float = 0.01,
                 apply_decay_param_fun: Optional[Callable[[str], bool]]
                 = None, multi_precision: bool = False,
                 moment_dtype: str = "float32"):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, multi_precision, moment_dtype)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _init_state(self, name, p):
        st = super()._init_state(name, p)
        coeff = float(self._weight_decay or 0.0)
        if self._apply_decay_param_fun is not None \
                and not self._apply_decay_param_fun(name):
            coeff = 0.0
        st["wd"] = torch.tensor(coeff, dtype=torch.float32, device=p.device)
        return st

    def _update_rule(self, p, g, state, lr):
        adam_update(p, g, state, lr, self._beta1, self._beta2, self._eps,
                    decoupled=True)
