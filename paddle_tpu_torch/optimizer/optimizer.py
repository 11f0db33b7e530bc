"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``):
the base with learning rate (a float or an ``lr.LRScheduler``), weight
decay, fp32 master weights and ``state_dict``; SGD, Momentum, Adagrad,
RMSProp, Adadelta, Adamax, Lamb and Rprop; Adam with a moment dtype,
AdamW with decoupled decay, and Adafactor.

Each update rule (``_update_rule(p, g, state, lr)``) updates one tensor
and its state in place under ``torch.no_grad``: the math runs in fp32 in
the reference's order of operations, the moments are stored in
``moment_dtype``, and the beta powers are kept per parameter.  In place
is the port's choice where the reference returns new arrays: it keeps one
copy of the parameters and moments on the card.  ``p`` and the state may
be views, so the layerwise step (``jit/layerwise.py``) applies the same
rule to one layer's slice of its stacked buffers, and the sharded
training step to a rank's rows or placed slice of a parameter, whose
state :meth:`Optimizer.state_for` creates at that slice's shape.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch
from torch import nn

from .lr import LRScheduler

_MOMENT_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
                  "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}

Params = Iterable[Union[nn.Parameter, Tuple[str, nn.Parameter]]]


class Optimizer:
    """Base optimizer.  ``parameters`` are ``nn.Parameter`` s or
    ``(name, parameter)`` pairs (``model.named_parameters()``); a name is
    what ``AdamW``'s ``apply_decay_param_fun`` sees.  With
    ``multi_precision``, a bf16/fp16 parameter keeps an fp32 master copy in
    its state and is updated from it."""

    # the update rule is elementwise over (param, grad, state), so a
    # sharded step may apply it to a rank's slice of a parameter; a rule
    # with cross-element reductions (factored statistics) sets False
    shardable_update = True

    def __init__(self, learning_rate: Union[float, LRScheduler] = 0.001,
                 parameters: Optional[Params] = None, weight_decay=None,
                 multi_precision: bool = False, grad_clip=None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self._params: List[Tuple[str, nn.Parameter]] = []
        # the paddle API's Parameters by name (their torch parameters are
        # what the update rules see)
        self._api_params: Dict[str, object] = {}
        for i, item in enumerate(parameters):
            name, p = item if isinstance(item, tuple) else (
                getattr(item, "name", None) or "param_%d" % i, item)
            value = getattr(p, "_value", None)
            if isinstance(value, nn.Parameter):
                self._api_params[name] = p
                p = value
            self._params.append((name, p))
        self._grad_clip = grad_clip
        self._learning_rate = (learning_rate
                               if isinstance(learning_rate, LRScheduler)
                               else float(learning_rate))
        self._weight_decay = weight_decay
        self._multi_precision = multi_precision
        self._state: Dict[str, Dict[str, torch.Tensor]] = {}
        self._global_step = 0

    # -- learning rate -------------------------------------------------------
    def get_lr(self) -> float:
        """The current rate: the scheduler's last value when the learning
        rate is an ``lr.LRScheduler`` (its ``step()`` is the caller's)."""
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when lr is an LRScheduler instance")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler: LRScheduler) -> None:
        self._learning_rate = scheduler

    def _decay_coeff(self) -> float:
        """The L2 coefficient of ``weight_decay`` (a float or an
        ``L2Decay``-style holder with ``_coeff``; 0 for None)."""
        wd = self._weight_decay
        if wd is None or wd is False:
            return 0.0
        return float(getattr(wd, "_coeff", wd))

    def _decayed(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """``g + coeff * p`` in fp32 (the reference's ``_apply_decay``)."""
        g32 = g.to(torch.float32)
        coeff = self._decay_coeff()
        return g32 + coeff * p.to(torch.float32) if coeff else g32

    @property
    def params(self) -> List[Tuple[str, nn.Parameter]]:
        return list(self._params)

    def state(self, name: str) -> Dict[str, torch.Tensor]:
        """The state of the parameter ``name``, created at first use."""
        st = self._state.get(name)
        if st is None:
            st = self.state_for(name, dict(self._params)[name])
        return st

    def state_for(self, name: str, like: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        """The state of ``name``, created at first use at the shape of
        ``like`` (the parameter, or the slice of it that this rank
        updates: a sharded step never holds a whole moment of a sharded
        parameter); the fp32 master is ``like``'s."""
        st = self._state.get(name)
        if st is None:
            st = self._init_state(name, like)
            if self._multi_precision and like.dtype in (torch.bfloat16,
                                                        torch.float16):
                st["master"] = like.detach().to(torch.float32)
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
        """Update every parameter that has a gradient, in place, after
        ``grad_clip`` (if any) has clipped the gradients."""
        lr = self.get_lr()
        live = [(name, p) for name, p in self._params if p.grad is not None]
        grads = [p.grad for _, p in live]
        if self._grad_clip is not None and live:
            grads = self._clipped(live, grads)
        for (name, p), g in zip(live, grads):
            self._update_rule(p, g, self.state(name), lr)
        self._global_step += 1

    def _clipped(self, live, grads):
        """``grad_clip`` over ``(param, grad)`` API-tensor pairs (the
        reference's clip interface)."""
        from ..core.tensor import Tensor
        pairs = [(self._api_params[name] if name in self._api_params
                  else Tensor._from_value(p), Tensor._from_value(g))
                 for (name, p), g in zip(live, grads)]
        return [g._value for _, g in self._grad_clip(pairs)]

    def clear_grad(self) -> None:
        for _, p in self._params:
            p.grad = None

    clear_gradients = clear_grad

    # -- checkpoints ---------------------------------------------------------
    def state_dict(self) -> Dict[str, object]:
        """``{"global_step", "LR_Scheduler" (a scheduler's own state),
        "<param name>_<leaf>": tensor}`` (the reference's keys, each leaf
        a copy)."""
        out: Dict[str, object] = {"global_step": self._global_step}
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        for name, _ in self._params:
            for k, v in self._state.get(name, {}).items():
                out["%s_%s" % (name, k)] = v.detach().clone()
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict: Dict[str, object]) -> None:
        """Load :meth:`state_dict`'s keys: each parameter's state is made
        fresh and the leaves found are copied in; a parameter with none
        keeps no state."""
        self._global_step = int(state_dict.get("global_step", 0))
        if isinstance(self._learning_rate, LRScheduler) \
                and "LR_Scheduler" in state_dict:
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for name, p in self._params:
            st = self._init_state(name, p)
            found = False
            for k, cur in st.items():
                v = state_dict.get("%s_%s" % (name, k))
                if v is not None:
                    st[k] = torch.as_tensor(v).to(cur.device, cur.dtype) \
                        .clone()
                    found = True
            master = state_dict.get("%s_master" % name)
            if master is not None:
                st["master"] = torch.as_tensor(master).to(
                    p.device, torch.float32).clone()
                found = True
            if found:
                self._state[name] = st


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _scalar32(value: float, p: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(value), dtype=torch.float32, device=p.device)


class SGD(Optimizer):
    """Plain gradient descent: ``p - lr * (g + coeff * p)``."""

    def _update_rule(self, p, g, state, lr):
        g32 = self._decayed(p, g)
        base = state["master"] if "master" in state else p.to(torch.float32)
        new = base - lr * g32
        if "master" in state:
            state["master"].copy_(new)
        p.copy_(new)


class Momentum(Optimizer):
    """Heavy-ball momentum (``use_nesterov``: the Nesterov form): the fp32
    ``velocity`` ``v = momentum * v + g``, the step ``lr * v`` (or ``lr *
    (g + momentum * v)``)."""

    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 parameters: Optional[Params] = None,
                 use_nesterov: bool = False, weight_decay=None,
                 multi_precision: bool = False, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         multi_precision,
                         grad_clip=grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, name, p):
        return {"velocity": _zeros32(p)}

    def _update_rule(self, p, g, state, lr):
        g32 = self._decayed(p, g)
        v = self._momentum * state["velocity"] + g32
        upd = g32 + self._momentum * v if self._nesterov else v
        base = state["master"] if "master" in state else p.to(torch.float32)
        new = base - lr * upd
        state["velocity"].copy_(v)
        if "master" in state:
            state["master"].copy_(new)
        p.copy_(new)


class Adagrad(Optimizer):
    """Adagrad: the fp32 sum of squared gradients ``moment`` (from
    ``initial_accumulator_value``), the step ``lr * g / (sqrt(moment) +
    epsilon)``."""

    def __init__(self, learning_rate, epsilon: float = 1e-6,
                 parameters: Optional[Params] = None, weight_decay=None,
                 initial_accumulator_value: float = 0.0,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip=grad_clip)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, name, p):
        return {"moment": torch.full(p.shape, float(self._init_acc),
                                     dtype=torch.float32, device=p.device)}

    def _update_rule(self, p, g, state, lr):
        g32 = self._decayed(p, g)
        acc = state["moment"] + g32.square()
        new = p.to(torch.float32) - lr * g32 / (acc.sqrt() + self._eps)
        state["moment"].copy_(acc)
        p.copy_(new)


class RMSProp(Optimizer):
    """RMSProp with momentum and the ``centered`` form: ``mean_square``
    (and ``mean_grad``) running averages at ``rho``, ``moment = momentum
    * moment + lr * g / sqrt(ms (- mg^2) + epsilon)``, ``p - moment``."""

    def __init__(self, learning_rate, rho: float = 0.95,
                 epsilon: float = 1e-6, momentum: float = 0.0,
                 centered: bool = False,
                 parameters: Optional[Params] = None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip=grad_clip)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, name, p):
        st = {"mean_square": _zeros32(p), "moment": _zeros32(p)}
        if self._centered:
            st["mean_grad"] = _zeros32(p)
        return st

    def _update_rule(self, p, g, state, lr):
        g32 = self._decayed(p, g)
        rho = self._rho
        ms = rho * state["mean_square"] + (1 - rho) * g32.square()
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g32
            state["mean_grad"].copy_(mg)
            denom = (ms - mg.square() + self._eps).sqrt()
        else:
            denom = (ms + self._eps).sqrt()
        mom = self._momentum * state["moment"] + lr * g32 / denom
        state["mean_square"].copy_(ms)
        state["moment"].copy_(mom)
        p.copy_(p.to(torch.float32) - mom)


class Adadelta(Optimizer):
    """Adadelta: running averages of squared gradients and squared
    updates at ``rho``, the update ``g * sqrt(asu + eps) / sqrt(asg +
    eps)`` scaled by ``lr``."""

    def __init__(self, learning_rate=0.001, epsilon: float = 1e-6,
                 rho: float = 0.95, parameters: Optional[Params] = None,
                 weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip=grad_clip)
        self._eps, self._rho = epsilon, rho

    def _init_state(self, name, p):
        return {"avg_squared_grad": _zeros32(p),
                "avg_squared_update": _zeros32(p)}

    def _update_rule(self, p, g, state, lr):
        g32 = self._decayed(p, g)
        rho, eps = self._rho, self._eps
        asg = rho * state["avg_squared_grad"] + (1 - rho) * g32.square()
        upd = g32 * (state["avg_squared_update"] + eps).sqrt() \
            / (asg + eps).sqrt()
        asu = rho * state["avg_squared_update"] + (1 - rho) * upd.square()
        state["avg_squared_grad"].copy_(asg)
        state["avg_squared_update"].copy_(asu)
        p.copy_(p.to(torch.float32) - lr * upd)


class Adamax(Optimizer):
    """Adamax: the first moment, the infinity norm ``u = max(beta2 * u,
    |g|)``, the step ``lr / (1 - beta1^t) * m / (u + epsilon)``."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters: Optional[Params] = None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip=grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, name, p):
        return {"moment": _zeros32(p), "inf_norm": _zeros32(p),
                "beta1_pow": _scalar32(1.0, p)}

    def _update_rule(self, p, g, state, lr):
        g32 = self._decayed(p, g)
        b1 = self._beta1
        b1p = state["beta1_pow"] * b1
        m = b1 * state["moment"] + (1 - b1) * g32
        u = torch.maximum(self._beta2 * state["inf_norm"], g32.abs())
        new = p.to(torch.float32) - lr / (1 - b1p) * m / (u + self._eps)
        state["moment"].copy_(m)
        state["inf_norm"].copy_(u)
        state["beta1_pow"].copy_(b1p)
        p.copy_(new)


class Lamb(Optimizer):
    """Lamb (You et al. 2019): Adam's direction plus ``wd * p``, scaled by
    the trust ratio ``||p|| / ||r||`` (1 where either norm is 0);
    ``exclude_from_weight_decay_fn(name)`` True gives a parameter no
    decay."""

    # the trust ratio needs the whole parameter's norms: a rank's slice
    # would change the math, so a sharded step keeps Lamb replicated
    shardable_update = False

    def __init__(self, learning_rate=0.001, lamb_weight_decay: float = 0.01,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-6, parameters: Optional[Params] = None,
                 exclude_from_weight_decay_fn: Optional[
                     Callable[[str], bool]] = None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip=grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, name, p):
        wd = self._decay_coeff()
        if self._exclude_fn is not None and self._exclude_fn(name):
            wd = 0.0
        return {"moment1": _zeros32(p), "moment2": _zeros32(p),
                "beta1_pow": _scalar32(1.0, p),
                "beta2_pow": _scalar32(1.0, p), "wd": _scalar32(wd, p)}

    def _update_rule(self, p, g, state, lr):
        g32 = g.to(torch.float32)
        p32 = p.to(torch.float32)
        b1, b2 = self._beta1, self._beta2
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        m1 = b1 * state["moment1"] + (1 - b1) * g32
        m2 = b2 * state["moment2"] + (1 - b2) * g32.square()
        r = (m1 / (1 - b1p)) / ((m2 / (1 - b2p)).sqrt() + self._eps) \
            + state["wd"] * p32
        w_norm = torch.linalg.vector_norm(p32)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        for k, v in (("moment1", m1), ("moment2", m2), ("beta1_pow", b1p),
                     ("beta2_pow", b2p)):
            state[k].copy_(v)
        p.copy_(p32 - lr * trust * r)


class Rprop(Optimizer):
    """Rprop: a per-element step size (``lr`` state, from the learning
    rate) grown by ``etas[1]`` where the gradient keeps its sign, shrunk by
    ``etas[0]`` where it flips (and that gradient zeroed), clipped to
    ``learning_rate_range``; the step ``step size * sign(g)``."""

    def __init__(self, learning_rate=0.001,
                 learning_rate_range: Tuple[float, float] = (1e-5, 50),
                 parameters: Optional[Params] = None,
                 etas: Tuple[float, float] = (0.5, 1.2),
                 grad_clip=None):
        super().__init__(learning_rate, parameters, None,
                         grad_clip=grad_clip)
        self._lr_range = learning_rate_range
        self._etas = etas

    def _init_state(self, name, p):
        return {"prev_grad": _zeros32(p),
                "lr": torch.full(p.shape, float(self.get_lr()),
                                 dtype=torch.float32, device=p.device)}

    def _update_rule(self, p, g, state, lr):
        g32 = g.to(torch.float32)
        sign = torch.sign(g32 * state["prev_grad"])
        one = torch.ones_like(g32)
        factor = torch.where(sign > 0, self._etas[1] * one,
                             torch.where(sign < 0, self._etas[0] * one, one))
        step = torch.clamp(state["lr"] * factor, self._lr_range[0],
                           self._lr_range[1])
        g_eff = torch.where(sign < 0, torch.zeros_like(g32), g32)
        state["prev_grad"].copy_(g_eff)
        state["lr"].copy_(step)
        p.copy_(p.to(torch.float32) - step * torch.sign(g_eff))


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
                 moment_dtype: str = "float32",
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         multi_precision,
                         grad_clip=grad_clip)
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
                 moment_dtype: str = "float32",
                 grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, multi_precision, moment_dtype,
                         grad_clip=grad_clip)
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


class Adafactor(Optimizer):
    """Adafactor (Shazeer & Stern 2018; reference: ``Adafactor``): factored
    second moments for parameters of two or more dimensions (a row factor
    ``vr`` over ``shape[:-1]`` and a column factor ``vc`` over
    ``shape[:-2] + shape[-1:]``, fp32), a full ``v`` for 1-D ones, the
    update RMS-clipped to ``clip_threshold`` and, with
    ``scale_parameter``, scaled by ``max(epsilon2, rms(p))``; ``beta1``
    adds a first moment stored in ``moment_dtype``; ``weight_decay``
    decays by the same scaled step size."""

    # factored statistics and the RMS clip reduce across elements
    shardable_update = False

    def __init__(self, learning_rate: float = 0.001,
                 beta1: Optional[float] = None, epsilon1: float = 1e-30,
                 epsilon2: float = 1e-3, clip_threshold: float = 1.0,
                 decay_rate: float = 0.8, scale_parameter: bool = True,
                 parameters: Optional[Params] = None,
                 weight_decay: Optional[float] = None,
                 moment_dtype: str = "float32",
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip=grad_clip)
        if str(moment_dtype) not in _MOMENT_DTYPES:
            raise ValueError("moment_dtype must be one of %s; got %r"
                             % (sorted(_MOMENT_DTYPES), moment_dtype))
        self._beta1 = beta1
        self._eps1, self._eps2 = epsilon1, epsilon2
        self._clip_threshold = clip_threshold
        self._decay_rate = decay_rate
        self._scale_parameter = scale_parameter
        self._moment_dtype = _MOMENT_DTYPES[str(moment_dtype)]

    def _init_state(self, name, p):
        f32 = dict(dtype=torch.float32, device=p.device)
        shape = tuple(p.shape)
        st = {"step": torch.zeros((), **f32)}
        if len(shape) >= 2:
            st["vr"] = torch.zeros(shape[:-1], **f32)
            st["vc"] = torch.zeros(shape[:-2] + shape[-1:], **f32)
        else:
            st["v"] = torch.zeros(shape, **f32)
        if self._beta1 is not None:
            st["m"] = torch.zeros(shape, dtype=self._moment_dtype,
                                  device=p.device)
        return st

    def _update_rule(self, p, g, state, lr):
        g32 = g.to(torch.float32)
        t = state["step"] + 1.0
        rho = 1.0 - torch.pow(t, -self._decay_rate)
        gsq = g32.square() + self._eps1
        new = {"step": t}
        if g32.dim() >= 2:
            vr = rho * state["vr"] + (1 - rho) * gsq.mean(dim=-1)
            vc = rho * state["vc"] + (1 - rho) * gsq.mean(dim=-2)
            new["vr"], new["vc"] = vr, vc
            # u = g / sqrt(v) with v_ij = vr_i * vc_j / mean_i(vr)
            r = torch.rsqrt(vr / vr.mean(dim=-1, keepdim=True))
            c = torch.rsqrt(vc)
            u = g32 * r[..., :, None] * c[..., None, :]
        else:
            v = rho * state["v"] + (1 - rho) * gsq
            new["v"] = v
            u = g32 * torch.rsqrt(v)
        del gsq
        rms_u = u.square().mean().sqrt()
        u = u / torch.clamp(rms_u / self._clip_threshold, min=1.0)
        if self._beta1 is not None:
            m = self._beta1 * state["m"].to(torch.float32) \
                + (1 - self._beta1) * u
            new["m"] = m
            u = m
        p32 = p.to(torch.float32)
        alpha = lr
        if self._scale_parameter:
            alpha = lr * torch.clamp(p32.square().mean().sqrt(),
                                     min=self._eps2)
        if self._weight_decay is not None:
            # decay rides the same RMS-scaled step size as the update
            p32 = p32 * (1.0 - alpha * float(self._weight_decay))
        p.copy_(p32 - alpha * u)
        for k, val in new.items():
            state[k].copy_(val)
