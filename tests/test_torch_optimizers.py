"""The rest of ``optimizer/`` in the port against the JAX reference, on the
CPU: SGD, Momentum, Adagrad, RMSProp, Adadelta, Adamax, Lamb and Rprop
(each with and without weight decay) and LBFGS (with and without the
strong-Wolfe line search; two iterations a step, so its fp32 rounding
stays below the tolerance: more let the search's cancellation grow it)
over 3 steps of one tiny MLP from the same numpy weights and batch,
every parameter within 1e-6 relative (fp32); a scheduler as
``learning_rate`` with ``set_lr``'s refusal; and the ``state_dict`` round
trip continuing the trajectory.  The schedulers themselves are
``tests/test_torch_lr.py``.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.optimizer import lr as ref_lr

from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.optimizer import lr as port_lr
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

STEPS = 3
REL = 1e-6


def _problem():
    rng = np.random.RandomState(0)
    params = {"w1": rng.randn(8, 16).astype(np.float32) * 0.5,
              "b1": rng.randn(16).astype(np.float32) * 0.1,
              "w2": rng.randn(16, 2).astype(np.float32) * 0.5,
              "b2": rng.randn(2).astype(np.float32) * 0.1}
    x = rng.randn(32, 8).astype(np.float32)
    y = rng.randn(32, 2).astype(np.float32)
    return params, x, y


class _Ref:
    """The MLP on the reference's eager tape."""

    def __init__(self, params, x, y):
        self.params = []
        for k, v in params.items():
            t = paddle.to_tensor(v.copy(), stop_gradient=False)
            t.name = k
            self.params.append(t)
        self.x, self.y = paddle.to_tensor(x), paddle.to_tensor(y)

    def loss(self):
        w1, b1, w2, b2 = self.params
        h = paddle.tanh(paddle.matmul(self.x, w1) + b1)
        d = paddle.matmul(h, w2) + b2 - self.y
        return (d * d).mean()

    def values(self):
        return {p.name: np.asarray(p._value) for p in self.params}


class _Port:
    """The same MLP in torch."""

    def __init__(self, params, x, y):
        self.named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
                      for k, v in params.items()]
        self.x, self.y = torch.from_numpy(x), torch.from_numpy(y)

    def loss(self):
        w1, b1, w2, b2 = (p for _, p in self.named)
        h = torch.tanh(self.x @ w1 + b1)
        d = h @ w2 + b2 - self.y
        return (d * d).mean()

    def values(self):
        return {k: p.detach().numpy().copy() for k, p in self.named}


OPTIMIZERS = {
    "sgd": ("SGD", dict(learning_rate=0.1)),
    "momentum": ("Momentum", dict(learning_rate=0.05, momentum=0.9)),
    "nesterov": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                  use_nesterov=True)),
    "adagrad": ("Adagrad", dict(learning_rate=0.1,
                                initial_accumulator_value=0.1)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01, momentum=0.5)),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01,
                                         centered=True)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0)),
    "adamax": ("Adamax", dict(learning_rate=0.05)),
    "lamb": ("Lamb", dict(learning_rate=0.05)),
    "rprop": ("Rprop", dict(learning_rate=0.01)),
}


def _decay_kw(key, on):
    if key == "lamb":
        return {"lamb_weight_decay": 0.1 if on else 0.0}
    if key == "rprop":
        return {}
    return {"weight_decay": 0.1} if on else {}


def _assert_close(got, want):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=REL,
                                   atol=REL * np.abs(want[k]).max(),
                                   err_msg=k)


def _train(model, o, steps=STEPS):
    for _ in range(steps):
        model.loss().backward()
        o.step()
        o.clear_grad()


# Rprop takes no weight decay (neither does the reference's)
@pytest.mark.parametrize("key,decay", [
    (k, d) for k in sorted(OPTIMIZERS) for d in (False, True)
    if not (k == "rprop" and d)],
    ids=lambda v: v if isinstance(v, str) else ("decay" if v else "plain"))
def test_optimizer_matches_the_reference(key, decay):
    name, kw = OPTIMIZERS[key]
    kw = dict(kw, **_decay_kw(key, decay))
    params, x, y = _problem()
    ref, port = _Ref(params, x, y), _Port(params, x, y)
    _train(ref, getattr(ref_opt, name)(parameters=ref.params, **kw))
    _train(port, getattr(opt, name)(parameters=port.named, **kw))
    _assert_close(port.values(), ref.values())


@pytest.mark.parametrize("search", [None, "strong_wolfe"],
                         ids=["fixed_step", "strong_wolfe"])
def test_lbfgs_matches_the_reference(search):
    params, x, y = _problem()
    ref, port = _Ref(params, x, y), _Port(params, x, y)
    kw = dict(learning_rate=0.5, max_iter=2, history_size=3,
              line_search_fn=search)
    r = ref_opt.LBFGS(parameters=ref.params, **kw)
    p = opt.LBFGS(parameters=port.named, **kw)
    for _ in range(STEPS):
        def ref_closure():
            loss = ref.loss()
            loss.backward()
            return loss

        def port_closure():
            loss = port.loss()
            loss.backward()
            return loss
        want = float(np.asarray(r.step(ref_closure)._value))
        got = float(p.step(port_closure))
        assert abs(got - want) <= REL * abs(want)
    _assert_close(port.values(), ref.values())
    assert p._n_evals == r._n_evals


def test_scheduler_as_learning_rate_and_set_lr():
    params, x, y = _problem()
    ref, port = _Ref(params, x, y), _Port(params, x, y)
    rs, ps = ref_lr.StepDecay(0.1, step_size=1, gamma=0.5), \
        port_lr.StepDecay(0.1, step_size=1, gamma=0.5)
    r = ref_opt.Momentum(learning_rate=rs, parameters=ref.params)
    p = opt.Momentum(learning_rate=ps, parameters=port.named)
    for _ in range(STEPS):
        for m, o, s in ((ref, r, rs), (port, p, ps)):
            m.loss().backward()
            o.step()
            o.clear_grad()
            s.step()
        assert p.get_lr() == r.get_lr()
    _assert_close(port.values(), ref.values())
    with pytest.raises(RuntimeError, match="LRScheduler instance"):
        p.set_lr(0.3)
    plain = opt.SGD(learning_rate=0.1, parameters=port.named)
    plain.set_lr(0.3)
    assert plain.get_lr() == 0.3


@pytest.mark.parametrize("key", ["momentum", "adamax", "lamb", "rprop"])
def test_state_dict_round_trip_continues_the_trajectory(key):
    name, kw = OPTIMIZERS[key]
    params, x, y = _problem()
    sched = port_lr.ExponentialDecay(kw["learning_rate"], gamma=0.9)
    a = _Port(params, x, y)
    oa = getattr(opt, name)(parameters=a.named,
                            **dict(kw, learning_rate=sched))
    _train(a, oa, 2)
    sched.step()
    sd = oa.state_dict()
    assert sd["global_step"] == 2 and "LR_Scheduler" in sd
    b = _Port({k: v for k, v in a.values().items()}, x, y)
    ob = getattr(opt, name)(parameters=b.named, **dict(
        kw, learning_rate=port_lr.ExponentialDecay(kw["learning_rate"],
                                                   gamma=0.9)))
    ob.set_state_dict(sd)
    assert ob.get_lr() == oa.get_lr() and ob._global_step == 2
    _train(a, oa, 2)
    _train(b, ob, 2)
    for k, v in a.values().items():
        np.testing.assert_array_equal(b.values()[k], v)
    assert math.isfinite(a.loss().item())
