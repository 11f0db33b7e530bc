"""Random ops and generator state (counterpart of
``paddle_tpu/ops/random.py``).

Draws come from explicit ``torch.Generator`` s behind one
:class:`Generator` (``paddle.seed``, ``default_generator``): one torch
generator for each device a draw lands on, each seeded from the same
seed.  The reference draws from JAX's threefry keys, whose bits torch
cannot reproduce; the contract kept is the seed's (the same seed gives the
same draws, another seed others) and each op's distribution.  An op called
with an explicit nonzero ``seed`` draws from a generator advanced per
call for that seed, as the reference's seeded counters do.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..core import dtypes as _dt
from ..core.device import current_device
from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from .registry import register_op
from ._helpers import as_value


class Generator:
    """The API's generator: a seed and one ``torch.Generator`` per device
    (made at first use on that device, seeded with the seed)."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._gens = {}
        self._lock = threading.Lock()

    def manual_seed(self, seed: int):
        with self._lock:
            self._seed = int(seed)
            for dev, g in self._gens.items():
                g.manual_seed(self._seed)
        return self

    def initial_seed(self):
        return self._seed

    def for_device(self, device) -> torch.Generator:
        dev = torch.device(device)
        key = (dev.type, dev.index or 0)
        with self._lock:
            g = self._gens.get(key)
            if g is None:
                g = torch.Generator(device=dev).manual_seed(self._seed)
                self._gens[key] = g
            return g

    def get_state(self):
        with self._lock:
            return {k: g.get_state() for k, g in self._gens.items()}

    def set_state(self, state):
        with self._lock:
            for k, s in state.items():
                dev = torch.device(k[0], k[1]) if k[0] != "cpu" \
                    else torch.device("cpu")
                g = self._gens.get(k) or torch.Generator(device=dev)
                g.set_state(s)
                self._gens[k] = g


_GLOBAL_GENERATOR = Generator(0)
_SEEDED_COUNTERS: dict = {}


def _seeded_generator(seed_val: int, device) -> torch.Generator:
    """A generator for an op called with ``seed=seed_val``: successive
    calls with one seed give different (run-reproducible) draws."""
    c = _SEEDED_COUNTERS.get(seed_val, 0)
    _SEEDED_COUNTERS[seed_val] = c + 1
    mixed = (int(seed_val) * 1000003 + c) % (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)


def default_generator() -> Generator:
    return _GLOBAL_GENERATOR


def seed(value: int) -> Generator:
    """``paddle.seed``."""
    return _GLOBAL_GENERATOR.manual_seed(value)


def get_rng_state():
    return [_GLOBAL_GENERATOR.get_state()]


def set_rng_state(state_list):
    _GLOBAL_GENERATOR.set_state(state_list[0])


def generator_for(device) -> torch.Generator:
    """The global generator's torch generator for ``device``."""
    return _GLOBAL_GENERATOR.for_device(device)


def _float_dtype(dtype):
    return _dt.convert_dtype(dtype) if dtype is not None \
        else _dt.get_default_dtype()


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(v) for v in shape.numpy())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _draw(name, kernel, device=None, gen=None):
    """Run ``kernel(generator, device)`` through ``apply_op``."""
    dev = current_device() if device is None else device
    g = generator_for(dev) if gen is None else gen
    return apply_op(name, lambda: kernel(g, dev), ())


def _uniform(g, dev, shape, d, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=g, device=dev, dtype=torch.float32)
    return (u * (hi - lo) + lo).to(d)


def _normal(g, dev, shape, d):
    return torch.randn(shape, generator=g, device=dev,
                       dtype=torch.float32).to(d)


@register_op("rand", category="random")
def rand(shape, dtype=None, name=None):
    shp, dt = _shape(shape), _float_dtype(dtype)
    return _draw("rand", lambda g, dev: _uniform(g, dev, shp, dt))


@register_op("randn", category="random")
def randn(shape, dtype=None, name=None):
    shp, dt = _shape(shape), _float_dtype(dtype)
    return _draw("randn", lambda g, dev: _normal(g, dev, shp, dt))


@register_op("standard_normal", category="random")
def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


@register_op("normal", category="random")
def normal(mean=0.0, std=1.0, shape=None, name=None):
    dt = _dt.get_default_dtype()
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = as_value(mean), as_value(std)
        dev = (mean if isinstance(mean, Tensor) else std)._value.device
        shp = torch.broadcast_shapes(m.shape, s.shape)
        return _draw("normal", lambda g, d: _normal(g, d, shp, dt)
                     * s.to(d) + m.to(d), dev)
    shp = _shape(shape) if shape is not None else ()
    return _draw("normal",
                 lambda g, d: _normal(g, d, shp, dt) * std + mean)


@register_op("uniform", category="random")
def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    shp, dt = _shape(shape), _float_dtype(dtype)
    dev = current_device()
    gen = _seeded_generator(seed, dev) if seed != 0 else None
    return _draw("uniform", lambda g, d: _uniform(g, d, shp, dt, min, max),
                 dev, gen)


@register_op("randint", category="random")
def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    shp, dt = _shape(shape), _dt.convert_dtype(dtype)
    return _draw("randint", lambda g, d: torch.randint(
        low, high, shp, generator=g, device=d, dtype=dt))


@register_op("randint_like", category="random")
def randint_like(x, low=0, high=None, dtype=None, name=None):
    v = as_value(x)
    if high is None:
        low, high = 0, low
    d_ = _dt.convert_dtype(dtype) if dtype else v.dtype
    return _draw("randint_like", lambda g, d: torch.randint(
        low, high, tuple(v.shape), generator=g, device=d).to(d_), v.device)


@register_op("randperm", category="random")
def randperm(n, dtype="int64", name=None):
    d_ = _dt.convert_dtype(dtype)
    return _draw("randperm", lambda g, d: torch.randperm(
        n, generator=g, device=d).to(d_))


@register_op("bernoulli", category="random", tensor_method=True)
def bernoulli(x, name=None):
    v = as_value(x).detach()
    return _draw("bernoulli", lambda g, d: (torch.rand(
        v.shape, generator=g, device=d) < v.float()).to(v.dtype), v.device)


@register_op("bernoulli_", category="random")
def bernoulli_(x, p=0.5, name=None):
    v = as_value(x)
    out = _draw("bernoulli_", lambda g, d: (torch.rand(
        v.shape, generator=g, device=d) < p).to(v.dtype), v.device)
    return x._set_data(out._value)


@register_op("poisson", category="random", tensor_method=True)
def poisson(x, name=None):
    v = as_value(x).detach()
    return _draw("poisson", lambda g, d: torch.poisson(
        v.float(), generator=g).to(v.dtype), v.device)


@register_op("multinomial", category="random", tensor_method=True)
def multinomial(x, num_samples=1, replacement=False, name=None):
    v = as_value(x).detach()
    return _draw("multinomial", lambda g, d: torch.multinomial(
        v.float(), num_samples, replacement, generator=g).to(torch.int64),
        v.device)


@register_op("exponential_", category="random", tensor_method=True)
def exponential_(x, lam=1.0, name=None):
    v = as_value(x)
    out = _draw("exponential_", lambda g, d: torch.empty(
        v.shape, device=d, dtype=torch.float32).exponential_(
        1.0, generator=g).div(lam).to(v.dtype), v.device)
    return x._set_data(out._value)


@register_op("normal_", category="random", tensor_method=True)
def normal_(x, mean=0.0, std=1.0, name=None):
    v = as_value(x)
    out = _draw("normal_", lambda g, d: (_normal(g, d, v.shape, torch.float32)
                                         * std + mean).to(v.dtype), v.device)
    return x._set_data(out._value)


@register_op("uniform_", category="random", tensor_method=True)
def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    v = as_value(x)
    gen = _seeded_generator(seed, v.device) if seed != 0 else None
    out = _draw("uniform_", lambda g, d: _uniform(g, d, v.shape, v.dtype, min,
                                                  max), v.device, gen)
    return x._set_data(out._value)


@register_op("rand_like", category="random")
def rand_like(x, dtype=None, name=None):
    v = as_value(x)
    d_ = _dt.convert_dtype(dtype) if dtype else v.dtype
    return _draw("rand_like", lambda g, d: _uniform(g, d, v.shape, d_),
                 v.device)


@register_op("randn_like", category="random")
def randn_like(x, dtype=None, name=None):
    v = as_value(x)
    d_ = _dt.convert_dtype(dtype) if dtype else v.dtype
    return _draw("randn_like", lambda g, d: _normal(g, d, v.shape, d_),
                 v.device)
