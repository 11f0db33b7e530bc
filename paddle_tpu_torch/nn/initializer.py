"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer.py``).

Each initializer is a callable ``(shape, dtype) -> torch.Tensor`` on the
current device, drawing from the global generator (``paddle.seed``).  The
draws cannot equal the reference's (threefry) bits; the distributions and
their parameters (fans, gains, limits) are the reference's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtypes as _dt
from ..core.device import current_device
from ..ops.random import generator_for


def _fan_in_out(shape):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    # a Linear weight is [in, out]; a conv weight [out, in, kh, kw]
    if len(shape) == 2:
        return shape[0], shape[1]
    return shape[1] * receptive, shape[0] * receptive


def _draw(fill, shape, dtype):
    dev = current_device()
    t = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    fill(t, generator_for(dev))
    return t.to(_dt.convert_dtype(dtype))


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value,
                          dtype=_dt.convert_dtype(dtype),
                          device=current_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        return _draw(lambda t, g: t.normal_(self.mean, self.std,
                                            generator=g), shape, dtype)


class TruncatedNormal(Initializer):
    """Normal(mean, std) cut to ``[mean + a std, mean + b std]`` (the
    reference's bounds are in standard units)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype):
        def fill(t, g):
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, self.a, self.b,
                                        generator=g)
            t.mul_(self.std).add_(self.mean)
        return _draw(fill, shape, dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        return _draw(lambda t, g: t.uniform_(self.low, self.high,
                                             generator=g), shape, dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fan_in_out(shape)
        fi, fo = self.fan_in or fi, self.fan_out or fo
        return Normal(0.0, self.gain * math.sqrt(2.0 / (fi + fo)))(shape,
                                                                   dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fan_in_out(shape)
        fi, fo = self.fan_in or fi, self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def __call__(self, shape, dtype):
        fi = self.fan_in or _fan_in_out(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return Normal(0.0, gain / math.sqrt(fi))(shape, dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def __call__(self, shape, dtype):
        fi = self.fan_in or _fan_in_out(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype):
        from ..core.tensor import Tensor, value_from_data
        v = self.value.numpy() if isinstance(self.value, Tensor) \
            else self.value
        return value_from_data(np.asarray(v), dtype).reshape(tuple(shape))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype):
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        mid = tuple(s // 2 for s in shape[2:])
        for i in range(min(oc, ic * self.groups)):
            out[(i, i % ic) + mid] = 1.0
        return torch.from_numpy(out).to(current_device(),
                                        _dt.convert_dtype(dtype))


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype):
        rows, cols = shape[0], int(np.prod(shape[1:]))
        a = Normal()((max(rows, cols), min(rows, cols)), "float32")
        q, r = np.linalg.qr(a.cpu().numpy())
        q = q * np.sign(np.diag(r))
        q = q.T if rows < cols else q
        out = (self.gain * q[:rows, :cols].reshape(shape)).astype(np.float32)
        return torch.from_numpy(out).to(current_device(),
                                        _dt.convert_dtype(dtype))


constant_init = Constant
normal_init = Normal


class Bilinear(Initializer):
    """The bilinear-interpolation kernel of transposed-conv upsampling,
    weight ``[C_out, C_in, H, W]``."""

    def __call__(self, shape, dtype):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer expects a 4-D weight")
        h, w = shape[2], shape[3]
        f_h, f_w = (h + 1) // 2, (w + 1) // 2
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        og = np.ogrid[:h, :w]
        filt = (1 - abs(og[0] / f_h - c_h)) * (1 - abs(og[1] / f_w - c_w))
        weight = np.zeros(shape, np.float32)
        for i in range(shape[0]):
            for j in range(shape[1]):
                if shape[0] == shape[1] and i != j:
                    continue
                weight[i, j] = filt
        return torch.from_numpy(weight).to(current_device(),
                                           _dt.convert_dtype(dtype))


_GLOBAL_INIT = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    """Override the default weight/bias initializers of
    ``Layer.create_parameter`` (None restores them)."""
    _GLOBAL_INIT["weight"] = weight_init
    _GLOBAL_INIT["bias"] = bias_init


def _global_initializer(is_bias: bool):
    return _GLOBAL_INIT["bias" if is_bias else "weight"]


def calculate_gain(nonlinearity, param=None):
    if param is None:
        param = 0.01
    recommended = {
        "sigmoid": 1.0, "linear": 1.0,
        "conv1d": 1.0, "conv2d": 1.0, "conv3d": 1.0,
        "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "conv_transpose1d": 1.0,
        "conv_transpose2d": 1.0, "conv_transpose3d": 1.0,
        "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + param ** 2)), "selu": 3.0 / 4,
    }
    if nonlinearity not in recommended:
        raise ValueError("nonlinearity %r has no recommended gain"
                         % (nonlinearity,))
    return recommended[nonlinearity]


class LazyGuard:
    """A scope marker: parameters are made at once, as in the
    reference."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
