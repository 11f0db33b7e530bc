"""The paddle API's layers (counterpart of ``paddle_tpu/nn/layers.py``):
parameter containers over ``nn.functional``.  ``Linear`` stores its weight
as paddle's ``[in, out]`` (the models' torch-layout layers are
``models/_layers.py``); convolution weights keep paddle's layouts.
"""
from __future__ import annotations


import numpy as np
import torch

from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from ..ops._helpers import targ
from ..ops.random import generator_for
from .layer_base import Layer
from . import functional as F
from . import initializer as I


class Linear(Layer):
    """y = xW + b, W:[in, out] (reference: paddle.nn.Linear)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierUniform())
        if bias_attr is not False:
            self.bias = self.create_parameter(
                [out_features], attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        w = self.weight
        return f"in={w.shape[0]}, out={w.shape[1]}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if padding_idx is not None:
            val = np.array(self.weight.numpy())
            val[padding_idx] = 0
            self.weight.set_value(val)

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx)


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, self.training, self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, self.training, self.data_format)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        from ..ops.manipulation import flatten
        return flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *a, **k):
        super().__init__()

    def forward(self, x):
        return x


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self._args = (size, scale_factor, mode, align_corners, align_mode,
                      data_format)

    def forward(self, x):
        return F.interpolate(x, *self._args)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.factor, self.data_format)


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], tuple):
            for name, layer in layers[0]:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._sub_layers.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._sub_layers.values())[idx])
        return list(self._sub_layers.values())[idx]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            for i, l in enumerate(sublayers):
                self.add_sublayer(str(i), l)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._sub_layers)), sublayer)
        return self

    def extend(self, sublayers):
        for l in sublayers:
            self.append(l)
        return self

    def insert(self, index, sublayer):
        layers = list(self._sub_layers.values())
        layers.insert(index, sublayer)
        self._sub_layers.clear()
        for i, l in enumerate(layers):
            self._sub_layers[str(i)] = l

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._sub_layers.values())[idx])
        return list(self._sub_layers.values())[idx]

    def __setitem__(self, idx, layer):
        self._sub_layers[str(idx)] = layer

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def append(self, parameter):
        self.add_parameter(str(len(self._api_params)), parameter)
        return self

    def __getitem__(self, idx):
        return list(self._api_params.values())[idx]

    def __len__(self):
        return len(self._api_params)

    def __iter__(self):
        return iter(self._api_params.values())


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        if weight_attr is not False:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                [num_features], attr=bias_attr, is_bias=True)
        else:
            self.bias = None
        self.register_buffer("_mean", Tensor(np.zeros(num_features,
                                                      np.float32)))
        self.register_buffer("_variance", Tensor(np.ones(num_features,
                                                         np.float32)))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, self.training, self._momentum,
                            self._epsilon, self._data_format,
                            self._use_global_stats)


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCW" if data_format in ("NCL", "NCW")
                         else "NWC", use_global_stats, name)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm with this process's batch statistics: the cross-rank
    reduction of the statistics is a later slice (the distributed API)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        if weight_attr is not False:
            self.weight = self.create_parameter(
                self._normalized_shape, attr=weight_attr,
                default_initializer=I.Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                self._normalized_shape, attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class RMSNorm(Layer):
    """Parity: fused_rms_norm surface (reference #17) as a layer."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is not False:
            self.weight = self.create_parameter(
                [num_channels], attr=weight_attr,
                default_initializer=I.Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                [num_channels], attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is not False:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                [num_features], attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self._args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self._args)


def _act_layer(name, fn, **default_kw):
    class _Act(Layer):
        def __init__(self, *a, **kw):
            super().__init__()
            self._a = a
            self._kw = {**default_kw, **kw}
            self._kw.pop("name", None)

        def forward(self, x):
            return fn(x, *self._a, **self._kw)

    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", F.relu)


ReLU6 = _act_layer("ReLU6", F.relu6)


GELU = _act_layer("GELU", F.gelu)


SiLU = _act_layer("SiLU", F.silu)


Swish = _act_layer("Swish", F.swish)


Sigmoid = _act_layer("Sigmoid", F.sigmoid)


Tanh = _act_layer("Tanh", F.tanh)


Softmax = _act_layer("Softmax", F.softmax)


LogSoftmax = _act_layer("LogSoftmax", F.log_softmax)


Softplus = _act_layer("Softplus", F.softplus)


Softsign = _act_layer("Softsign", F.softsign)


LeakyReLU = _act_layer("LeakyReLU", F.leaky_relu)


ELU = _act_layer("ELU", F.elu)


CELU = _act_layer("CELU", F.celu)


SELU = _act_layer("SELU", F.selu)


Mish = _act_layer("Mish", F.mish)


Hardtanh = _act_layer("Hardtanh", F.hardtanh)


Hardsigmoid = _act_layer("Hardsigmoid", F.hardsigmoid)


Hardswish = _act_layer("Hardswish", F.hardswish)


Hardshrink = _act_layer("Hardshrink", F.hardshrink)


Softshrink = _act_layer("Softshrink", F.softshrink)


Tanhshrink = _act_layer("Tanhshrink", F.tanhshrink)


LogSigmoid = _act_layer("LogSigmoid", F.log_sigmoid)


ThresholdedReLU = _act_layer("ThresholdedReLU", F.thresholded_relu)


Maxout = _act_layer("Maxout", F.maxout)


GLU = _act_layer("GLU", F.glu)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


def _loss_layer(name, fn):
    class _Loss(Layer):
        def __init__(self, *a, **kw):
            super().__init__()
            self._a = a
            self._kw = kw
            self._kw.pop("name", None)

        def forward(self, input, label, *extra):
            return fn(input, label, *extra, *self._a, **self._kw)

    _Loss.__name__ = name
    _Loss.__qualname__ = name
    return _Loss


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self._kw = dict(weight=weight, ignore_index=ignore_index,
                        reduction=reduction, soft_label=soft_label,
                        axis=axis, use_softmax=use_softmax,
                        label_smoothing=label_smoothing)

    def forward(self, input, label):
        return F.cross_entropy(input, label, **self._kw)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self._reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self._reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self._kw = dict(weight=weight, ignore_index=ignore_index,
                        reduction=reduction)

    def forward(self, input, label):
        return F.nll_loss(input, label, **self._kw)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight, self._reduction = weight, reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self._weight,
                                      self._reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self._kw = dict(weight=weight, reduction=reduction,
                        pos_weight=pos_weight)

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label, **self._kw)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__()
        self._reduction, self._log_target = reduction, log_target

    def forward(self, input, label):
        return F.kl_div(input, label, self._reduction, self._log_target)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self._reduction, self._delta = reduction, delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self._reduction, self._delta)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self._blank, self._reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self._blank, self._reduction, norm_by_times)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self._margin, self._reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self._margin,
                                     self._reduction)


class Pad2D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self._args = (padding, mode, value, data_format)

    def forward(self, x):
        return F.pad(x, *self._args)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, self.training, self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, self.training)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor, self.data_format = downscale_factor, data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.factor, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self._args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self._args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self._args = (output_sizes, kernel_sizes, strides, paddings,
                      dilations)

    def forward(self, x):
        return F.fold(x, *self._args)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class Bilinear(Layer):
    """y_o = x1^T W_o x2 + b_o (reference: paddle.nn.Bilinear)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            default_initializer=I.XavierUniform())
        if bias_attr is not False:
            self.bias = self.create_parameter([out_features], attr=bias_attr,
                                              is_bias=True)
        else:
            self.bias = None

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self._axis, self._eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self._axis, self._eps)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self._reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self._kw = dict(p=p, margin=margin, weight=weight,
                        reduction=reduction)

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, **self._kw)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._kw = dict(weight=weight, reduction=reduction)

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, **self._kw)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self._kw = dict(log_input=log_input, full=full, epsilon=epsilon,
                        reduction=reduction)

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, **self._kw)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self._kw = dict(full=full, epsilon=epsilon, reduction=reduction)

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, **self._kw)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._kw = dict(margin=margin, p=p, epsilon=epsilon, swap=swap,
                        reduction=reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, **self._kw)


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__()
        self._args = (padding, mode, value,
                      "NCW" if data_format == "NCL" else data_format)

    def forward(self, x):
        return F.pad(x, *self._args)


class Pad3D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__()
        self._args = (padding, mode, value, data_format)

    def forward(self, x):
        return F.pad(x, *self._args)


class InstanceNorm1D(Layer):
    """Parity: paddle.nn.InstanceNorm1D ([N, C, L])."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None):
        super().__init__()
        self._eps = epsilon
        self.scale = None if weight_attr is False else \
            self.create_parameter([num_features], attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else \
            self.create_parameter([num_features], attr=bias_attr,
                                  is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._eps, data_format="NCL")


class InstanceNorm3D(InstanceNorm1D):
    """Parity: paddle.nn.InstanceNorm3D ([N, C, D, H, W])."""

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._eps, data_format="NCDHW")


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self._margin, self._reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self._margin,
                                       self._reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self._margin, self._reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self._margin,
                                      self._reduction)


class LayerDict(Layer):
    """Parity: paddle.nn.LayerDict — ordered dict of sublayers."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._sub_layers[key]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def __contains__(self, key):
        return key in self._sub_layers

    def clear(self):
        self._sub_layers.clear()

    def pop(self, key):
        layer = self._sub_layers[key]
        del self._sub_layers[key]
        return layer

    def keys(self):
        return self._sub_layers.keys()

    def values(self):
        return self._sub_layers.values()

    def items(self):
        return self._sub_layers.items()

    def update(self, sublayers):
        items = sublayers.items() if hasattr(sublayers, "items") \
            else sublayers
        for key, layer in items:
            self.add_sublayer(key, layer)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self._axis, self._shape = axis, shape

    def forward(self, x):
        from ..ops.manipulation import reshape
        ax = self._axis % x.ndim
        return reshape(x, x.shape[:ax] + list(self._shape)
                       + x.shape[ax + 1:])


class Silu(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.silu(x)


class Softmax2D(Layer):
    """Parity: paddle.nn.Softmax2D — softmax over the channel dim of
    [N, C, H, W] (or [C, H, W])."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.softmax(x, axis=-3)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training)


# -- convolution -------------------------------------------------------------
class _ConvNd(Layer):
    """A convolution's parameters, paddle's layouts: weight ``[out,
    in/groups, *k]`` (``[in, out/groups, *k]`` for a transpose), both
    uniform in ``+-1/sqrt(fan_in)``."""

    def __init__(self, nd, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0):
        super().__init__()
        from .functional.conv import _pair
        k = _pair(kernel_size, nd)
        self._stride, self._padding, self._dilation = stride, padding, dilation
        self._groups = groups
        self._data_format = data_format
        self._transpose = transpose
        self._output_padding = output_padding
        if transpose:
            wshape = [in_channels, out_channels // groups] + list(k)
        else:
            wshape = [out_channels, in_channels // groups] + list(k)
        fan_in = in_channels * int(np.prod(k)) // groups
        bound = 1.0 / np.sqrt(fan_in)
        self.weight = self.create_parameter(
            wshape, attr=weight_attr,
            default_initializer=I.Uniform(-bound, bound))
        if bias_attr is not False:
            self.bias = self.create_parameter(
                [out_channels], attr=bias_attr,
                default_initializer=I.Uniform(-bound, bound), is_bias=True)
        else:
            self.bias = None

    def _conv_args(self):
        return (self.weight, self.bias, self._stride, self._padding,
                self._dilation, self._groups, self._data_format)

    def _transpose_args(self, output_size):
        return (self.weight, self.bias, self._stride, self._padding,
                self._output_padding, self._groups, self._dilation,
                output_size, self._data_format)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, *self._conv_args())


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, *self._conv_args())


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, *self._conv_args())


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, *self._transpose_args(output_size))


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, *self._transpose_args(output_size))


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, *self._transpose_args(output_size))


# -- pooling -----------------------------------------------------------------
class _Pool(Layer):
    """A pool: its functional and the arguments after ``x``."""

    _fn = None

    def __init__(self, *args):
        super().__init__()
        self._args = args

    def forward(self, x):
        return type(self)._fn(x, *self._args)


class MaxPool1D(_Pool):
    _fn = staticmethod(F.max_pool1d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, return_mask,
                         ceil_mode)


class MaxPool2D(_Pool):
    _fn = staticmethod(F.max_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, return_mask,
                         ceil_mode, data_format)


class MaxPool3D(_Pool):
    _fn = staticmethod(F.max_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, return_mask,
                         ceil_mode, data_format)


class AvgPool1D(_Pool):
    _fn = staticmethod(F.avg_pool1d)

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, exclusive, ceil_mode)


class AvgPool2D(_Pool):
    _fn = staticmethod(F.avg_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         divisor_override, data_format)


class AvgPool3D(_Pool):
    _fn = staticmethod(F.avg_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         divisor_override, data_format)


class AdaptiveAvgPool1D(_Pool):
    _fn = staticmethod(F.adaptive_avg_pool1d)

    def __init__(self, output_size, name=None):
        super().__init__(output_size)


class AdaptiveAvgPool2D(_Pool):
    _fn = staticmethod(F.adaptive_avg_pool2d)

    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(output_size, data_format)


class AdaptiveAvgPool3D(_Pool):
    _fn = staticmethod(F.adaptive_avg_pool3d)

    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size, data_format)


class AdaptiveMaxPool1D(_Pool):
    _fn = staticmethod(F.adaptive_max_pool1d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask)


class AdaptiveMaxPool2D(_Pool):
    # the reference's layer drops return_mask
    _fn = staticmethod(F.adaptive_max_pool2d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size)


class AdaptiveMaxPool3D(_Pool):
    _fn = staticmethod(F.adaptive_max_pool3d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask)


class FractionalMaxPool2D(_Pool):
    _fn = staticmethod(F.fractional_max_pool2d)

    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__(output_size, kernel_size, random_u, return_mask)


class FractionalMaxPool3D(_Pool):
    _fn = staticmethod(F.fractional_max_pool3d)

    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__(output_size, kernel_size, random_u, return_mask)


class _MaxUnPool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        return type(self)._fn(x, indices, *self._args)


class MaxUnPool1D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool1d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


class MaxUnPool2D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool2d)


class MaxUnPool3D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool3d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


# -- vision, distance and the extended losses --------------------------------
class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class PairwiseDistance(Layer):
    """``||x - y + eps||_p`` over the last axis (the reference's
    ``linalg.norm`` of the difference)."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self._p, self._eps, self._keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        p, keep = self._p, self._keepdim

        def fn(v):
            a = torch.abs(v)
            if p in (np.inf, float("inf")):
                return torch.amax(a, dim=-1, keepdim=keep)
            if p in (-np.inf, float("-inf")):
                return torch.amin(a, dim=-1, keepdim=keep)
            if p == 0:
                return torch.sum((v != 0).to(v.dtype), dim=-1, keepdim=keep)
            return torch.pow(torch.sum(torch.pow(a, p), dim=-1,
                                       keepdim=keep), 1.0 / p)
        return apply_op("norm", fn, (targ(x - y + self._eps),))


class TripletMarginWithDistanceLoss(Layer):
    """The triplet loss under a distance callable (without one,
    ``F.triplet_margin_loss``)."""

    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._dist = distance_function
        self._margin, self._swap = margin, swap
        self._reduction = reduction

    def forward(self, input, positive, negative):
        if self._dist is None:
            return F.triplet_margin_loss(
                input, positive, negative, margin=self._margin,
                swap=self._swap, reduction=self._reduction)
        from ..ops import math as _m, reduction as _r
        d_pos = self._dist(input, positive)
        d_neg = self._dist(input, negative)
        if self._swap:
            d_neg = _m.minimum(d_neg, self._dist(positive, negative))
        loss = _m.clip(d_pos - d_neg + self._margin, min=0.0)
        if self._reduction == "mean":
            return _r.mean(loss)
        if self._reduction == "sum":
            return _r.sum(loss)
        return loss


class SpectralNorm(Layer):
    """Spectral normalisation of a weight passed to ``forward``: ``W /
    sigma_max(W)``, sigma by power iteration over the matricised weight
    (``dim`` its rows), ``weight_u``/``weight_v`` persistent buffers drawn
    by numpy's ``RandomState(0)`` (the reference's draws, bit for bit)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        shape = list(weight_shape)
        h = shape[dim]
        w = int(np.prod([s for i, s in enumerate(shape) if i != dim]))
        rng = np.random.RandomState(0)
        self.register_buffer("weight_u", Tensor(
            rng.randn(h).astype("float32")))
        self.register_buffer("weight_v", Tensor(
            rng.randn(w).astype("float32")))

    def forward(self, weight):
        mat = weight
        if self._dim != 0:
            perm = [self._dim] + [i for i in range(len(weight.shape))
                                  if i != self._dim]
            mat = weight.transpose(perm)
        mat2 = mat.reshape([mat.shape[0], -1])
        u, v = self.weight_u, self.weight_v
        with torch.no_grad():
            for _ in range(self._power_iters):
                v = F.normalize(mat2.t().matmul(u.unsqueeze(1)).squeeze(1),
                                epsilon=self._eps, axis=0)
                u = F.normalize(mat2.matmul(v.unsqueeze(1)).squeeze(1),
                                epsilon=self._eps, axis=0)
            self.weight_u._value.copy_(u._value)
            self.weight_v._value.copy_(v._value)
        sigma = u.unsqueeze(0).matmul(mat2).matmul(
            v.unsqueeze(1)).reshape([])
        return weight / sigma


class FeatureAlphaDropout(Layer):
    """Alpha dropout of whole channels (feature maps), keeping the
    self-normalising statistics (SELU's alpha')."""

    _ALPHA_P = 1.7580993408473766   # -selu_alpha * selu_scale

    def __init__(self, p=0.5, name=None):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(
                f"FeatureAlphaDropout p must be in [0, 1), got {p}")
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        p = self.p
        alpha_p = -self._ALPHA_P
        a = (1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5)
        b = -a * alpha_p * p

        def fn(v):
            shape = (v.shape[0], v.shape[1]) + (1,) * (v.dim() - 2)
            keep = torch.rand(shape, generator=generator_for(v.device),
                              device=v.device) < (1 - p)
            return (torch.where(keep, v, alpha_p) * a + b).to(v.dtype)
        return apply_op("feature_alpha_dropout", fn, (x,))


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Hierarchical softmax with frequency cutoffs: a head over [the
    common classes + one token a cluster] and a tail projection a cluster,
    each narrower by ``div_value``; ``forward`` gathers only the targets'
    entries."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if (not cutoffs or cutoffs != sorted(cutoffs)
                or len(set(cutoffs)) != len(cutoffs)
                or cutoffs[-1] > n_classes - 1 or min(cutoffs) <= 0):
            raise ValueError(
                "cutoffs must be unique, increasing, positive ints "
                "< n_classes")
        self.in_features = in_features
        self.n_classes = n_classes
        self.cutoffs = cutoffs + [n_classes]
        self.div_value = div_value
        self.shortlist_size = self.cutoffs[0]
        self.n_clusters = len(self.cutoffs) - 1
        self.head_size = self.shortlist_size + self.n_clusters
        self.head = Linear(in_features, self.head_size,
                           bias_attr=head_bias if head_bias else False)
        self.tail = LayerList()
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features / (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            self.tail.append(Sequential(
                Linear(in_features, hsz, bias_attr=False),
                Linear(hsz, osz, bias_attr=False)))

    def _full_log_prob(self, input):
        from ..ops.manipulation import concat
        head_out = F.log_softmax(self.head(input), axis=-1)
        parts = [head_out[..., :self.shortlist_size]]
        for i, tail in enumerate(self.tail):
            gate = head_out[..., self.shortlist_size + i:
                            self.shortlist_size + i + 1]
            parts.append(F.log_softmax(tail(input), axis=-1) + gate)
        return concat(parts, axis=-1)

    def forward(self, input, label):
        head_lp = F.log_softmax(self.head(input), axis=-1)
        cluster_lps = [F.log_softmax(t(input), axis=-1) for t in self.tail]
        c = self.cutoffs
        short = self.shortlist_size

        def fn(hlp, lab, *clps):
            lab = lab.to(torch.int64)
            sl = torch.clamp(lab, 0, short - 1)
            out = torch.gather(hlp, -1, sl[..., None])[..., 0]
            for i, clp in enumerate(clps):
                rel = torch.clamp(lab - c[i], 0, clp.shape[-1] - 1)
                val = torch.gather(clp, -1, rel[..., None])[..., 0] \
                    + hlp[..., short + i]
                out = torch.where((lab >= c[i]) & (lab < c[i + 1]), val,
                                  out)
            return out

        output = apply_op("adaptive_log_softmax", fn,
                          tuple([head_lp, label] + cluster_lps))
        return output, -output.mean()

    def log_prob(self, input):
        return self._full_log_prob(input)

    def predict(self, input):
        return self._full_log_prob(input).argmax(axis=-1)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over the default complete binary tree or a
    custom path table."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self._num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr)
        if bias_attr is not False:
            self.bias = self.create_parameter(
                [num_classes - 1], attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self._num_classes,
                               self.weight, self.bias,
                               path_table=path_table, path_code=path_code)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.0, reduction="mean",
                 name=None):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           blank=self.blank,
                           fastemit_lambda=self.fastemit_lambda,
                           reduction=self.reduction)
