"""The paddle API's layers (counterpart of ``paddle_tpu/nn/layers.py``):
parameter containers over ``nn.functional``.  ``Linear`` stores its weight
as paddle's ``[in, out]`` (the models' torch-layout layers are
``models/_layers.py``).  Convolution, pooling and the layers over the
extended functionals are a later slice.
"""
from __future__ import annotations


import numpy as np

from ..core.tensor import Tensor
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
