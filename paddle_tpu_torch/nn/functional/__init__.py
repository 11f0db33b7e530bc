"""``paddle.nn.functional`` of the port (counterpart of
``paddle_tpu/nn/functional``): activations, the common ops (linear,
dropout, embedding, attention), convolution and pooling, the norms, the
losses, the vision ops and the extended set."""
from .activation import (relu, relu6, relu_, gelu, silu, swish, softmax,
                         log_softmax, softplus, softsign, sigmoid, tanh,
                         hardtanh, hardsigmoid, hardswish, leaky_relu, elu,
                         celu, selu, mish, tanhshrink, softshrink, hardshrink,
                         prelu, glu, maxout, log_sigmoid, thresholded_relu,
                         rrelu, swiglu, gumbel_softmax)
from .common import (linear, dropout, dropout2d, dropout3d, alpha_dropout,
                     embedding, one_hot, pad, interpolate, upsample,
                     unfold, fold, pixel_shuffle, pixel_unshuffle,
                     label_smooth, cosine_similarity, normalize, bilinear,
                     flash_attention, scaled_dot_product_attention,
                     zeropad2d)
from .conv import (conv1d, conv2d, conv3d, conv1d_transpose, conv2d_transpose,
                   conv3d_transpose)
from .pooling import (avg_pool1d, avg_pool2d, avg_pool3d, max_pool1d,
                      max_pool2d, max_pool3d, adaptive_avg_pool1d,
                      adaptive_avg_pool2d, adaptive_avg_pool3d,
                      adaptive_max_pool2d, max_unpool2d,
                      fractional_max_pool2d, adaptive_max_pool1d,
                      adaptive_max_pool3d, max_unpool1d, max_unpool3d)
from .norm import (batch_norm, layer_norm, instance_norm, group_norm,
                   local_response_norm, rms_norm)
from .loss import (cross_entropy, softmax_with_cross_entropy,
                   binary_cross_entropy, binary_cross_entropy_with_logits,
                   mse_loss, l1_loss, nll_loss, kl_div, smooth_l1_loss,
                   margin_ranking_loss, cosine_embedding_loss, ctc_loss,
                   hinge_embedding_loss, triplet_margin_loss, log_loss,
                   square_error_cost, sigmoid_focal_loss,
                   soft_margin_loss, multi_margin_loss,
                   multi_label_soft_margin_loss, poisson_nll_loss,
                   gaussian_nll_loss, dice_loss, npair_loss,
                   margin_cross_entropy)
from .vision import (affine_grid, grid_sample, channel_shuffle,
                     temporal_shift)
from .extended import (pairwise_distance, triplet_margin_with_distance_loss,
                       hsigmoid_loss, rnnt_loss, class_center_sample,
                       fractional_max_pool3d)


def _inplace_act(fn):
    def g(x, *a, **k):
        return x._inplace_assign(fn(x, *a, **k))
    g.__name__ = fn.__name__ + "_"
    return g


elu_ = _inplace_act(elu)
hardtanh_ = _inplace_act(hardtanh)
leaky_relu_ = _inplace_act(leaky_relu)
softmax_ = _inplace_act(softmax)
tanh_ = _inplace_act(tanh)
thresholded_relu_ = _inplace_act(thresholded_relu)
