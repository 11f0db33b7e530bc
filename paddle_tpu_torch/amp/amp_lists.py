"""AMP O1 op lists (a port copy of ``paddle_tpu/amp/amp_lists.py``): the
reference's dispatch names, which the port's ``apply_op`` uses too."""

# compute-bound ops that are safe and fast in bf16/fp16 (the GEMMs)
WHITE_LIST = frozenset({
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "addmm", "scaled_dot_product_attention", "flash_attention",
})

# numerically sensitive ops kept in fp32
BLACK_LIST = frozenset({
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum", "cos",
    "sin", "tan", "acos", "asin", "atan", "cosh", "sinh", "softmax",
    "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "binary_cross_entropy", "bce_with_logits", "nll_loss", "kl_div",
    "layer_norm", "batch_norm", "instance_norm", "group_norm", "rms_norm",
    "reciprocal", "rsqrt", "pow", "norm", "dist", "cumsum", "cumprod",
    "logsumexp", "logcumsumexp", "std", "var", "erfinv", "expm1",
})
