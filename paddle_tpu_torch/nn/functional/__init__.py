"""``paddle.nn.functional`` of the port (reference
``paddle_tpu/nn/functional/__init__.py``): the functions whose ops the
port has, and the attention of the eager core, which reaches the flash
kernels (K1 forward, K2/K3 backward) on the card."""
from ...ops.attention import (  # noqa: F401
    flash_attention, scaled_dot_product_attention,
)
from ...ops.manipulation import pad  # noqa: F401
from ...ops.math import tanh_  # noqa: F401
from ...ops.nn_ops import (  # noqa: F401
    alpha_dropout, bilinear, binary_cross_entropy,
    binary_cross_entropy_with_logits, celu, cosine_similarity,
    cross_entropy, diag_embed, dice_loss, dropout, dropout2d, dropout3d,
    elu, elu_, embedding, gelu, glu, hardshrink, hardsigmoid, hardswish,
    hardtanh, kl_div, l1_loss, label_smooth, layer_norm, leaky_relu, linear,
    log_loss, log_sigmoid, log_softmax, margin_ranking_loss, maxout, mish,
    mse_loss, nll_loss, normalize, npair_loss, one_hot, prelu, relu, relu6,
    relu_, selu, sequence_mask, sigmoid, sigmoid_focal_loss, silu,
    smooth_l1_loss, softmax, softmax_, softmax_with_cross_entropy,
    softplus, softshrink, softsign, square_error_cost, swish, tanh,
    tanhshrink, thresholded_relu,
)
