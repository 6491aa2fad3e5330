"""``paddle.nn.functional`` of the port (reference
``paddle_tpu/nn/functional/__init__.py``): the functions whose ops the
port has, the vision ops among them (convolutions, pools, norms,
resampling), the sequence losses (``ctc_loss``, ``hsigmoid_loss``), the
beam backtrace ``gather_tree`` and the padded sequence ops, and the
attention of the eager core, which reaches the
flash kernels (K1 forward, K2/K3 backward) on the card."""
from ...ops.attention import (  # noqa: F401
    flash_attention, scaled_dot_product_attention,
)
from ...ops.manipulation import pad, unfold  # noqa: F401
from ...ops.math import tanh_  # noqa: F401
from ...ops.nn_ops import (  # noqa: F401
    adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
    adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d,
    affine_grid, alpha_dropout, avg_pool1d, avg_pool2d, avg_pool3d,
    batch_norm, bilinear, binary_cross_entropy,
    binary_cross_entropy_with_logits, celu, conv1d, conv1d_transpose,
    conv2d, conv2d_transpose, conv3d, conv3d_transpose, cosine_similarity,
    cross_entropy, ctc_loss, gather_tree, hsigmoid_loss, diag_embed, dice_loss, dropout, dropout2d, dropout3d,
    elu, elu_, embedding, gelu, glu, grid_sample, group_norm, hardshrink,
    hardsigmoid, hardswish, hardtanh, instance_norm, interpolate, kl_div,
    l1_loss, label_smooth, layer_norm, leaky_relu, linear,
    local_response_norm, log_loss, log_sigmoid, log_softmax,
    margin_ranking_loss, max_pool1d, max_pool2d, max_pool3d, maxout, mish,
    mse_loss, nll_loss, normalize, npair_loss, one_hot, pixel_shuffle,
    prelu, relu, relu6, relu_, selu, sequence_mask, sigmoid,
    sigmoid_focal_loss, silu, smooth_l1_loss, softmax, softmax_,
    softmax_with_cross_entropy, softplus, softshrink, softsign,
    square_error_cost, swish, tanh, tanhshrink, temporal_shift,
    thresholded_relu, upsample,
)
from ...ops.sequence import (  # noqa: F401,E402
    sequence_expand, sequence_pad, sequence_pool, sequence_reverse,
    sequence_softmax, sequence_unpad,
)
