"""Loss layers (a port of ``paddle_tpu/nn/layer/loss.py``)."""
from ..layer_base import Layer
from ...ops import nn_ops


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax

    def forward(self, input, label):  # noqa: A002
        return nn_ops.cross_entropy(input, label, weight=self.weight,
                                    ignore_index=self.ignore_index,
                                    reduction=self.reduction,
                                    soft_label=self.soft_label,
                                    axis=self.axis,
                                    use_softmax=self.use_softmax)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return nn_ops.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return nn_ops.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return nn_ops.nll_loss(input, label, ignore_index=self.ignore_index,
                               reduction=self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return nn_ops.binary_cross_entropy(input, label, self.weight,
                                           self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return nn_ops.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):  # noqa: A002
        return nn_ops.smooth_l1_loss(input, label, self.reduction, self.delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return nn_ops.kl_div(input, label, self.reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):  # noqa: A002
        return nn_ops.margin_ranking_loss(input, other, label, self.margin,
                                          self.reduction)


class CTCLoss(Layer):
    """Reference ``CTCLoss`` over ``warpctc`` (optax's CTC);
    ``norm_by_times`` is taken and not read."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return nn_ops.ctc_loss(log_probs, labels, input_lengths,
                               label_lengths, blank=self.blank,
                               reduction=self.reduction)


class HSigmoidLoss(Layer):
    """Reference ``HSigmoidLoss``: the complete-binary-tree hierarchical
    sigmoid with a ``[num_classes - 1, feature_size]`` weight (Xavier, the
    default) and a zero bias; ``is_custom`` raises, ``is_sparse`` is
    taken and not read."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if is_custom:
            raise NotImplementedError("custom-tree hsigmoid not supported")
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            (num_classes - 1, feature_size), weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_classes - 1,), bias_attr, is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):  # noqa: A002
        return nn_ops.hsigmoid_loss(input, label, self.num_classes,
                                    self.weight, self.bias)
