"""Neural-net ops of the port (reference ``paddle_tpu/ops/nn_ops.py``):
the activations, ``softmax``/``log_softmax``, ``linear``, ``layer_norm``,
``normalize``, the dropouts, dense ``embedding``, ``one_hot``, the
cross-entropies and the plain losses. Conv, pooling, the batch, group
and instance norms, ``interpolate``, ``ctc_loss`` and ``hsigmoid_loss``
are not ported yet.

Each op is a torch function registered with the core's dispatcher and
takes the eager core's Tensors. ``linear`` is ``x @ W + b`` with W
``[in, out]``, Paddle's layout (not ``F.linear``'s). Its product, and the
logits product before a loss, are plain large matmuls that the reference
also leaves to XLA, so they stay ``torch.matmul`` and no kernel is
written for them; the softmax, ``layer_norm``, ``gelu`` and the losses
are plain torch likewise.

``dropout`` and ``cross_entropy`` also take plain torch tensors, the
GPT's, the engine's and AMP's path: there ``dropout`` draws from
``generator`` and ``cross_entropy`` is the hard-label mean over
``[N, C]`` logits. Every mask is drawn from an explicit generator (the
caller's, or the port's default generator for the tensor's device),
never from torch's global one.
"""
import torch
import torch.nn.functional as F

from ..amp.auto_cast import cast_inputs, op_body
from ..core import rng
from ..core.dispatch import register_op
from ..core.tensor import Tensor


# ---- activations ------------------------------------------------------------

def _act(name, fn):
    op = register_op(name)(fn)

    def api(x, name=None):
        return op(x)
    api.__name__ = name
    return api


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros_like(x))


relu = _act("relu", torch.relu)
relu6 = _act("relu6", lambda x: torch.clamp(x, 0.0, 6.0))
sigmoid = _act("sigmoid_act", torch.sigmoid)
tanh = _act("tanh_act", torch.tanh)
softsign = _act("softsign", lambda x: x / (1.0 + x.abs()))
silu = _act("silu", lambda x: x * torch.sigmoid(x))
swish = silu
mish = _act("mish", lambda x: x * torch.tanh(_softplus(x)))
hardswish = _act("hard_swish",
                 lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0)
hardsigmoid = _act("hard_sigmoid",
                   lambda x: torch.clamp(x / 6.0 + 0.5, 0.0, 1.0))
tanhshrink = _act("tanh_shrink", lambda x: x - torch.tanh(x))
log_sigmoid = _act("logsigmoid", F.logsigmoid)


@register_op("gelu")
def _gelu(x, *, approximate):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def gelu(x, approximate=False, name=None):
    """Exact (erf) by default; ``approximate=True`` is the tanh form."""
    return _gelu(x, approximate=bool(approximate))


@register_op("leaky_relu")
def _leaky_relu(x, *, alpha):
    return torch.where(x >= 0, x, alpha * x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return _leaky_relu(x, alpha=float(negative_slope))


@register_op("elu")
def _elu(x, *, alpha):
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))


def elu(x, alpha=1.0, name=None):
    return _elu(x, alpha=float(alpha))


@register_op("selu")
def _selu(x, *, scale, alpha):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _selu(x, scale=float(scale), alpha=float(alpha))


@register_op("celu")
def _celu(x, *, alpha):
    return F.celu(x, alpha=alpha)


def celu(x, alpha=1.0, name=None):
    return _celu(x, alpha=float(alpha))


@register_op("hardtanh")
def _hardtanh(x, *, mn, mx):
    return torch.clamp(x, mn, mx)


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return _hardtanh(x, mn=float(min), mx=float(max))


@register_op("hard_shrink")
def _hardshrink(x, *, threshold):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def hardshrink(x, threshold=0.5, name=None):
    return _hardshrink(x, threshold=float(threshold))


@register_op("soft_shrink")
def _softshrink(x, *, threshold):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold,
                                   torch.zeros_like(x)))


def softshrink(x, threshold=0.5, name=None):
    return _softshrink(x, threshold=float(threshold))


@register_op("softplus_full")
def _softplus_full(x, *, beta, threshold):
    scaled = beta * x
    return torch.where(scaled > threshold, x, _softplus(scaled) / beta)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return _softplus_full(x, beta=float(beta), threshold=float(threshold))


@register_op("thresholded_relu")
def _thresholded_relu(x, *, threshold):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def thresholded_relu(x, threshold=1.0, name=None):
    return _thresholded_relu(x, threshold=float(threshold))


@register_op("prelu")
def _prelu(x, weight, *, channel_axis):
    shape = [1] * x.dim()
    if weight.numel() > 1:
        shape[channel_axis] = weight.numel()
    return torch.where(x > 0, x, weight.reshape(shape) * x)


def prelu(x, weight, data_format="NCHW", name=None):
    axis = 1 if data_format[1] == "C" else x.ndim - 1
    return _prelu(x, weight, channel_axis=axis)


@register_op("softmax")
def _softmax(x, *, axis):
    return torch.softmax(x, dim=axis)


def softmax(x, axis=-1, dtype=None, name=None):
    """The softmax, then cast to ``dtype`` where one is given (the
    reference's order)."""
    out = _softmax(x, axis=int(axis))
    if dtype is not None:
        from . import math as math_ops
        out = math_ops.cast(out, dtype)
    return out


@register_op("log_softmax")
def _log_softmax(x, *, axis):
    return torch.log_softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    """``dtype`` is taken and, as in the reference, not read."""
    return _log_softmax(x, axis=int(axis))


@register_op("glu")
def _glu(x, *, axis):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def glu(x, axis=-1, name=None):
    return _glu(x, axis=int(axis))


@register_op("maxout_op")
def _maxout(x, *, groups, axis):
    shape = list(x.shape)
    c = shape[axis]
    if c % groups:
        raise ValueError(f"maxout: {c} channels do not divide into "
                         f"{groups} groups")
    new = shape[:axis] + [c // groups, groups] + shape[axis + 1:]
    return x.reshape(new).amax(dim=axis + 1)


def maxout(x, groups, axis=1, name=None):
    """Reference maxout_op: the max over ``groups`` consecutive
    channels."""
    return _maxout(x, groups=int(groups), axis=int(axis))


def _inplace(fn):
    def api(x, *args, **kwargs):
        x.set_value(fn(x, *args, **kwargs)._value)
        return x
    api.__name__ = fn.__name__ + "_"
    return api


relu_ = _inplace(relu)
elu_ = _inplace(elu)
softmax_ = _inplace(softmax)


# ---- linear / norms -----------------------------------------------------------

@register_op("linear")
def _linear(x, w, b):
    out = torch.matmul(x, w)
    if b is not None:
        out = out + b
    return out


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in_features,
    out_features]``, not transposed (Paddle's layout; reference
    nn_ops.py:231)."""
    return _linear(x, weight, bias)


@register_op("layer_norm")
def _layer_norm(x, scale, bias, *, epsilon, begin_norm_axis):
    shape = tuple(x.shape[begin_norm_axis:])
    return F.layer_norm(x, shape,
                        None if scale is None else scale.reshape(shape),
                        None if bias is None else bias.reshape(shape),
                        epsilon)


def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon=1e-5, name=None):
    """Normalizes the trailing dims that ``normalized_shape`` names (one
    when it is None): ``begin_norm_axis = x.ndim - len(shape)``, with the
    biased variance, as reference operators/layer_norm_op.cc."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    n_norm = len(normalized_shape) if normalized_shape else 1
    return _layer_norm(x, weight, bias, epsilon=float(epsilon),
                       begin_norm_axis=int(x.ndim - n_norm))


@register_op("l2_normalize")
def _normalize(x, *, p, axis, epsilon):
    if p == 2.0:
        nrm = x.square().sum(dim=axis, keepdim=True).sqrt()
    else:
        nrm = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(nrm, min=epsilon)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    return _normalize(x, p=float(p), axis=int(axis), epsilon=float(epsilon))


# ---- dropout -----------------------------------------------------------------

def _dropout_torch(x, p, training, mode, generator):
    """The dropout on a torch tensor (reference nn_ops.py:710-728): in
    training keep each element with probability ``1 - p``
    (``upscale_in_train`` divides the kept ones by it); out of training
    return ``x``, or with ``downscale_in_infer`` ``x * (1 - p)``."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return x * 0.0
    gen = generator if generator is not None \
        else rng.default_generator(x.device)
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    kept = x / keep if mode == "upscale_in_train" else x
    return torch.where(mask, kept, torch.zeros_like(x))


@register_op("dropout")
def _dropout_op(x, *, p, training, mode, generator):
    return _dropout_torch(x, p, training, mode, generator)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Reference ``dropout`` (nn_ops.py:719): ``axis`` is taken and, as
    there, not read. The mask is drawn from ``generator``, a
    ``torch.Generator`` on x's device, or the port's default generator
    for that device (``paddle_tpu_torch.seed``). A Tensor goes through
    the core's ``dropout`` op; a torch tensor (the GPT's) through the
    same function directly, cast as the op would be under
    ``amp.auto_cast``."""
    if isinstance(x, Tensor):
        return _dropout_op(x, p=float(p), training=bool(training), mode=mode,
                           generator=generator)
    if not training or p in (0.0, 1.0) \
            or mode not in ("upscale_in_train", "downscale_in_infer"):
        return _dropout_torch(x, p, training, mode, generator)
    (x,) = cast_inputs("dropout", x)
    with op_body():
        return _dropout_torch(x, p, training, mode, generator)


@register_op("dropout_nd")
def _dropout_nd(x, *, p, nd, generator):
    keep = 1.0 - p
    gen = generator if generator is not None \
        else rng.default_generator(x.device)
    mask_shape = tuple(x.shape[:2]) + (1,) * nd
    mask = torch.rand(mask_shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              generator=None):
    """Whole channels of ``[N, C, H, W]`` dropped (one draw per
    (n, c)), the kept ones divided by ``1 - p``."""
    if not training or p == 0.0:
        return x
    return _dropout_nd(x, p=float(p), nd=2, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              generator=None):
    """Whole channels of ``[N, C, D, H, W]`` dropped."""
    if not training or p == 0.0:
        return x
    return _dropout_nd(x, p=float(p), nd=3, generator=generator)


@register_op("alpha_dropout_op")
def _alpha_dropout(x, *, p, generator):
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = 1.0 - p
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    gen = generator if generator is not None \
        else rng.default_generator(x.device)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return a * torch.where(mask, x, torch.full_like(x, alpha_p)) + b


def alpha_dropout(x, p=0.5, training=True, name=None, generator=None):
    """SELU-preserving dropout: a dropped element becomes the SELU's
    negative saturation, then an affine map keeps the mean and variance
    (reference nn_ops.py:1560-1580)."""
    if not training or p == 0.0:
        return x
    return _alpha_dropout(x, p=float(p), generator=generator)


# ---- embedding / one_hot -------------------------------------------------------

@register_op("lookup_table_v2")
def _embedding(ids, weight, *, padding_idx, sparse=False):
    if sparse:
        # the table's grad is a sparse COO tensor over the looked-up
        # rows; torch's embedding backward drops the padding_idx rows
        out = F.embedding(ids.long(), weight, padding_idx=padding_idx,
                          sparse=True)
    else:
        out = F.embedding(ids.long(), weight)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids != padding_idx)[..., None], out,
                          torch.zeros_like(out))
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """The rows of ``weight`` at ``x``; the ``padding_idx`` positions
    give zeros (and no grad), as reference lookup_table_v2_op. With
    ``sparse=True`` the grad of ``weight`` is row-sparse (reference
    ``_embedding_sparse_grad``, nn_ops.py:754-830; SelectedRows): a
    sparse COO tensor on its torch leaf, which the core's ``.grad``
    wraps as a ``SparseGradTensor``, with no rows at ``padding_idx``;
    otherwise it is dense."""
    pi = None
    if padding_idx is not None:
        pi = int(padding_idx)
        if pi < 0:
            pi = weight.shape[0] + pi
    return _embedding(x, weight, padding_idx=pi, sparse=bool(sparse))


@register_op("one_hot_v2", differentiable=False)
def _one_hot(x, *, num_classes):
    classes = torch.arange(num_classes, device=x.device)
    return (x[..., None] == classes).to(torch.float32)


def one_hot(x, num_classes, name=None):
    """float32 one-hot rows; an index outside ``[0, num_classes)`` gives
    a row of zeros, as ``jax.nn.one_hot``."""
    return _one_hot(x, num_classes=int(num_classes))


# ---- losses --------------------------------------------------------------------

def _reduce(loss, reduction):
    from . import reduction as red_ops
    if reduction == "mean":
        return red_ops.mean(loss)
    if reduction == "sum":
        return red_ops.sum(loss)
    return loss


def _safe_label(label, ignore_index):
    return torch.where(label == ignore_index, torch.zeros_like(label), label)


@register_op("softmax_with_cross_entropy")
def _softmax_with_ce(logits, label, *, soft_label, axis, ignore_index):
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        return -(label * logp).sum(dim=axis, keepdim=True)
    lab = label
    if lab.dim() == logits.dim():
        lab = lab.squeeze(axis)
    gathered = torch.take_along_dim(
        logp, _safe_label(lab, ignore_index).long().unsqueeze(axis),
        dim=axis)
    mask = lab.unsqueeze(axis) != ignore_index
    return torch.where(mask, -gathered, torch.zeros_like(gathered))


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False, name=None):
    """The loss keeps a size-1 ``axis`` (reference nn_ops.py:862)."""
    loss = _softmax_with_ce(logits, label, soft_label=bool(soft_label),
                            axis=int(axis), ignore_index=int(ignore_index))
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


@register_op("nll_from_probs")
def _nll_from_probs(probs, label, *, axis):
    logp = torch.log(torch.clamp(probs, min=1e-30))
    lab = label
    if lab.dim() == probs.dim():
        lab = lab.squeeze(axis)
    return -torch.take_along_dim(logp, lab.long().unsqueeze(axis), dim=axis)


@register_op("valid_mask", differentiable=False)
def _valid_mask(label, *, ignore_index):
    return (label != ignore_index).to(torch.float32)


def _gather_weight(weight, label, soft_label, axis):
    from . import manipulation, math as math_ops, reduction as red_ops
    if soft_label:
        # the per-sample weight is <soft label, class weight>
        return red_ops.sum(math_ops.multiply(label, weight), axis=int(axis))
    return manipulation.gather(weight, label)


def _cross_entropy_tensor(input, label, weight, ignore_index,  # noqa: A002
                          reduction, soft_label, axis, use_softmax):
    """The reference's ``cross_entropy`` on Tensors, op for op
    (nn_ops.py:872-911): the loss squeezed on ``axis``; with ``weight``
    the mean divides by the sum of the gathered weights of the valid
    labels; the mean divides by ``max(n, 1e-12)``, so a batch with every
    label ignored gives 0."""
    from . import manipulation, math as math_ops, reduction as red_ops
    if use_softmax:
        loss = softmax_with_cross_entropy(input, label, soft_label=soft_label,
                                          ignore_index=ignore_index,
                                          axis=axis)
    else:
        loss = _nll_from_probs(input, label, axis=int(axis))
    loss = manipulation.squeeze(loss, axis=int(axis))
    if weight is not None:
        loss = math_ops.multiply(
            loss, _gather_weight(weight, label, soft_label, axis))
    if reduction == "mean":
        if not soft_label:
            valid = _valid_mask(label, ignore_index=int(ignore_index))
            s = red_ops.sum(loss)
            if weight is not None:
                n = red_ops.sum(math_ops.multiply(
                    _gather_weight(weight, label, soft_label, axis), valid))
            else:
                n = red_ops.sum(valid)
            return math_ops.divide(s, math_ops.maximum(n, 1e-12))
        if weight is not None:
            wsum = red_ops.sum(_gather_weight(weight, label, soft_label,
                                              axis))
            return math_ops.divide(red_ops.sum(loss),
                                   math_ops.maximum(wsum, 1e-12))
        return red_ops.mean(loss)
    if reduction == "sum":
        return red_ops.sum(loss)
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """Reference ``cross_entropy`` (nn_ops.py:872-911). Tensors take the
    reference's rules op for op (``_cross_entropy_tensor``). Torch
    tensors (the GPT's path) take hard labels over the last axis of
    ``[N, C]`` logits: rows whose label is ``ignore_index`` lose 0, and
    ``"mean"`` divides the sum by ``max(n_valid, 1e-12)``, so a batch
    with every row ignored gives a loss of 0 and zero grads, where
    ``F.cross_entropy``'s own mean gives NaN."""
    if isinstance(input, Tensor):
        return _cross_entropy_tensor(input, label, weight, ignore_index,
                                     reduction, bool(soft_label), int(axis),
                                     bool(use_softmax))
    if weight is not None or soft_label or axis not in (-1, 1) \
            or not use_softmax:
        raise NotImplementedError(
            "cross_entropy on torch tensors takes hard labels over the "
            "last axis; pass Tensors for weight, soft_label, axis or "
            "use_softmax=False")
    label = label.long()
    if reduction == "none":
        return F.cross_entropy(input, label, ignore_index=ignore_index,
                               reduction="none")
    total = F.cross_entropy(input, label, ignore_index=ignore_index,
                            reduction="sum")
    if reduction == "sum":
        return total
    if reduction != "mean":
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    # the count is f32, as the reference's valid mask (nn_ops.py:924):
    # a bf16 sum over it gives an f32 mean, as there
    n_valid = (label != ignore_index).sum().to(torch.float32)
    return total / n_valid.clamp(min=1e-12)


@register_op("mse_loss")
def _mse(x, y):
    return (x - y).square()


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce(_mse(input, label), reduction)


@register_op("l1_loss")
def _l1(x, y):
    return (x - y).abs()


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce(_l1(input, label), reduction)


@register_op("smooth_l1_loss")
def _smooth_l1(x, y, *, delta):
    diff = (x - y).abs()
    return torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    return _reduce(_smooth_l1(input, label, delta=float(delta)), reduction)


@register_op("bce_with_logits")
def _bce_logits(logits, label, pos_weight):
    # stable: max(x, 0) - x z + log(1 + exp(-|x|)), with pos_weight
    log_term = torch.log1p(torch.exp(-logits.abs()))
    if pos_weight is None:
        return torch.clamp(logits, min=0.0) - logits * label + log_term
    log_weight = (pos_weight - 1.0) * label + 1.0
    return (1.0 - label) * logits + log_weight * (
        log_term + torch.clamp(-logits, min=0.0))


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    from . import math as math_ops
    loss = _bce_logits(logit, label, pos_weight)
    if weight is not None:
        loss = math_ops.multiply(loss, weight)
    return _reduce(loss, reduction)


@register_op("bce")
def _bce(x, label):
    x = torch.clamp(x, 1e-12, 1.0 - 1e-12)
    return -(label * torch.log(x) + (1.0 - label) * torch.log1p(-x))


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean", name=None):
    from . import math as math_ops
    loss = _bce(input, label)
    if weight is not None:
        loss = math_ops.multiply(loss, weight)
    return _reduce(loss, reduction)


@register_op("nll_loss")
def _nll_loss(logp, label, *, ignore_index):
    g = torch.take_along_dim(
        logp, _safe_label(label, ignore_index).long()[:, None], dim=1)
    loss = -g.squeeze(1)
    return torch.where(label != ignore_index, loss, torch.zeros_like(loss))


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    """``weight`` is taken and, as in the reference, not read; the mean
    is over every row, ignored ones included, as there."""
    return _reduce(_nll_loss(input, label, ignore_index=int(ignore_index)),
                   reduction)


@register_op("kldiv_loss")
def _kl_div(x, label):
    return label * (torch.log(torch.clamp(label, min=1e-30)) - x)


def kl_div(input, label, reduction="mean", name=None):  # noqa: A002
    loss = _kl_div(input, label)
    if reduction == "batchmean":
        from . import math as math_ops, reduction as red_ops
        return math_ops.divide(red_ops.sum(loss), float(input.shape[0]))
    return _reduce(loss, reduction)


@register_op("square_error_cost")
def _square_error(x, y):
    return (x - y).square()


def square_error_cost(input, label):  # noqa: A002
    return _square_error(input, label)


@register_op("margin_ranking_loss")
def _margin_rank(x, y, label, *, margin):
    return torch.clamp(-label * (x - y) + margin, min=0.0)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    return _reduce(_margin_rank(input, other, label, margin=float(margin)),
                   reduction)


@register_op("cosine_similarity")
def _cos_sim(x1, x2, *, axis, eps):
    dot = (x1 * x2).sum(dim=axis)
    n1 = x1.square().sum(dim=axis).sqrt()
    n2 = x2.square().sum(dim=axis).sqrt()
    return dot / torch.clamp(n1 * n2, min=eps)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return _cos_sim(x1, x2, axis=int(axis), eps=float(eps))


@register_op("label_smooth")
def _label_smooth(label, *, epsilon):
    return label * (1.0 - epsilon) + epsilon / label.shape[-1]


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``prior_dist`` is taken and, as in the reference, not read: the
    prior is uniform."""
    return _label_smooth(label, epsilon=float(epsilon))


@register_op("bilinear_op")
def _bilinear(x1, x2, weight, bias):
    out = torch.einsum("bi,kij,bj->bk", x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out


def bilinear(x1, x2, weight, bias=None, name=None):
    """Reference bilinear_tensor_product_op: ``out[b, k] = x1[b] @ W[k]
    @ x2[b] + bias[k]``."""
    return _bilinear(x1, x2, weight, bias)


@register_op("log_loss_op")
def _log_loss(x, label, *, epsilon):
    return (-label * torch.log(x + epsilon)
            - (1.0 - label) * torch.log(1.0 - x + epsilon))


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    return _log_loss(input, label, epsilon=float(epsilon))


@register_op("dice_loss_op")
def _dice_loss(x, label, *, epsilon):
    lab = label
    if lab.dim() == x.dim():
        lab = lab.squeeze(-1)
    oh = (lab[..., None] == torch.arange(x.shape[-1], device=x.device)).to(
        x.dtype)
    dims = tuple(range(1, x.dim()))
    inter = (x * oh).sum(dim=dims)
    union = x.sum(dim=dims) + oh.sum(dim=dims)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    return _dice_loss(input, label, epsilon=float(epsilon))


@register_op("npair_loss_op")
def _npair_loss(anchor, positive, labels, *, l2_reg):
    lab = labels.reshape(-1, 1)
    same = (lab == lab.T).to(anchor.dtype)
    same = same / torch.clamp(same.sum(dim=1, keepdim=True), min=1e-12)
    logp = torch.log_softmax(anchor @ positive.T, dim=1)
    xent = -(same * logp).sum(dim=1).mean()
    reg = l2_reg * ((anchor * anchor).sum()
                    + (positive * positive).sum()) / anchor.shape[0]
    return xent + reg


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    return _npair_loss(anchor, positive, labels, l2_reg=float(l2_reg))


@register_op("sigmoid_focal_loss_op")
def _sigmoid_focal_loss(logit, label, *, alpha, gamma):
    p = torch.sigmoid(logit)
    ce = -(label * F.logsigmoid(logit)
           + (1 - label) * F.logsigmoid(-logit))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    return a_t * ((1 - p_t) ** gamma) * ce


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum", name=None):
    """Reference sigmoid_focal_loss_op (RetinaNet's loss)."""
    out = _sigmoid_focal_loss(logit, label, alpha=float(alpha),
                              gamma=float(gamma))
    if normalizer is not None:
        from . import math as math_ops
        out = math_ops.divide(out, normalizer)
    return _reduce(out, reduction)


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    """``x``'s last dim laid on the diagonal of a new square of trailing
    dims (reference nn/functional/__init__.py:36; ``offset``, ``dim1``
    and ``dim2`` taken and, as there, not read). A new tensor, not
    differentiable, as there."""
    v = x._value.detach()
    return Tensor._wrap(torch.diag_embed(v))


def sequence_mask(lengths, maxlen=None, dtype="int64"):
    """``[..., maxlen]``: 1 where the position is below the length
    (reference fluid.layers.sequence_mask)."""
    from ..core import dtype as dtype_mod
    lv = lengths._value.detach()
    if maxlen is None:
        maxlen = int(lv.max())
    row = torch.arange(int(maxlen), device=lv.device)
    mask = row < lv[..., None]
    return Tensor._wrap(mask.to(dtype_mod.to_torch_dtype(dtype)))


# ---- normalization -------------------------------------------------------------

@register_op("spectral_norm_op")
def _spectral_norm(weight, u, v, *, dim, power_iters, eps):
    """Reference spectral_norm_op (nn_ops.py:534-557): a power iteration
    for the largest singular value of ``weight`` flattened around
    ``dim``; the new u and v are constants for the gradient (the
    reference's ``stop_gradient``), so they iterate on the detached
    matrix and only ``sigma = u . (W v)`` carries the grad."""
    perm = (dim,) + tuple(i for i in range(weight.dim()) if i != dim)
    mat = weight.permute(perm).reshape(weight.shape[dim], -1)
    fixed = mat.detach()

    def _l2(x):
        return x / (torch.linalg.vector_norm(x) + eps)

    uu, vv = u, v
    for _ in range(max(1, power_iters)):
        vv = _l2(fixed.t() @ uu)
        uu = _l2(fixed @ vv)
    sigma = uu @ (mat @ vv)
    return weight / sigma, uu, vv


def spectral_norm(weight, u, v, dim=0, power_iters=1, eps=1e-12,
                  name=None):
    """``(weight / sigma, u, v)``: the weight over its power-iteration
    estimate of its largest singular value, and the refreshed state."""
    return _spectral_norm(weight, u, v, dim=int(dim),
                          power_iters=int(power_iters), eps=float(eps))
