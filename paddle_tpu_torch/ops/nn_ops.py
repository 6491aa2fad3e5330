"""Neural-net ops of the port (reference ``paddle_tpu/ops/nn_ops.py``):
the activations, ``softmax``/``log_softmax``, ``linear``, ``layer_norm``,
``normalize``, the dropouts, dense ``embedding``, ``one_hot``, the
cross-entropies and the plain losses; the vision ops: the convolutions
and their transposes, the max, average and adaptive pools in 1d, 2d and
3d, the batch, group and instance norms and ``local_response_norm``,
``interpolate``, ``pixel_shuffle``, ``temporal_shift``, ``affine_grid``
and ``grid_sample``; the sequence losses ``ctc_loss`` (optax's CTC, not
torch's), ``hsigmoid_loss`` (the complete-binary-tree hierarchical
sigmoid) and the beam backtrace ``gather_tree``.

Each op is a torch function registered with the core's dispatcher and
takes the eager core's Tensors. ``linear`` is ``x @ W + b`` with W
``[in, out]``, Paddle's layout (not ``F.linear``'s). Its product, and the
logits product before a loss, are plain large matmuls that the reference
also leaves to XLA, so they stay ``torch.matmul`` and no kernel is
written for them; the softmax, ``layer_norm``, ``gelu`` and the losses
are plain torch likewise. The reference computes the vision ops in XLA
too (``lax.conv_general_dilated``, window slices, ``jnp`` bodies), with
no Pallas kernel: the convolutions are ``F.conv*`` (cuDNN on the card),
the rest plain torch written as the reference writes it, so that ties,
rounding and padding come out the same (see each op).

``dropout`` and ``cross_entropy`` also take plain torch tensors, the
GPT's, the engine's and AMP's path: there ``dropout`` draws from
``generator`` and ``cross_entropy`` is the hard-label mean over
``[N, C]`` logits. Every mask is drawn from an explicit generator (the
caller's, or the port's default generator for the tensor's device),
never from torch's global one.
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..amp.auto_cast import amp_state, cast_inputs, op_body, resume
from ..core import lazy, rng
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
# the reference's softplus_ is this plain softplus, not an in-place op
softplus_ = _act("softplus", _softplus)
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


def fc_flatten(x, num_flatten_dims):
    """fc's input as ``[.., in_features]`` (reference
    ``nn_ops.fc_flatten``, the shared input normalisation of
    ``static.nn.fc`` and ``fluid.layers.fc``): the dims from
    ``num_flatten_dims`` on flatten into the features, with 1 <=
    ``num_flatten_dims`` <= rank - 1 and concrete non-batch leading dims.
    Returns ``(flattened_x, in_features)``."""
    from . import manipulation
    rank = len(x.shape)
    if not 1 <= num_flatten_dims <= rank - 1:
        raise ValueError(
            f"fc: num_flatten_dims must be in [1, {rank - 1}] for a "
            f"rank-{rank} input, got {num_flatten_dims}")
    trailing = [int(s) for s in x.shape[num_flatten_dims:]]
    if any(d < 0 for d in trailing):
        raise ValueError(
            f"fc: trailing (feature) dims must be concrete, got "
            f"{tuple(x.shape)}")
    in_dim = int(np.prod(trailing))
    if rank == num_flatten_dims + 1:
        return x, in_dim
    lead = [int(s) for s in x.shape[1:num_flatten_dims]]
    if any(d < 0 for d in lead):
        raise ValueError(
            "fc: leading dims beyond the batch must be concrete when "
            f"num_flatten_dims > 1, got {tuple(x.shape)}")
    return manipulation.reshape(x, (-1, *lead, in_dim)), in_dim


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in_features,
    out_features]``, not transposed (Paddle's layout; reference
    nn_ops.py:231)."""
    return _linear(x, weight, bias)


@register_op("layer_norm")
def _layer_norm(x, scale, bias, *, epsilon, begin_norm_axis):
    """A bf16 input with f32 weights (an O1 white-list op's output into
    the black-listed norm) runs at the wider dtype, as the reference's
    jnp body promotes them."""
    shape = tuple(x.shape[begin_norm_axis:])
    dt = x.dtype
    for t in (scale, bias):
        if t is not None and t.dtype != dt:
            dt = torch.promote_types(dt, t.dtype)
    x, scale, bias = (None if t is None else t.to(dt)
                      for t in (x, scale, bias))
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


# ---- sequence losses: CTC and the hierarchical sigmoid -------------------------

# optax's numerically stable stand-in for log(0)
_CTC_LOG_EPS = -1e5


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """Reference ``ctc_loss`` (nn_ops.py:1684-1712) over ``warpctc``,
    which is ``optax.ctc_loss``, not ``F.ctc_loss``: the scores
    ``[T, B, C]`` go through ``log_softmax`` inside (so unnormalised
    scores are valid input), log(0) is ``-1e5`` (an infeasible row costs
    about 1e5 where ``F.ctc_loss`` gives inf), and ``"mean"`` divides
    each loss by its label length, with no clamp, before the mean; the
    loss is f64, as the reference's alphas are. ``norm_by_times`` is
    taken and not read. The grads reach ``log_probs`` (the reference's
    ``ctc_loss`` re-wraps its input and stops them; its op ``warpctc``
    has the grads this one has)."""
    out = _ctc_op(log_probs, labels, input_lengths, label_lengths,
                  blank=int(blank))
    if reduction == "mean":
        from . import math as math_ops
        from . import reduction as red_ops
        ll = label_lengths if isinstance(label_lengths, Tensor) \
            else Tensor(np.asarray(label_lengths), place=out.place)
        return red_ops.mean(math_ops.divide(
            out, math_ops.cast(ll, out.dtype)))
    return _reduce(out, reduction)


def _ctc_emit_gather(logprobs, labels):
    """``einsum('btk,bnk->btn', logprobs, one_hot(labels))`` as a gather:
    the log-probability of each label at each step, 0 for a label
    outside ``[0, K)`` (a row of ``jax.nn.one_hot`` is then 0)."""
    k = logprobs.shape[-1]
    valid = (labels >= 0) & (labels < k)
    idx = torch.where(valid, labels, torch.zeros_like(labels)).long()
    b, t_max = logprobs.shape[:2]
    got = torch.gather(logprobs, 2, idx[:, None, :].expand(
        b, t_max, idx.shape[1]))
    return torch.where(valid[:, None, :], got, torch.zeros_like(got))


@register_op("warpctc")
def _ctc_op(log_probs, labels, input_lengths, label_lengths, *, blank):
    """``optax.ctc_loss_with_forward_probs``'s recursion in plain torch:
    blank (phi) and label (emit) log-alphas, a loop over T vectorised
    over the batch and the labels, autograd for the grads. The alphas
    are f64, as the reference's (it runs JAX with x64 on, so optax's
    ``jnp.ones`` start them in f64); the log-softmax stays in the input's
    dtype, as there."""
    logits = log_probs.transpose(0, 1)                     # [B, T, C]
    b, t_max, _ = logits.shape
    n = labels.shape[1]
    pdt = logits.dtype
    logit_pad = (torch.arange(t_max, device=logits.device)[None, :]
                 >= input_lengths[:, None]).to(pdt)       # [B, T]
    label_pad = (torch.arange(n, device=logits.device)[None, :]
                 >= label_lengths[:, None]).to(pdt)       # [B, N]
    labels = labels.to(torch.int32)
    logprobs = torch.log_softmax(logits, dim=-1)
    adt = torch.promote_types(pdt, torch.float64)
    labellens = n - label_pad.sum(1).to(torch.int32)
    repeat = (labels[:, :-1] == labels[:, 1:]).to(torch.float32)
    repeat = F.pad(repeat, (0, 1))
    lp_phi = logprobs[:, :, blank:blank + 1].transpose(0, 1)    # [T, B, 1]
    lp_emit = _ctc_emit_gather(logprobs.to(adt), labels).transpose(0, 1)
    eps = _CTC_LOG_EPS
    phi = torch.full((b, n + 1), eps, dtype=adt, device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), eps, dtype=adt, device=logits.device)

    def add_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)],
                         dim=-1)

    pads = logit_pad.transpose(0, 1)
    for t in range(t_max):
        phi_orig = phi
        phi = add_phi(phi, emit + eps * repeat)
        next_emit = torch.logaddexp(phi[:, :-1] + lp_emit[t],
                                    emit + lp_emit[t])
        next_phi = add_phi(phi + lp_phi[t],
                           emit + lp_phi[t] + eps * (1.0 - repeat))
        pad = pads[t].reshape(b, 1)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * phi_orig + (1.0 - pad) * next_phi
    phi_last = add_phi(phi, emit)
    pick = (labellens[:, None] == torch.arange(
        n + 1, device=logits.device)).to(phi_last.dtype)
    return -(phi_last * pick).sum(-1)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Reference ``hierarchical_sigmoid_op`` over the default complete
    binary tree (nn_ops.py:1729-1763): per sample ``[N, 1]``, the summed
    log-sigmoid cross-entropies of the internal nodes on its class's
    path. A custom tree (``path_table``/``path_code``) raises, as there;
    ``is_sparse`` is taken and not read."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "custom-tree hsigmoid (path_table/path_code) is not supported")
    return _hsigmoid(input, label, weight, bias,
                     num_classes=int(num_classes))


@register_op("hsigmoid_op")
def _hsigmoid(x, label, weight, bias, *, num_classes):
    # class c's path: node (c + num_classes) >> k for k from the code
    # length down to 1, the bit below it the target; nodes past the
    # num_classes - 1 internal ones are inactive
    code_len = int(np.ceil(np.log2(num_classes)))
    c = label.reshape(-1) + num_classes
    losses = torch.zeros(c.shape, dtype=x.dtype, device=x.device)
    for k in range(code_len, 0, -1):
        node = c >> k
        bit = ((c >> (k - 1)) & 1).to(x.dtype)
        active = (node >= 1) & (node - 1 < num_classes - 1)
        nidx = torch.clamp(node - 1, 0, num_classes - 2).long()
        logit = (x * weight[nidx]).sum(-1)
        if bias is not None:
            logit = logit + bias.reshape(-1)[nidx]
        ce = -(bit * F.logsigmoid(logit) + (1 - bit) * F.logsigmoid(-logit))
        losses = losses + torch.where(active, ce, torch.zeros_like(ce))
    return losses.reshape(tuple(label.shape[:1]) + (1,))


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


# ---- convolutions ----------------------------------------------------------------

def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _same_pads(sizes, ksize, strides, dilations):
    """XLA's ``SAME`` padding: the output is ``ceil(in / stride)`` and
    the larger half of the padding goes at the end."""
    pads = []
    for n, k, s, d in zip(sizes, ksize, strides, dilations):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _conv_nd(x, w, b, strides, pads, dilations, groups):
    """``F.conv{1,2,3}d`` of channels-first ``x`` with ``(lo, hi)`` pads a
    spatial dim: symmetric pads go to the conv, others to ``F.pad``."""
    conv = (F.conv1d, F.conv2d, F.conv3d)[x.dim() - 3]
    if any(lo != hi for lo, hi in pads):
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        x = F.pad(x, flat)
        pads = [(0, 0)] * len(pads)
    return conv(x, w, b, stride=strides, padding=tuple(lo for lo, _ in pads),
                dilation=dilations, groups=groups)


def _pads_of(paddings, x, w, strides, dilations):
    nd = w.dim() - 2
    if isinstance(paddings, str):
        if paddings == "VALID":
            return [(0, 0)] * nd
        if paddings != "SAME":
            raise ValueError(f"padding must be 'SAME', 'VALID' or numbers, "
                             f"got {paddings!r}")
        return _same_pads(x.shape[2:], w.shape[2:], strides, dilations)
    if len(paddings) == 2 * nd:
        return [(paddings[2 * i], paddings[2 * i + 1]) for i in range(nd)]
    return [(p, p) for p in paddings]


@register_op("conv2d")
def _conv2d(x, w, b, *, strides, paddings, dilations, groups, data_format):
    # the weight is OIHW for both data formats; NHWC features are
    # permuted around the channels-first conv
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    out = _conv_nd(x, w, b, strides,
                   _pads_of(paddings, x, w, strides, dilations), dilations,
                   groups)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """Reference ``conv2d`` (nn_ops.py:237-315): weight OIHW; ``padding``
    an int, a pair, ``[top, bottom, left, right]`` or XLA's ``"SAME"`` /
    ``"VALID"`` (SAME at stride > 1 pads the larger half at the end)."""
    if isinstance(padding, str):
        pad = padding.upper()
    elif isinstance(padding, (list, tuple)) and len(padding) == 4:
        pad = tuple(int(p) for p in padding)
    else:
        pad = _pair(padding)
    return _conv2d(x, weight, bias, strides=_pair(stride), paddings=pad,
                   dilations=_pair(dilation), groups=int(groups),
                   data_format=data_format)


@register_op("conv1d")
def _conv1d(x, w, b, *, stride, padding, dilation, groups):
    pads = _pads_of(padding if isinstance(padding, str) else (padding,),
                    x, w, (stride,), (dilation,))
    return _conv_nd(x, w, b, (stride,), pads, (dilation,), groups)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """``data_format`` is taken and, as in the reference, not read."""
    pad = padding.upper() if isinstance(padding, str) else int(padding)
    return _conv1d(x, weight, bias, stride=int(stride), padding=pad,
                   dilation=int(dilation), groups=int(groups))


@register_op("conv3d")
def _conv3d(x, w, b, *, strides, paddings, dilations, groups):
    return _conv_nd(x, w, b, strides,
                    _pads_of(paddings, x, w, strides, dilations), dilations,
                    groups)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    pad = padding.upper() if isinstance(padding, str) else _pair(padding, 3)
    x = _to_ncdhw(x, data_format)
    out = _conv3d(x, weight, bias, strides=_pair(stride, 3), paddings=pad,
                  dilations=_pair(dilation, 3), groups=int(groups))
    return _from_ncdhw(out, data_format)


def _conv_transpose(x, w, b, strides, paddings, output_padding, dilations,
                    groups):
    """The weight is ``[in, out/groups, *k]``, torch's own layout for a
    transposed conv, whose output length ``(in - 1) s - 2 p + d (k - 1)
    + op + 1`` is the reference's fractionally strided conv's."""
    conv = (F.conv_transpose1d, F.conv_transpose2d,
            F.conv_transpose3d)[x.dim() - 3]
    return conv(x, w, b, stride=strides, padding=paddings,
                output_padding=output_padding, groups=groups,
                dilation=dilations)


@register_op("conv2d_transpose")
def _conv2d_transpose(x, w, b, *, strides, paddings, output_padding,
                      dilations, groups):
    return _conv_transpose(x, w, b, strides, paddings, output_padding,
                           dilations, groups)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW", name=None):
    """``output_size`` and ``data_format`` are taken and, as in the
    reference (nn_ops.py:344-352), not read."""
    return _conv2d_transpose(x, weight, bias, strides=_pair(stride),
                             paddings=_pair(padding),
                             output_padding=_pair(output_padding),
                             dilations=_pair(dilation), groups=int(groups))


@register_op("conv_transpose_nd")
def _conv_transpose_nd(x, w, b, *, strides, paddings, output_padding,
                       dilations, groups):
    return _conv_transpose(x, w, b, strides, paddings, output_padding,
                           dilations, groups)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    """``output_size`` and ``data_format`` taken and not read."""
    def one(v):
        return (v if isinstance(v, int) else int(v[0]),)
    return _conv_transpose_nd(x, weight, bias, strides=one(stride),
                              paddings=one(padding),
                              output_padding=one(output_padding),
                              dilations=one(dilation), groups=int(groups))


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    """``output_size`` and ``data_format`` taken and not read."""
    return _conv_transpose_nd(x, weight, bias, strides=_pair(stride, 3),
                              paddings=_pair(padding, 3),
                              output_padding=_pair(output_padding, 3),
                              dilations=_pair(dilation, 3),
                              groups=int(groups))


# ---- pooling ---------------------------------------------------------------------
#
# The reference pools by slicing the window's strided views out of the
# padded input and reducing them elementwise (nn_ops.py:355-379), and so
# does the port: a max pool is a chain of torch.maximum over the views in
# window order, whose gradient splits a tie in halves down the chain as
# jnp.maximum's does (three equal values get 1/4, 1/4, 1/2), where
# F.max_pool2d gives it all to one element. The with-index pools and the
# adaptive max pools reduce a stack with amax, which splits a tie evenly,
# as jnp.max does; their masks take the first maximum.

def _neg_min(dtype):
    """The padding of a max pool: -inf for floats, the least integer
    otherwise (reference nn_ops.py:1268-1272)."""
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def _out_len(size, k, s, p, ceil_mode):
    if ceil_mode:
        return -(-(size + 2 * p - k) // s) + 1
    return (size + 2 * p - k) // s + 1


def _pool_views(x, ksize, strides, paddings, pad_value, ceil_mode=False):
    """The strided window views of ``x`` ([N, C, *spatial]), window
    position by position in row-major order; ``ceil_mode`` pads the end so
    that the partial windows exist."""
    sizes = x.shape[2:]
    outs = [_out_len(n, k, s, p, ceil_mode)
            for n, k, s, p in zip(sizes, ksize, strides, paddings)]
    need = [max(0, (o - 1) * s + k - (n + 2 * p))
            for o, s, k, n, p in zip(outs, strides, ksize, sizes, paddings)]
    if any(paddings) or any(need):
        flat = []
        for p, e in reversed(list(zip(paddings, need))):
            flat += [p, p + e]
        x = F.pad(x, flat, value=pad_value)
    for offs in np.ndindex(*ksize):
        idx = (slice(None), slice(None)) + tuple(
            slice(o, o + (n - 1) * s + 1, s)
            for o, n, s in zip(offs, outs, strides))
        yield x[idx]


def _max_chain(views):
    out = None
    for v in views:
        out = v if out is None else torch.maximum(out, v)
    return out


def _flat_mask(amax, ksize, strides, paddings, out_shape, in_shape):
    """Each maximum's flat index in the input's spatial volume from its
    row-major window slot ``amax``."""
    nd = len(ksize)
    flat = None
    rest = amax
    offs = []
    for k in reversed(ksize):
        offs.append(rest % k)
        rest = rest // k
    offs.reverse()
    for d in range(nd):
        shape = [1] * nd
        shape[d] = out_shape[d]
        base = torch.arange(out_shape[d], device=amax.device).reshape(shape)
        pos = base * strides[d] - paddings[d] + offs[d]
        flat = pos if flat is None else flat * in_shape[d] + pos
    return flat.to(torch.int32)


@register_op("pool2d_max")
def _max_pool2d(x, *, ksize, strides, paddings, ceil_mode):
    return _max_chain(_pool_views(x, ksize, strides, paddings,
                                  _neg_min(x.dtype), ceil_mode))


def _max_pool_with_index(x, ksize, strides, paddings, ceil_mode):
    wins = torch.stack(list(_pool_views(x, ksize, strides, paddings,
                                        _neg_min(x.dtype), ceil_mode)))
    out = wins.amax(dim=0)
    amax = wins.detach().argmax(dim=0)
    return out, _flat_mask(amax, ksize, strides, paddings, out.shape[2:],
                           x.shape[2:])


@register_op("pool2d_max_with_index")
def _max_pool2d_with_index(x, *, ksize, strides, paddings, ceil_mode=False):
    return _max_pool_with_index(x, ksize, strides, paddings, ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    """``data_format`` is taken and, as in the reference, not read;
    ``return_mask`` adds each maximum's flat index in the input's
    ``h * w``, the first maximum of a window winning."""
    ks = _pair(kernel_size)
    st = _pair(stride) if stride is not None else ks
    op = _max_pool2d_with_index if return_mask else _max_pool2d
    return op(x, ksize=ks, strides=st, paddings=_pair(padding),
              ceil_mode=bool(ceil_mode))


def _exclusive_counts(sizes, ksize, strides, paddings, need, device, dtype):
    """The in-bounds cells of each window, counted as the reference does
    (nn_ops.py:424-446), on ``device``."""
    ones = torch.zeros((1, 1) + tuple(n + 2 * p + e for n, p, e in
                                      zip(sizes, paddings, need)))
    ones[(0, 0) + tuple(slice(p, p + n) for p, n in zip(paddings, sizes))] = 1
    outs = [(n + 2 * p + e - k) // s + 1 for n, p, e, k, s in
            zip(sizes, paddings, need, ksize, strides)]
    counts = torch.zeros((1, 1) + tuple(outs))
    for offs in np.ndindex(*ksize):
        counts += ones[(slice(None), slice(None)) + tuple(
            slice(o, o + (n - 1) * s + 1, s)
            for o, n, s in zip(offs, outs, strides))]
    return counts.clamp(min=1.0).to(device=device, dtype=dtype)


@register_op("pool2d_avg")
def _avg_pool2d(x, *, ksize, strides, paddings, exclusive):
    summed = None
    for v in _pool_views(x, ksize, strides, paddings, 0.0):
        summed = v if summed is None else summed + v
    if exclusive and (paddings[0] or paddings[1]):
        return summed / _exclusive_counts(x.shape[2:], ksize, strides,
                                          paddings, (0, 0), x.device,
                                          x.dtype)
    return summed / (ksize[0] * ksize[1])


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """``ceil_mode``, ``divisor_override`` and ``data_format`` are taken
    and, as in the reference (nn_ops.py:448-455), not read; ``exclusive``
    divides by the in-bounds cells only where there is padding."""
    ks = _pair(kernel_size)
    st = _pair(stride) if stride is not None else ks
    return _avg_pool2d(x, ksize=ks, strides=st, paddings=_pair(padding),
                       exclusive=bool(exclusive))


@register_op("adaptive_avg_pool2d")
def _adaptive_avg_pool2d(x, *, output_size):
    n, c, h, w = x.shape
    oh, ow = output_size
    if h % oh == 0 and w % ow == 0:
        return x.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    # the reference resizes where the bins do not divide
    # (nn_ops.py:464-465): jax.image.resize's antialiased linear
    return image_resize(x, (n, c, oh, ow), "linear")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """``data_format`` taken and not read."""
    return _adaptive_avg_pool2d(x, output_size=_pair(output_size))


def _check_divides(sizes, output_size, what):
    if any(n % o for n, o in zip(sizes, output_size)):
        raise ValueError(f"{what} takes only output sizes that divide the "
                         f"input's: {tuple(sizes)} by {tuple(output_size)}")


def _blocks(x, output_size):
    """[N, C, *out, prod(block)]: each output cell's block of the input."""
    nd = len(output_size)
    sizes = x.shape[2:]
    bs = [n // o for n, o in zip(sizes, output_size)]
    shape = list(x.shape[:2])
    for o, b in zip(output_size, bs):
        shape += [o, b]
    xb = x.reshape(shape)
    perm = [0, 1] + [2 + 2 * i for i in range(nd)] \
        + [3 + 2 * i for i in range(nd)]
    return xb.permute(perm).reshape(list(x.shape[:2]) + list(output_size)
                                    + [-1]), bs


@register_op("adaptive_max_pool2d")
def _adaptive_max_pool2d(x, *, output_size):
    _check_divides(x.shape[2:], output_size, "adaptive_max_pool2d")
    return _blocks(x, output_size)[0].amax(dim=-1)


def _adaptive_max_with_index(x, output_size, what):
    _check_divides(x.shape[2:], output_size, what)
    blocks, bs = _blocks(x, output_size)
    amax = blocks.detach().argmax(dim=-1)
    return blocks.amax(dim=-1), _flat_mask(amax, bs, bs, [0] * len(bs),
                                           output_size, x.shape[2:])


@register_op("adaptive_max_pool2d_with_index")
def _adaptive_max_pool2d_with_index(x, *, output_size):
    return _adaptive_max_with_index(x, output_size, "adaptive_max_pool2d")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """Only output sizes that divide the input's (the reference asserts
    it; the port raises ValueError)."""
    op = _adaptive_max_pool2d_with_index if return_mask \
        else _adaptive_max_pool2d
    return op(x, output_size=_pair(output_size))


def _squeeze2(out, return_mask):
    from . import manipulation
    if return_mask:
        return (manipulation.squeeze(out[0], axis=2),
                manipulation.squeeze(out[1], axis=2))
    return manipulation.squeeze(out, axis=2)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, name=None):
    """The 2d pool over ``[N, C, 1, L]``; ``ceil_mode`` taken and, as in
    the reference, not read. The mask of a ``[1, L]`` map is the index in
    L."""
    from . import manipulation
    x4 = manipulation.unsqueeze(x, axis=2)
    out = max_pool2d(x4, (1, kernel_size), (1, stride or kernel_size),
                     (0, padding if isinstance(padding, int)
                      else padding[0]), return_mask=return_mask)
    return _squeeze2(out, return_mask)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    """``ceil_mode`` taken and not read."""
    from . import manipulation
    x4 = manipulation.unsqueeze(x, axis=2)
    out = avg_pool2d(x4, (1, kernel_size), (1, stride or kernel_size),
                     (0, padding if isinstance(padding, int)
                      else padding[0]), exclusive=exclusive)
    return manipulation.squeeze(out, axis=2)


def adaptive_avg_pool1d(x, output_size, name=None):
    from . import manipulation
    x4 = manipulation.unsqueeze(x, axis=2)
    return manipulation.squeeze(
        adaptive_avg_pool2d(x4, (1, int(output_size))), axis=2)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    from . import manipulation
    x4 = manipulation.unsqueeze(x, axis=2)
    return _squeeze2(adaptive_max_pool2d(x4, (1, int(output_size)),
                                         return_mask=return_mask),
                     return_mask)


def _to_ncdhw(x, data_format):
    from . import manipulation
    if data_format == "NDHWC":
        return manipulation.transpose(x, (0, 4, 1, 2, 3))
    if data_format != "NCDHW":
        raise ValueError(f"pool3d: unknown data_format {data_format!r}")
    return x


def _from_ncdhw(x, data_format):
    from . import manipulation
    if data_format == "NDHWC":
        return manipulation.transpose(x, (0, 2, 3, 4, 1))
    return x


@register_op("pool3d")
def _pool3d(x, *, ksize, strides, paddings, mode, ceil_mode, exclusive,
            divisor):
    # the reference pads a 3d max pool with -inf whatever the dtype
    # (nn_ops.py:1405)
    pad_v = float("-inf") if mode == "max" else 0.0
    views = _pool_views(x, ksize, strides, paddings, pad_v, ceil_mode)
    if mode != "avg":
        return _max_chain(views)
    out = None
    for v in views:
        out = v if out is None else out + v
    if divisor is not None:
        return out / divisor
    sizes = x.shape[2:]
    need = [max(0, (_out_len(n, k, s, p, ceil_mode) - 1) * s + k
                - (n + 2 * p))
            for n, k, s, p in zip(sizes, ksize, strides, paddings)]
    if exclusive and (any(paddings) or any(need)):
        return out / _exclusive_counts(sizes, ksize, strides, paddings,
                                       need, x.device, x.dtype)
    return out / (ksize[0] * ksize[1] * ksize[2])


@register_op("pool3d_max_with_index")
def _max_pool3d_with_index(x, *, ksize, strides, paddings, ceil_mode=False):
    return _max_pool_with_index(x, ksize, strides, paddings, ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    """NDHWC is transposed around the NCDHW pool, as in the reference;
    the mask is each maximum's flat index in the input's ``d * h * w``."""
    x = _to_ncdhw(x, data_format)
    ks = _pair(kernel_size, 3)
    st = _pair(stride, 3) if stride is not None else ks
    pad3 = _pair(padding, 3)
    if return_mask:
        out, mask = _max_pool3d_with_index(x, ksize=ks, strides=st,
                                           paddings=pad3,
                                           ceil_mode=bool(ceil_mode))
        return _from_ncdhw(out, data_format), _from_ncdhw(mask, data_format)
    out = _pool3d(x, ksize=ks, strides=st, paddings=pad3, mode="max",
                  ceil_mode=bool(ceil_mode), exclusive=True, divisor=None)
    return _from_ncdhw(out, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    x = _to_ncdhw(x, data_format)
    ks = _pair(kernel_size, 3)
    st = _pair(stride, 3) if stride is not None else ks
    out = _pool3d(x, ksize=ks, strides=st, paddings=_pair(padding, 3),
                  mode="avg", ceil_mode=bool(ceil_mode),
                  exclusive=bool(exclusive),
                  divisor=None if divisor_override is None
                  else float(divisor_override))
    return _from_ncdhw(out, data_format)


@register_op("adaptive_pool3d")
def _adaptive_pool3d(x, *, output_size, mode):
    _check_divides(x.shape[2:], output_size, f"adaptive_{mode}_pool3d")
    blocks = _blocks(x, output_size)[0]
    return blocks.amax(dim=-1) if mode == "max" else blocks.mean(dim=-1)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    """Only output sizes that divide the input's; ``data_format`` taken
    and not read."""
    return _adaptive_pool3d(x, output_size=_pair(output_size, 3),
                            mode="avg")


@register_op("adaptive_max_pool3d_with_index")
def _adaptive_max_pool3d_with_index(x, *, output_size):
    return _adaptive_max_with_index(x, output_size, "adaptive_max_pool3d")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_pool3d_with_index(
            x, output_size=_pair(output_size, 3))
    return _adaptive_pool3d(x, output_size=_pair(output_size, 3),
                            mode="max")


# ---- batch / group / instance norms ---------------------------------------------

def _channel_shape(x, axis):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return shape


def _affine(out, scale, bias, shape):
    if scale is not None:
        out = out * scale.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


@register_op("batch_norm_infer")
def _batch_norm_infer(x, mean, var, scale, bias, *, epsilon, channel_axis):
    shape = _channel_shape(x, channel_axis)
    inv = torch.rsqrt(var.reshape(shape) + epsilon)
    return _affine((x - mean.reshape(shape)) * inv, scale, bias, shape)


@register_op("batch_norm_train")
def _batch_norm_train(x, scale, bias, *, epsilon, channel_axis):
    """The batch's mean and biased variance (``jnp.var``), then
    ``(x - mean) * rsqrt(var + eps) * scale + bias`` in the reference's
    order (nn_ops.py:597-611)."""
    axes = tuple(i for i in range(x.dim()) if i != channel_axis)
    mean = x.mean(dim=axes)
    var = x.var(dim=axes, unbiased=False)
    shape = _channel_shape(x, channel_axis)
    inv = torch.rsqrt(var.reshape(shape) + epsilon)
    out = _affine((x - mean.reshape(shape)) * inv, scale, bias, shape)
    return out, mean, var


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Reference ``batch_norm`` (nn_ops.py:613-631). Out of training, or
    with ``use_global_stats``, it normalizes by the running statistics
    (``batch_norm_infer``); in training by the batch's, and then updates
    the running ones in place: ``running * momentum + batch * (1 -
    momentum)`` with the biased batch variance (``F.batch_norm`` would take
    ``1 - momentum`` and the unbiased one). The update is written without
    autograd, so no buffer holds a step's graph."""
    ch_axis = 1 if data_format[1] == "C" or data_format == "NCL" \
        else x.ndim - 1
    if use_global_stats is None:
        use_global_stats = not training
    if not training or use_global_stats:
        return _batch_norm_infer(x, running_mean, running_var, weight, bias,
                                 epsilon=float(epsilon),
                                 channel_axis=ch_axis)
    out, batch_mean, batch_var = _batch_norm_train(
        x, weight, bias, epsilon=float(epsilon), channel_axis=ch_axis)
    if running_mean is not None:
        m = float(momentum)
        for running, batch in ((running_mean, batch_mean),
                               (running_var, batch_var)):
            if batch._symbolic:
                # building a static program: one recorded op reads the
                # buffer as a persistable at each run, and its record
                # writes the buffer back at the run's end (``running * m``
                # alone would run now, on no Variable, and freeze the
                # buffer's value at build into the program)
                running.value = _running_stat(running, batch, momentum=m)
            elif not _defer_running_update(running, batch, m):
                with torch.no_grad():
                    running.set_value(running._value * m
                                      + batch._value * (1 - m))
    return out


@register_op("batch_norm_running_stat", differentiable=False)
def _running_stat(running, batch, *, momentum):
    return running * momentum + batch * (1 - momentum)


def _defer_running_update(running, batch, m):
    """Under lazy eager, ``running <- running * m + batch * (1 - m)`` as
    one deferred write, computed as the eager update computes it (the
    same torch calls, under the ``auto_cast`` state of the moment); False
    when the batch statistic is not pending."""
    if type(batch._v) is not lazy.LazyArray or not lazy.enabled():
        return False
    amp = amp_state()

    def write(r, b):
        with torch.no_grad():
            if amp is None:
                r.copy_(r * m + b * (1 - m))
            else:
                with resume(amp):
                    r.copy_(r * m + b * (1 - m))

    lazy.dispatch(write, ("batch_norm_running", m, amp),
                  [running._v, batch._v], owners=[running, None],
                  writer=True, bound=(0,), device=running._v.device)
    return True


@register_op("group_norm")
def _group_norm(x, scale, bias, *, groups, epsilon):
    n, c = x.shape[0], x.shape[1]
    spatial = tuple(x.shape[2:])
    xg = x.reshape((n, groups, c // groups) + spatial)
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = xg.var(dim=axes, unbiased=False, keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    return _affine(out, scale, bias, (1, c) + (1,) * len(spatial))


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW", name=None):
    """``data_format`` taken and not read."""
    return _group_norm(x, weight, bias, groups=int(num_groups),
                       epsilon=float(epsilon))


@register_op("instance_norm")
def _instance_norm(x, scale, bias, *, epsilon):
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    return _affine(out, scale, bias, (1, x.shape[1]) + (1,) * (x.dim() - 2))


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, training=True, momentum=0.9, epsilon=1e-5,
                  data_format="NCHW", name=None):
    """Each sample's own statistics; ``running_mean``, ``running_var``,
    ``training``, ``momentum`` and ``data_format`` are taken and, as in
    the reference (nn_ops.py:672-675), not read."""
    return _instance_norm(x, weight, bias, epsilon=float(epsilon))


@register_op("local_response_norm")
def _lrn(x, *, size, alpha, beta, k):
    half = size // 2
    pad = [0, 0] * (x.dim() - 2) + [half, size - half - 1]
    sq = F.pad(x.square(), pad)
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = acc + sq[:, i:i + x.shape[1]]
    return x / torch.pow(k + alpha * acc, beta)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """Across channels (axis 1); ``data_format`` taken and not read."""
    return _lrn(x, size=int(size), alpha=float(alpha), beta=float(beta),
                k=float(k))


# ---- resampling ------------------------------------------------------------------

def _triangle(t):
    return torch.clamp(1.0 - t.abs(), min=0.0)


def _keys_cubic(t):
    # Keys' cubic with a = -0.5, jax.image's kernel
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, torch.zeros_like(t), out)


def _resize_weights(in_len, out_len, kernel, device):
    """``jax.image.resize``'s weight matrix ``[in, out]`` for one axis
    (its ``compute_weight_mat``): half-pixel centres, the kernel widened
    by the shrink factor (antialiasing), each column normalized, and 0
    for an output whose centre falls outside the input."""
    inv_scale = 1.0 / (out_len / in_len)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_len, dtype=torch.float32, device=device)
               + 0.5) * inv_scale - 0.5)
    dist = (sample[None, :] - torch.arange(in_len, dtype=torch.float32,
                                           device=device)[:, None]).abs()
    w = kernel(dist / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_len - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def image_resize(x, shape, method="linear"):
    """``jax.image.resize(x, shape, method)`` for ``"linear"`` and
    ``"cubic"``, with its default ``antialias=True``, in plain torch:
    separable scale-and-translate contractions, one axis after the
    other, whose kernels (triangle; Keys' cubic with a = -0.5) widen by
    the factor an axis shrinks by. ``F.interpolate`` neither antialiases
    nor takes this cubic (its a is -0.75), and ``F.adaptive_avg_pool2d``
    averages bins. The reference calls it for non-aligned interpolation,
    adaptive average pooling over bins that do not divide, and
    ``transforms.Resize``."""
    kernel = {"linear": _triangle, "cubic": _keys_cubic}[method]
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.dim():
        raise ValueError(f"shape {shape} does not match the input's rank "
                         f"{x.dim()}")
    for d in range(x.dim()):
        if shape[d] != x.shape[d]:
            w = _resize_weights(x.shape[d], shape[d], kernel,
                                x.device).to(x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


def _axis_resize(x, axis, out_len, kind, align_corners):
    """One axis of the reference's own resize (nn_ops.py:1112-1161):
    corner-aligned positions ``i (in - 1) / (out - 1)``, or half-pixel
    ones; nearest rounds half up when aligned and takes ``floor(i in /
    out)`` when not; the cubic is a = -0.75."""
    in_len = x.shape[axis]
    if out_len == in_len:
        return x
    ar = torch.arange(out_len, dtype=torch.float32, device=x.device)
    if align_corners:
        ratio = (in_len - 1) / (out_len - 1) if out_len > 1 else 0.0
        pos = ar * ratio
    else:
        pos = (ar + 0.5) * (in_len / out_len) - 0.5
    if kind == "nearest":
        if align_corners:
            idx = torch.floor(pos + 0.5)
        else:
            idx = torch.floor(ar * (in_len / out_len))
        return x.index_select(axis, idx.clamp(0, in_len - 1).long())
    base = torch.floor(pos)
    shape = [1] * x.dim()
    shape[axis] = out_len
    frac = (pos - base).to(x.dtype).reshape(shape)

    def take(off):
        return x.index_select(axis, (base + off).clamp(0, in_len - 1).long())

    if kind == "linear":
        return take(0) * (1 - frac) + take(1) * frac
    a = -0.75

    def w0(t):
        return ((a + 2) * t - (a + 3)) * t * t + 1

    def w1(t):
        return ((a * t - 5 * a) * t + 8 * a) * t - 4 * a

    weights = [w1(frac + 1), w0(frac), w0(1 - frac), w1(2 - frac)]
    out = None
    for off, wt in zip((-1, 0, 1, 2), weights):
        term = take(off) * wt
        out = term if out is None else out + term
    return out


_INTERP_KIND = {"nearest": "nearest", "bilinear": "linear",
                "linear": "linear", "trilinear": "linear",
                "bicubic": "cubic"}


@register_op("interpolate")
def _interp(x, *, size, method, align_corners):
    kind = _INTERP_KIND[method]
    if align_corners or method == "nearest":
        out = x
        for i, s in enumerate(size):
            out = _axis_resize(out, 2 + i, int(s), kind, bool(align_corners))
        return out
    return image_resize(x, tuple(x.shape[:2]) + tuple(size), kind)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Reference ``interpolate`` (nn_ops.py:1163-1201): aligned modes and
    ``nearest`` take the reference's own separable resize, the other
    linear and cubic modes ``jax.image.resize``'s antialiased one
    (``image_resize``). ``align_mode`` and ``data_format`` are taken and
    not read."""
    if size is None:
        spatial = x.shape[2:]
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(spatial)
        size = tuple(int(s * f) for s, f in zip(spatial, scale_factor))
    else:
        if isinstance(size, Tensor):
            size = size.tolist()
        size = tuple(int(s) for s in size)
    return _interp(x, size=size, method=mode,
                   align_corners=bool(align_corners))


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, name=None):
    return interpolate(x, size, scale_factor, mode, align_corners)


@register_op("pixel_shuffle")
def _pixel_shuffle(x, *, upscale_factor):
    n, c, h, w = x.shape
    r = upscale_factor
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """``data_format`` taken and not read."""
    return _pixel_shuffle(x, upscale_factor=int(upscale_factor))


@register_op("temporal_shift")
def _temporal_shift(x, *, seg_num, shift_ratio):
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([xr[:, 1:, :fold], torch.zeros_like(xr[:, :1, :fold])],
                     dim=1)
    right = torch.cat([torch.zeros_like(xr[:, :1, fold:2 * fold]),
                       xr[:, :-1, fold:2 * fold]], dim=1)
    return torch.cat([left, right, xr[:, :, 2 * fold:]],
                     dim=2).reshape(nt, c, h, w)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _temporal_shift(x, seg_num=int(seg_num),
                           shift_ratio=float(shift_ratio))


@register_op("affine_grid_op")
def _affine_grid(theta, *, out_shape, align_corners):
    n, _, h, w = out_shape
    dev = theta.device
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
    else:
        ys = (torch.arange(h, device=dev) + 0.5) * 2.0 / h - 1.0
        xs = (torch.arange(w, device=dev) + 0.5) * 2.0 / w - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    base = base.reshape(1, h * w, 3).expand(n, h * w, 3).to(theta.dtype)
    return torch.einsum("nhk,nck->nhc", base, theta).reshape(n, h, w, 2)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The ``[N, H, W, 2]`` sampling grid of ``[N, 2, 3]`` affine
    matrices (reference affine_grid_op)."""
    sh = [int(s) for s in (out_shape.tolist() if isinstance(out_shape, Tensor)
                           else out_shape)]
    return _affine_grid(theta, out_shape=tuple(sh),
                        align_corners=bool(align_corners))


def _grid_nodes(coord, size, order, padding_mode):
    """``jax.scipy.ndimage.map_coordinates``'s taps on one axis: a list of
    (index into the axis, valid, weight)."""
    if order == 1:
        lower = torch.floor(coord)
        upper_w = coord - lower
        idx = lower.long()
        nodes = [(idx, 1 - upper_w), (idx + 1, upper_w)]
    else:
        # lax.round: half away from zero
        idx = (torch.sign(coord) * torch.floor(coord.abs() + 0.5)).long()
        nodes = [(idx, None)]
    out = []
    for idx, w in nodes:
        if padding_mode == "zeros":
            valid = (idx >= 0) & (idx < size)
            fixed = idx.clamp(0, size - 1)
        elif padding_mode == "border":
            valid, fixed = None, idx.clamp(0, size - 1)
        else:   # "reflection": scipy's mirror, d c b | a b c d | c b a
            s = size - 1
            valid = None
            fixed = (torch.remainder(idx + s, 2 * s) - s).abs() if s > 0 \
                else torch.zeros_like(idx)
        out.append((fixed, valid, w))
    return out


@register_op("grid_sampler")
def _grid_sample(x, grid, *, mode, padding_mode, align_corners):
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1.0) * (w - 1) / 2.0
        fy = (gy + 1.0) * (h - 1) / 2.0
    else:
        fx = ((gx + 1.0) * w - 1.0) / 2.0
        fy = ((gy + 1.0) * h - 1.0) / 2.0
    out_hw = fx.shape[1:]
    fx, fy = fx.reshape(n, -1), fy.reshape(n, -1)
    order = 1 if mode == "bilinear" else 0
    flat = x.reshape(n, c, h * w)
    out = None
    for iy, vy, wy in _grid_nodes(fy, h, order, padding_mode):
        for ix, vx, wx in _grid_nodes(fx, w, order, padding_mode):
            idx = (iy * w + ix)[:, None, :].expand(n, c, iy.shape[1])
            val = torch.gather(flat, 2, idx)
            if vy is not None:
                val = torch.where((vy & vx)[:, None, :], val,
                                  torch.zeros_like(val))
            if wy is not None:
                val = (wy * wx)[:, None, :] * val
            out = val if out is None else out + val
    return out.to(x.dtype).reshape((n, c) + tuple(out_hw))


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """``x`` ``[N, C, H, W]`` sampled at ``grid`` ``[N, Ho, Wo, 2]``
    (normalized x, y), as the reference's ``map_coordinates``: bilinear
    for ``"bilinear"``, nearest (half away from zero) for any other mode;
    ``"zeros"`` drops each tap outside, ``"border"`` clamps,
    ``"reflection"`` mirrors about the edge cells."""
    return _grid_sample(x, grid, mode=mode, padding_mode=padding_mode,
                        align_corners=bool(align_corners))


# ---- beam search ---------------------------------------------------------------

def gather_tree(ids, parents):
    """Reference ``gather_tree_op``: back-trace beam-search parent
    pointers ``[T, B, beam]`` into whole sequences. Not
    differentiable."""
    return _gather_tree(ids, parents)


@register_op("gather_tree_op", differentiable=False)
def _gather_tree(ids, parents):
    beams = torch.arange(ids.shape[2], device=ids.device).expand(
        tuple(ids.shape[1:]))
    parents = parents.long()
    out = torch.empty_like(ids)
    for t in range(ids.shape[0] - 1, -1, -1):
        out[t] = torch.gather(ids[t], -1, beams)
        beams = torch.gather(parents[t], -1, beams)
    return out
