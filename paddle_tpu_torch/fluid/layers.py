"""fluid.layers compat — the op-assembly API (a port of
``paddle_tpu/fluid/layers.py``; reference python/paddle/fluid/layers/).
The heavily-used subset forwards to the modern functional ops; names
keep fluid's signatures (e.g. fc(input, size), reduce_mean,
cross_entropy with soft labels off).

The reference's few ops written in ``jax.numpy`` are torch functions
here, registered with ``core/dispatch.py`` under the reference's names
(``temporal_shift``, ``fsp_matrix``, ``add_position_encoding``,
``multiplex``, ``bpr_loss``), so they record into a static ``Program``
too. Host-side helpers (detection boxes, sequence slicing, metrics) read
a Tensor's value, which runs a pending lazy graph first. Parameters that
a layer function makes come from the port's initializers, which draw
from the ``core/rng`` generators.
"""
import os as _os

import numpy as np
import torch as _torch

from ..core.tensor import Parameter as _Parameter, Tensor

# paddle_tpu_torch package root, for separating user frames from
# framework frames in _reuse_key (trailing sep so a sibling dir sharing
# the prefix is not misclassified)
_PKG_ROOT = _os.path.dirname(
    _os.path.dirname(_os.path.abspath(__file__))) + _os.sep
# the jit/to_static machinery re-invokes the user body once per phase
# (eager/record/capture) from phase-specific lines, and the lazy
# executor flushes and replays from its own; frames at or above either
# are phase-variant and must not enter the reuse key
_PHASE_DIRS = (_PKG_ROOT + "jit" + _os.sep,
               _PKG_ROOT + "core" + _os.sep + "lazy.py")

import itertools as _itertools  # noqa: E402
import weakref as _weakref  # noqa: E402

_instance_tokens = _itertools.count()
# identity-keyed side table (NOT an instance attribute: copy.deepcopy
# of a module would carry an attribute over and alias the copy to the
# original's cached parameters; NOT a WeakKeyDictionary: that keys by
# __eq__/__hash__, so a Layer subclass defining __eq__ would crash or
# value-alias). id() keys are guarded against address recycling by a
# liveness check plus a weakref finalizer that evicts dead entries.
_instance_token_map = {}


def _instance_token(slf):
    key = id(slf)
    ent = _instance_token_map.get(key)
    if ent is not None and ent[0]() is slf:
        return ent[1]
    tok = next(_instance_tokens)

    def _evict(_ref, _key=key):
        _instance_token_map.pop(_key, None)

    _instance_token_map[key] = (_weakref.ref(slf, _evict), tok)
    return tok
from ..ops import (creation, linalg, manipulation, math as math_ops,
                   nn_ops, reduction)
from ..static import data  # noqa: F401


_builtin_range = range  # the fluid `range` layer shadows the builtin below

_layer_cache = {}


def clear_layer_cache():
    """Drop all implicitly-created fluid.layers parameters (frees them and
    resets call-site reuse — call between independent model builds)."""
    _layer_cache.clear()


def _reuse_key(name, config):
    """Parameter reuse for the eager replay of fluid code: the reference
    builds each layers.* call ONCE into a program; eager loops re-execute
    the python line each step, so the same call site (or explicit `name`)
    must map to the same parameters or nothing trains. Key: user name if
    given, else the USER portion of the call stack + config — two
    logically distinct layers built through a shared helper differ in an
    outer frame, so they do not alias. Framework-internal frames are
    excluded: under jit/to_static the machinery frames above the user
    body differ per phase (eager/record/compile), and keying on them
    would re-initialize the layer's parameters every pass. Pass `name`
    to share parameters deliberately."""
    if name is not None:
        return ("name", name) + config
    import sys

    from ..nn.layer_base import Layer as _Layer
    frames = []
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PHASE_DIRS):
            # jit/to_static runner: phase-variant — stop here so the
            # same call site keys identically across eager/record/
            # compile passes
            break
        if not fn.startswith(_PKG_ROOT):
            # keep user frames (outer frames distinguish layers built
            # through shared helpers); skip framework-internal ones
            frames.append((fn, f.f_lineno))
            slf = f.f_locals.get("self")
            if isinstance(slf, _Layer):
                # an nn.Layer method: the INSTANCE identity subsumes
                # everything above it — two module objects sharing
                # forward() code never alias (even called from one
                # line), and repeat calls on one instance from
                # different lines still reuse. A monotonic token in a
                # weak side table (not id(): CPython recycles freed
                # addresses; not an instance attribute: deepcopy would
                # carry it and alias the copy) provides the identity.
                frames.append(("<layer-instance>", _instance_token(slf)))
                break
        f = f.f_back
    return (tuple(frames),) + config


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Reference: fluid/layers/nn.py fc — creates (or reuses, see
    _reuse_key) a Linear over the flattened trailing dims."""
    from ..nn.layer.common import Linear
    from ..ops.nn_ops import fc_flatten
    x, in_features = fc_flatten(input, num_flatten_dims)
    key = _reuse_key(name, ("fc", in_features, size))
    layer = _layer_cache.get(key)
    if layer is None:
        layer = Linear(in_features, size, weight_attr=param_attr,
                       bias_attr=bias_attr)
        _layer_cache[key] = layer
    out = layer(x)
    if act is not None:
        out = _apply_act(out, act)
    return out


# activation names fluid layers may apply via act= (reference validates
# against the OpMaker activation registry; arbitrary callables like
# dropout must NOT be reachable through act=)
_ACT_NAMES = frozenset({
    "relu", "relu6", "sigmoid", "tanh", "softmax", "log_softmax", "gelu",
    "leaky_relu", "elu", "selu", "celu", "softplus", "softsign", "silu",
    "swish", "mish", "hardswish", "hardsigmoid", "hardtanh", "tanhshrink",
    "softshrink", "hardshrink", "exp", "square", "sqrt", "rsqrt", "abs",
    "reciprocal", "log", "log1p", "sin", "cos",
})


def _apply_act(out, act):
    if act is None:
        return out
    fn = None
    if act in _ACT_NAMES:
        fn = getattr(nn_ops, act, None) or getattr(math_ops, act, None)
    if fn is None or not callable(fn):
        raise ValueError(f"unsupported activation {act!r}")
    return fn(out)


def relu(x, name=None):
    return nn_ops.relu(x)


def softmax(x, axis=-1, name=None):
    return nn_ops.softmax(x, axis=axis)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    out = linalg.matmul(x, y, transpose_x, transpose_y)
    if alpha != 1.0:
        out = out * alpha
    return out


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return reduction.mean(input, axis=dim, keepdim=keep_dim)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return reduction.sum(input, axis=dim, keepdim=keep_dim)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return reduction.max(input, axis=dim, keepdim=keep_dim)


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    return nn_ops.cross_entropy(input, label, soft_label=soft_label,
                                ignore_index=ignore_index,
                                use_softmax=False, reduction="none")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    loss = nn_ops.cross_entropy(logits, label, soft_label=soft_label,
                                ignore_index=ignore_index,
                                reduction="none")
    if return_softmax:
        return loss, nn_ops.softmax(logits, axis=axis)
    return loss


def mean(x, name=None):
    return reduction.mean(x)


def concat(input, axis=0, name=None):
    return manipulation.concat(input, axis=axis)


def reshape(x, shape, name=None):
    return manipulation.reshape(x, shape)


def transpose(x, perm, name=None):
    return manipulation.transpose(x, perm)


def fill_constant(shape, dtype, value, name=None):
    from ..static.program import building_program
    prog = building_program()
    if prog is not None:
        # symbolic: the While/StaticRNN patterns build loop state from
        # fill_constant, which must be a PROGRAM variable there
        from ..core.dtype import to_torch_dtype
        return prog.const_var(
            _torch.full(tuple(int(s) for s in shape), value,
                       dtype=to_torch_dtype(dtype)), hint="fill_constant")
    return creation.full(shape, value, dtype=dtype)


def zeros(shape, dtype="float32", name=None):
    return creation.zeros(shape, dtype=dtype)


def ones(shape, dtype="float32", name=None):
    return creation.ones(shape, dtype=dtype)


def assign(input, output=None):
    from ..static.program import building_program, Variable as _SVar
    if isinstance(input, _SVar) or isinstance(output, _SVar):
        prog = building_program()
        src = input if isinstance(input, _SVar) \
            else prog.const_var(np.asarray(
                input.numpy() if isinstance(input, Tensor) else input),
                hint="assign")
        if output is not None:
            return prog.alias(src, output)
        # assign MAKES A COPY: record a fresh variable aliased from src
        # at THIS program position, so a later in-place alias onto src
        # (increment(in_place=True), less_than(cond=...)) is not
        # visible through the returned value — returning src itself
        # would silently share it (fluid assign-copy semantics inside
        # While bodies depend on this)
        name = prog._new_name("assign")
        v = _SVar(name, tuple(src._shape), src._v.dtype, prog)
        prog.vars[name] = v
        return prog.alias(src, v)
    t = Tensor(np.asarray(input)) if not isinstance(input, Tensor) \
        else input.clone()
    if output is not None:
        output.value = t.value
        return output
    return t


def cast(x, dtype):
    from ..ops.math import cast as _cast
    return _cast(x, dtype)


def embedding(input, size, is_sparse=False, param_attr=None,
              dtype="float32", name=None):
    from ..nn.layer.common import Embedding
    key = _reuse_key(name, ("embedding", int(size[0]), int(size[1]),
                            bool(is_sparse)))
    layer = _layer_cache.get(key)
    if layer is None:
        layer = Embedding(size[0], size[1], weight_attr=param_attr,
                          sparse=is_sparse)
        _layer_cache[key] = layer
    return layer(input)


def dropout(x, dropout_prob, is_test=False,
            dropout_implementation="downgrade_in_infer"):
    mode = ("upscale_in_train"
            if dropout_implementation == "upscale_in_train"
            else "downscale_in_infer")
    return nn_ops.dropout(x, p=dropout_prob, training=not is_test,
                          mode=mode)


def accuracy(input, label, k=1):
    from ..metric import accuracy as _acc
    return _acc(input, label, k=k)


# ---- round-3 surface widening (reference: fluid/layers/nn.py __all__) -----
# Functional names forward to the modern ops with fluid's signatures
# (`dim` instead of `axis`, elementwise_* with the broadcast `axis` arg,
# pool2d with pool_type strings). Parameter-creating layer functions
# (conv2d, batch_norm, ...) reuse the _reuse_key machinery fc uses.

def _paddle():
    import paddle_tpu_torch as _p
    return _p


def _val(x, dtype=None):
    """The torch value of a Tensor (a pending lazy graph runs first) or
    of an array-like."""
    if isinstance(x, Tensor):
        return x.value
    return _torch.as_tensor(np.asarray(x), dtype=dtype)


# -- reductions / logic ------------------------------------------------------

def reduce_min(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _paddle().min(input, axis=dim, keepdim=keep_dim)


def reduce_prod(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _paddle().prod(input, axis=dim, keepdim=keep_dim)


def reduce_all(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _paddle().all(input, axis=dim, keepdim=keep_dim)


def reduce_any(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _paddle().any(input, axis=dim, keepdim=keep_dim)


def logical_and(x, y, out=None, name=None):
    return _paddle().logical_and(x, y)


def logical_or(x, y, out=None, name=None):
    return _paddle().logical_or(x, y)


def logical_xor(x, y, out=None, name=None):
    return _paddle().logical_xor(x, y)


def logical_not(x, out=None, name=None):
    return _paddle().logical_not(x)


# -- elementwise with fluid's broadcast `axis` -------------------------------

def _ew(fn, x, y, axis):
    if axis != -1 and hasattr(y, "ndim") and y.ndim < x.ndim:
        # fluid semantics: y's dims align with x starting at `axis`
        from ..ops import manipulation
        for _ in _builtin_range(x.ndim - axis - y.ndim):
            y = manipulation.unsqueeze(y, -1)
    return fn(x, y)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _apply_act(_ew(_paddle().add, x, y, axis), act)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _apply_act(_ew(_paddle().subtract, x, y, axis), act)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _apply_act(_ew(_paddle().multiply, x, y, axis), act)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _apply_act(_ew(_paddle().divide, x, y, axis), act)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _apply_act(_ew(_paddle().maximum, x, y, axis), act)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _apply_act(_ew(_paddle().minimum, x, y, axis), act)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _apply_act(_ew(_paddle().pow, x, y, axis), act)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _apply_act(_ew(_paddle().mod, x, y, axis), act)


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return _apply_act(_ew(_paddle().floor_divide, x, y, axis), act)


# -- activations / simple math ----------------------------------------------

def log(x, name=None):
    return _paddle().log(x)


def pow(x, factor=1.0, name=None):  # noqa: A001
    return _paddle().pow(x, factor)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772,
         name=None):
    from ..nn import functional as F
    return F.selu(x, scale=scale, alpha=alpha)


def elu(x, alpha=1.0, name=None):
    from ..nn import functional as F
    return F.elu(x, alpha=alpha)


def relu6(x, threshold=6.0, name=None):
    from ..nn import functional as F
    return F.relu6(x)


def leaky_relu(x, alpha=0.02, name=None):
    from ..nn import functional as F
    return F.leaky_relu(x, negative_slope=alpha)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _paddle().clip(x * slope + offset, 0.0, 1.0)


def swish(x, beta=1.0, name=None):
    from ..ops import nn_ops
    return x * nn_ops.sigmoid(x * beta)


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    return x * _paddle().clip(x + offset, 0.0, threshold) / scale


def mish(x, name=None):
    from ..nn import functional as F
    return x * _paddle().tanh(F.softplus(x))


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * _paddle().tanh(x * scale_a)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _paddle().clip(x, t_min, t_max)


def soft_relu(x, threshold=40.0, name=None):
    clipped = _paddle().clip(x, -threshold, threshold)
    return _paddle().log(1.0 + _paddle().exp(clipped))


def sign(x, name=None):
    return _paddle().sign(x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True,  # noqa: A002
          act=None, name=None):
    out = x * scale + bias if bias_after_scale else (x + bias) * scale
    return _apply_act(out, act)


def clip(x, min, max, name=None):  # noqa: A002
    return _paddle().clip(x, min, max)


def clip_by_norm(x, max_norm, name=None):
    from ..ops import reduction, math as math_ops
    norm = _paddle().sqrt(reduction.sum(math_ops.multiply(x, x)))
    factor = _paddle().minimum(
        _paddle().to_tensor(1.0), max_norm / _paddle().maximum(
            norm, _paddle().to_tensor(1e-12)))
    return x * factor


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    from ..ops import manipulation, linalg
    import numpy as _np
    xm = manipulation.reshape(
        x, (int(_np.prod(x.shape[:x_num_col_dims])), -1))
    ym = manipulation.reshape(
        y, (int(_np.prod(y.shape[:y_num_col_dims])), -1))
    return linalg.matmul(xm, ym)


# -- shape / manipulation ----------------------------------------------------

def split(input, num_or_sections, dim=-1, name=None):  # noqa: A002
    return _paddle().split(input, num_or_sections, axis=dim)


def squeeze(input, axes=None, name=None):  # noqa: A002
    return _paddle().squeeze(input, axis=axes)


def unsqueeze(input, axes, name=None):  # noqa: A002
    return _paddle().unsqueeze(input, axis=axes)


def flatten(x, axis=1, name=None):
    import numpy as _np
    lead = int(_np.prod(x.shape[:axis])) if axis > 0 else 1
    return _paddle().reshape(x, (lead, -1))


def stack(x, axis=0, name=None):
    return _paddle().stack(x, axis=axis)


def unstack(x, axis=0, num=None, name=None):
    return _paddle().unstack(x, axis=axis, num=num)


def unbind(input, axis=0):  # noqa: A002
    return _paddle().unbind(input, axis=axis)


def expand(x, expand_times, name=None):
    return _paddle().tile(x, expand_times)


def expand_as(x, target_tensor, name=None):
    return _paddle().expand_as(x, target_tensor)


def slice(input, axes, starts, ends):  # noqa: A002
    return _paddle().slice(input, axes, starts, ends)


def strided_slice(input, axes, starts, ends, strides):  # noqa: A002
    return _paddle().strided_slice(input, axes, starts, ends, strides)


def shape(input):  # noqa: A002
    return _paddle().shape(input)


def rank(input):  # noqa: A002
    """The number of dims as a 0-d int Tensor (the reference's top-level
    ``paddle.rank``)."""
    return _paddle().to_tensor(np.asarray(
        input.ndim if isinstance(input, Tensor) else np.ndim(input)))


def size(input):  # noqa: A002
    return _paddle().numel(input)


def gather(input, index, overwrite=True):  # noqa: A002
    return _paddle().gather(input, index)


def gather_nd(input, index, name=None):  # noqa: A002
    return _paddle().gather_nd(input, index)


def scatter(input, index, updates, overwrite=True, name=None):  # noqa: A002
    return _paddle().scatter(input, index, updates, overwrite=overwrite)


def scatter_nd_add(ref, index, updates, name=None):
    return _paddle().scatter_nd_add(ref, index, updates)


def scatter_nd(index, updates, shape, name=None):  # noqa: A002
    return _paddle().scatter_nd(index, updates, shape)


def where(condition):
    return _paddle().nonzero(condition)


def one_hot(input, depth, allow_out_of_range=False):  # noqa: A002
    from ..nn import functional as F
    if input.ndim >= 2 and int(input.shape[-1]) == 1:
        input = input.squeeze(-1)  # fluid replaces the trailing 1-dim
    return F.one_hot(input, depth)


def topk(input, k, name=None):  # noqa: A002
    return _paddle().topk(input, k)


def _unique_appearance(x):
    import numpy as _np
    v = _np.asarray(x.numpy()).reshape(-1)
    sorted_u, first = _np.unique(v, return_index=True)
    order = _np.argsort(first)          # appearance order
    out = sorted_u[order]
    remap = _np.empty(len(sorted_u), _np.int64)
    remap[order] = _np.arange(len(sorted_u))
    inv_sorted = _np.searchsorted(sorted_u, v)
    inverse = remap[inv_sorted]
    counts = _np.bincount(inverse, minlength=len(out))
    return out, inverse, counts


def unique(x, dtype="int32"):
    """fluid semantics: appearance-order uniques + a len(x) index
    mapping every input element into `out`."""
    out, inverse, _ = _unique_appearance(x)
    T = _paddle().to_tensor
    import numpy as _np
    return T(out), T(inverse.astype(_np.dtype(dtype)))


def unique_with_counts(x, dtype="int32"):
    out, inverse, counts = _unique_appearance(x)
    T = _paddle().to_tensor
    import numpy as _np
    return (T(out), T(inverse.astype(_np.dtype(dtype))),
            T(counts.astype(_np.int64)))


def pad(x, paddings, pad_value=0.0, name=None):
    from ..nn import functional as F
    return F.pad(x, paddings, value=pad_value)


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant",  # noqa: A002
          pad_value=0.0, data_format="NCHW", name=None):
    from ..nn import functional as F
    t, b, l, r = paddings  # fluid order: top/bottom/left/right
    return F.pad(input, [l, r, t, b], mode=mode.replace(
        "edge", "replicate"), value=pad_value, data_format=data_format)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    import numpy as _np
    pads = []
    for xa, ya in zip(x.shape, y.shape):
        pads += [0, int(xa - ya)]
    # torch's pad lists the last dim first
    flat = []
    for p0, p1 in reversed(list(zip(pads[::2], pads[1::2]))):
        flat += [p0, p1]
    return Tensor(_torch.nn.functional.pad(_val(y), flat,
                                          value=float(pad_value)))


def crop_tensor(x, shape=None, offsets=None, name=None):  # noqa: A002
    offs = offsets or [0] * len(shape)
    from ..ops import manipulation
    return manipulation.slice(
        x, list(_builtin_range(len(shape))), offs,
        [o + s for o, s in zip(offs, shape)])


crop = crop_tensor


def shard_index(input, index_num, nshards, shard_id,  # noqa: A002
                ignore_value=-1):
    return _paddle().shard_index(input, index_num, nshards, shard_id,
                                 ignore_value)


def sum(x):  # noqa: A001
    """fluid.layers.sum IS add_n: elementwise sum of the inputs (a lone
    tensor passes through unchanged — NOT a reduction)."""
    if isinstance(x, (list, tuple)):
        out = x[0]
        for t in x[1:]:
            out = out + t
        return out
    return x


# -- normalization / similarity ---------------------------------------------

def l2_normalize(x, axis, epsilon=1e-12, name=None):
    from ..nn import functional as F
    return F.normalize(x, axis=axis, epsilon=epsilon)


def cos_sim(X, Y):
    from ..nn import functional as F
    return F.cosine_similarity(X, Y, axis=-1).unsqueeze(-1)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None,  # noqa: A002
        data_format="NCHW"):
    from ..ops import nn_ops
    return nn_ops.local_response_norm(input, n, alpha, beta, k)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    from ..nn import functional as F
    return F.smooth_l1_loss(x, y, reduction="none",
                            delta=1.0 / ((sigma or 1.0) ** 2)) \
        .sum(axis=-1, keepdim=True)


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    return _paddle().nn.functional.label_smooth(
        label, prior_dist=prior_dist, epsilon=epsilon)


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    from ..nn import functional as F
    return F.log_loss(input, label, epsilon)


def dice_loss(input, label, epsilon=1e-5):  # noqa: A002
    from ..nn import functional as F
    return F.dice_loss(input, label, epsilon)


def mean_iou(input, label, num_classes):  # noqa: A002
    """Reference mean_iou_op: ``(mean IoU, wrong, correct)`` over the
    classes present in either the prediction or the label; wrong and
    correct count int32 per class. (The reference package imports a
    ``metric.mean_iou`` it does not have, so there this raises.)"""
    pred = _val(input).detach().cpu().numpy().reshape(-1).astype(np.int64)
    lab = _val(label).detach().cpu().numpy().reshape(-1).astype(np.int64)
    hit = pred == lab
    correct = np.bincount(pred[hit], minlength=num_classes)[:num_classes]
    wrong = (np.bincount(pred[~hit], minlength=num_classes)
             + np.bincount(lab[~hit], minlength=num_classes))[:num_classes]
    union = correct + wrong
    seen = union > 0
    miou = (correct[seen] / union[seen]).mean() if seen.any() else 0.0
    T = _paddle().to_tensor
    return (T(np.float32(miou)), T(wrong.astype(np.int32)),
            T(correct.astype(np.int32)))


# -- vision-ish --------------------------------------------------------------

def image_resize(input, out_shape=None, scale=None,  # noqa: A002
                 name=None, resample="BILINEAR", actual_shape=None,
                 align_corners=True, align_mode=1, data_format="NCHW"):
    from ..nn import functional as F
    mode = {"BILINEAR": "bilinear", "NEAREST": "nearest",
            "TRILINEAR": "trilinear", "LINEAR": "linear",
            "BICUBIC": "bicubic"}[resample.upper()]
    return F.interpolate(input, size=out_shape, scale_factor=scale,
                         mode=mode, align_corners=bool(align_corners))


def resize_bilinear(input, out_shape=None, scale=None, name=None,  # noqa: A002
                    actual_shape=None, align_corners=True, align_mode=1,
                    data_format="NCHW"):
    return image_resize(input, out_shape, scale, name, "BILINEAR",
                        align_corners=align_corners)


def resize_nearest(input, out_shape=None, scale=None, name=None,  # noqa: A002
                   actual_shape=None, align_corners=True,
                   data_format="NCHW"):
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        align_corners=align_corners)


def resize_trilinear(input, out_shape=None, scale=None, name=None,  # noqa: A002
                     actual_shape=None, align_corners=True, align_mode=1,
                     data_format="NCDHW"):
    return image_resize(input, out_shape, scale, name, "TRILINEAR",
                        align_corners=align_corners)


def resize_linear(input, out_shape=None, scale=None, name=None,  # noqa: A002
                  actual_shape=None, align_corners=True, align_mode=1,
                  data_format="NCW"):
    return image_resize(input, out_shape, scale, name, "LINEAR",
                        align_corners=align_corners)


def image_resize_short(input, out_short_len, resample="BILINEAR"):  # noqa: A002
    h, w = input.shape[2], input.shape[3]
    short, other = (h, w) if h < w else (w, h)
    ratio = out_short_len / float(short)
    out = (int(round(h * ratio)), int(round(w * ratio)))
    return image_resize(input, out_shape=out, resample=resample)


def roi_align(input, rois, pooled_height=1, pooled_width=1,  # noqa: A002
              spatial_scale=1.0, sampling_ratio=-1, name=None,
              rois_num=None):
    # rois_num is vision.ops.roi_align's boxes_num (the reference passes
    # it by a keyword its roi_align does not take, and raises)
    from ..vision.ops import roi_align as _ra
    return _ra(input, rois, rois_num,
               output_size=(pooled_height, pooled_width),
               spatial_scale=spatial_scale,
               sampling_ratio=sampling_ratio)


def roi_pool(input, rois, pooled_height=1, pooled_width=1,  # noqa: A002
             spatial_scale=1.0, rois_num=None, name=None):
    # max-pool RoI: reference roi_pool_op; expressed via roi_align with
    # aligned sampling, as the reference package does
    return roi_align(input, rois, pooled_height, pooled_width,
                     spatial_scale, rois_num=rois_num)


def grid_sampler(x, grid, name=None):
    from ..nn import functional as F
    return F.grid_sample(x, grid)


def affine_grid(theta, out_shape, name=None):
    from ..nn import functional as F
    return F.affine_grid(theta, out_shape)


def affine_channel(x, scale=None, bias=None, data_format="NCHW",
                   act=None, name=None):
    s = scale.reshape((1, -1, 1, 1)) if scale is not None else 1.0
    b = bias.reshape((1, -1, 1, 1)) if bias is not None else 0.0
    return _apply_act(x * s + b, act)


def pixel_shuffle(x, upscale_factor):
    from ..nn import functional as F
    return F.pixel_shuffle(x, upscale_factor)


def space_to_depth(x, blocksize, name=None):
    n, c, h, w = x.shape
    bs = int(blocksize)
    out = _paddle().reshape(x, (n, c, h // bs, bs, w // bs, bs))
    out = _paddle().transpose(out, (0, 3, 5, 1, 2, 4))
    return _paddle().reshape(out, (n, c * bs * bs, h // bs, w // bs))


def shuffle_channel(x, group, name=None):
    n, c, h, w = x.shape
    out = _paddle().reshape(x, (n, group, c // group, h, w))
    out = _paddle().transpose(out, (0, 2, 1, 3, 4))
    return _paddle().reshape(out, (n, c, h, w))


from ..core.dispatch import register_op as _register_op


@_register_op("temporal_shift")
def _temporal_shift_op(x, *, seg_num, shift_ratio):
    nt, c, h, w = x.shape
    n = nt // seg_num
    v = x.reshape(n, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    zero = _torch.zeros_like(v[:, :1, :fold])
    left = _torch.cat([v[:, 1:, :fold], zero], dim=1)
    right = _torch.cat([_torch.zeros_like(v[:, :1, fold:2 * fold]),
                       v[:, :-1, fold:2 * fold]], dim=1)
    out = _torch.cat([left, right, v[:, :, 2 * fold:]], dim=2)
    return out.reshape(nt, c, h, w)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    return _temporal_shift_op(x, seg_num=int(seg_num),
                              shift_ratio=float(shift_ratio))


def maxout(x, groups, name=None, axis=1):
    n, c, h, w = x.shape
    out = _paddle().reshape(x, (n, c // groups, groups, h, w))
    return _paddle().max(out, axis=2)


@_register_op("fsp_matrix")
def _fsp_op(x, y):
    n, cx, h, w = x.shape
    cy = y.shape[1]
    xf = x.reshape(n, cx, h * w)
    yf = y.reshape(n, cy, h * w)
    return _torch.einsum("nch,ndh->ncd", xf, yf) / (h * w)


def fsp_matrix(x, y):
    return _fsp_op(x, y)


@_register_op("add_position_encoding")
def _ape_op(x, *, alpha, beta):
    b, t, c = x.shape
    half = c // 2
    pos = _torch.arange(t, dtype=_torch.float32, device=x.device)[:, None]
    div = _torch.pow(10000.0, _torch.arange(half, dtype=_torch.float32,
                                          device=x.device) / half)
    pe = _torch.cat([_torch.sin(pos / div), _torch.cos(pos / div)], dim=1)
    return alpha * x + beta * pe[None, :, :c].to(x.dtype)


def add_position_encoding(input, alpha, beta, name=None):  # noqa: A002
    return _ape_op(input, alpha=float(alpha), beta=float(beta))


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1,
           name=None):
    from ..nn import functional as F
    return F.unfold(x, kernel_sizes, strides, paddings, dilations)


@_register_op("multiplex")
def _multiplex_op(index, *inputs):
    stacked = _torch.stack(inputs, dim=0)
    rows = _torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[index.reshape(-1).long(), rows]


def multiplex(inputs, index):
    return _multiplex_op(index, *inputs)


def deformable_conv(input, offset, mask, num_filters,  # noqa: A002
                    filter_size, stride=1, padding=0, dilation=1,
                    groups=1, deformable_groups=1, im2col_step=1,
                    param_attr=None, bias_attr=None,
                    modulated=True, name=None):
    from ..vision.ops import deform_conv2d
    key = _reuse_key(name, ("deformable_conv", int(input.shape[1]),
                            num_filters, filter_size))
    w = _layer_cache.get(key)
    if w is None:
        from ..nn import initializer as init_mod
        ks = filter_size if isinstance(filter_size, (list, tuple)) \
            else (filter_size, filter_size)
        w = _Parameter._own(init_mod.XavierNormal()(
            (num_filters, int(input.shape[1]) // groups, ks[0], ks[1]),
            "float32"))
        _layer_cache[key] = w
    return deform_conv2d(input, offset, w, mask=mask, stride=stride,
                         padding=padding, dilation=dilation,
                         deformable_groups=deformable_groups,
                         groups=groups)


# -- random ------------------------------------------------------------------

def uniform_random(shape, dtype="float32", min=-1.0, max=1.0,  # noqa: A002
                   seed=0, name=None):
    return _paddle().uniform(shape, dtype, min=min, max=max, seed=seed)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32",
                    name=None):
    return _paddle().normal(mean=mean, std=std, shape=shape)


def uniform_random_batch_size_like(input, shape, dtype="float32",  # noqa: A002
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    shape = list(shape)
    shape[output_dim_idx] = input.shape[input_dim_idx]
    return uniform_random(shape, dtype, min, max, seed)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,  # noqa: A002
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    shape = list(shape)
    shape[output_dim_idx] = input.shape[input_dim_idx]
    return gaussian_random(shape, mean, std, seed, dtype)


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):  # noqa: A002
    return _paddle().multinomial(x, num_samples=1).squeeze(-1)


def random_crop(x, shape, seed=None):  # noqa: A002
    import numpy as _np
    starts = [int(_np.random.randint(0, int(xd) - int(sd) + 1))
              for xd, sd in zip(x.shape[-len(shape):], shape)]
    axes = list(_builtin_range(x.ndim - len(shape), x.ndim))
    ends = [st + int(sd) for st, sd in zip(starts, shape)]
    from ..ops import manipulation
    return manipulation.slice(x, axes, starts, ends)


# -- sequence / CRF ----------------------------------------------------------

def linear_chain_crf(input, label, param_attr=None, length=None):  # noqa: A002
    """Reference: fluid/layers/nn.py linear_chain_crf — creates the
    [C+2, C] transition parameter and returns per-sequence nll."""
    from ..ops import sequence as seq_ops
    c = int(input.shape[-1])
    # shared by design between linear_chain_crf and crf_decoding: key on
    # (name, class-count), never the call stack
    key = ("crf_transition", getattr(param_attr, "name", param_attr), c)
    trans = _layer_cache.get(key)
    if trans is None:
        from ..nn import initializer as init_mod
        trans = _Parameter._own(init_mod.Normal(0.0, 0.1)((c + 2, c),
                                                         "float32"))
        _layer_cache[key] = trans
    if length is None:
        length = _paddle().full([int(input.shape[0])], input.shape[1],
                                "int64")
    if label.ndim == 3:
        label = label.squeeze(-1)
    return seq_ops.linear_chain_crf(input, trans, label, length), trans


def crf_decoding(input, param_attr=None, label=None, length=None):  # noqa: A002
    from ..ops import sequence as seq_ops
    c = int(input.shape[-1])
    key = ("crf_transition", getattr(param_attr, "name", param_attr), c)
    trans = _layer_cache.get(key)
    if trans is None:
        raise ValueError("crf_decoding: no trained transition found — "
                         "call linear_chain_crf first or pass a shared "
                         "param_attr name")
    if length is None:
        length = _paddle().full([int(input.shape[0])], input.shape[1],
                                "int64")
    return seq_ops.crf_decoding(input, trans, length)


def ctc_greedy_decoder(input, blank, input_length=None,  # noqa: A002
                       padding_value=0, name=None):
    """Best-path CTC decode: argmax, merge repeats, drop blanks
    (reference: ctc_align_op)."""
    import numpy as _np
    probs = _np.asarray(input.numpy())
    ids = probs.argmax(-1)
    b, t = ids.shape
    lens = (_np.asarray(input_length.numpy()).reshape(-1)
            if input_length is not None else _np.full(b, t))
    outs = _np.full((b, t), padding_value, _np.int64)
    out_lens = _np.zeros(b, _np.int64)
    for i in _builtin_range(b):
        prev = -1
        k = 0
        for j in _builtin_range(int(lens[i])):
            tok = int(ids[i, j])
            if tok != blank and tok != prev:
                outs[i, k] = tok
                k += 1
            prev = tok
        out_lens[i] = k
    return _paddle().to_tensor(outs), _paddle().to_tensor(out_lens)


def chunk_eval(input, label, chunk_scheme, num_chunk_types,  # noqa: A002
               excluded_chunk_types=None, seq_length=None):
    """IOB/IOE/IOBES chunk P/R/F1 (reference: chunk_eval_op). Host-side
    metric (no gradient)."""
    import numpy as _np

    def _chunks(tags):
        # tag encoding: tag = chunk_type * tag_num + pos; O is any tag
        # outside the range. Positions per scheme (chunk_eval_op.h):
        # IOB: B=0 I=1; IOE: I=0 E=1; IOBES: B=0 I=1 E=2 S=3; plain: 0.
        spans = []
        tag_num = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[
            chunk_scheme]
        start = ctype = None
        for i, t in enumerate(list(tags) + [-1]):
            if t < 0 or t >= num_chunk_types * tag_num:
                ty, pos = None, None
            else:
                ty, pos = divmod(int(t), tag_num)
            # does this tag CONTINUE an open chunk of ctype?
            if start is not None:
                cont = (ty == ctype) and (
                    (chunk_scheme == "IOB" and pos == 1)
                    or (chunk_scheme == "IOE" and pos in (0, 1))
                    or (chunk_scheme == "IOBES" and pos in (1, 2))
                    or chunk_scheme == "plain")
                if not cont:
                    spans.append((start, i - 1, ctype))
                    start = ctype = None
            if ty is not None and start is None:
                start, ctype = i, ty
            # immediate enders close INCLUDING this position
            if start is not None and (
                    (chunk_scheme == "IOE" and pos == 1)
                    or (chunk_scheme == "IOBES" and pos in (2, 3))):
                spans.append((start, i, ctype))
                start = ctype = None
        if excluded_chunk_types:
            spans = [s for s in spans if s[2] not in excluded_chunk_types]
        return set(spans)

    inf = _np.asarray(input.numpy()).reshape(input.shape[0], -1)
    lab = _np.asarray(label.numpy()).reshape(label.shape[0], -1)
    lens = (_np.asarray(seq_length.numpy()).reshape(-1)
            if seq_length is not None
            else _np.full(inf.shape[0], inf.shape[1]))
    n_inf = n_lab = n_correct = 0
    for i in _builtin_range(inf.shape[0]):
        ci = _chunks(inf[i, :int(lens[i])])
        cl = _chunks(lab[i, :int(lens[i])])
        n_inf += len(ci)
        n_lab += len(cl)
        n_correct += len(ci & cl)
    p = n_correct / n_inf if n_inf else 0.0
    r = n_correct / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    T = _paddle().to_tensor
    return (T(_np.float32(p)), T(_np.float32(r)), T(_np.float32(f1)),
            T(_np.int64(n_inf)), T(_np.int64(n_lab)),
            T(_np.int64(n_correct)))


# -- parameter-creating layer functions (fc-style _reuse_key reuse) ----------

def _cached_layer(name, config, build):
    key = _reuse_key(name, config)
    layer = _layer_cache.get(key)
    if layer is None:
        layer = build()
        _layer_cache[key] = layer
    return layer


def conv2d(input, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None, data_format="NCHW"):
    from ..nn.layer.conv import Conv2D
    cin = int(input.shape[1])
    layer = _cached_layer(name, ("conv2d", cin, num_filters,
                                 str(filter_size), str(stride),
                                 str(padding), str(dilation), groups),
                          lambda: Conv2D(cin, num_filters, filter_size,
                                         stride=stride, padding=padding,
                                         dilation=dilation, groups=groups,
                                         bias_attr=bias_attr))
    return _apply_act(layer(input), act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None, data_format="NCDHW"):
    from ..nn.layer.conv import Conv3D
    cin = int(input.shape[1])
    layer = _cached_layer(name, ("conv3d", cin, num_filters,
                                 str(filter_size), str(stride),
                                 str(padding), str(dilation), groups),
                          lambda: Conv3D(cin, num_filters, filter_size,
                                         stride=stride, padding=padding,
                                         dilation=dilation, groups=groups,
                                         bias_attr=bias_attr))
    return _apply_act(layer(input), act)


def conv2d_transpose(input, num_filters, output_size=None,  # noqa: A002
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=1, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None,
                     data_format="NCHW"):
    from ..nn.layer.conv import Conv2DTranspose
    cin = int(input.shape[1])
    layer = _cached_layer(name, ("conv2dT", cin, num_filters,
                                 str(filter_size), str(stride),
                                 str(padding), groups),
                          lambda: Conv2DTranspose(
                              cin, num_filters, filter_size,
                              stride=stride, padding=padding,
                              groups=groups, bias_attr=bias_attr))
    return _apply_act(layer(input), act)


def conv3d_transpose(input, num_filters, output_size=None,  # noqa: A002
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=1, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None,
                     data_format="NCDHW"):
    from ..nn.layer.conv import Conv3DTranspose
    cin = int(input.shape[1])
    layer = _cached_layer(name, ("conv3dT", cin, num_filters,
                                 str(filter_size), str(stride),
                                 str(padding), groups),
                          lambda: Conv3DTranspose(
                              cin, num_filters, filter_size,
                              stride=stride, padding=padding,
                              groups=groups, bias_attr=bias_attr))
    return _apply_act(layer(input), act)


def batch_norm(input, act=None, is_test=False, momentum=0.9,  # noqa: A002
               epsilon=1e-5, param_attr=None, bias_attr=None,
               data_layout="NCHW", in_place=False, name=None,
               moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    from ..nn.layer.norm import BatchNorm2D, BatchNorm1D, BatchNorm3D
    c = int(input.shape[1])
    cls = {2: BatchNorm1D, 3: BatchNorm1D, 4: BatchNorm2D,
           5: BatchNorm3D}[input.ndim]
    layer = _cached_layer(name, ("bn", c, input.ndim),
                          lambda: cls(c, momentum=momentum,
                                      epsilon=epsilon))
    layer.training = not is_test
    return _apply_act(layer(input), act)


def inplace_abn(input, act=None, **kwargs):  # noqa: A002
    # activated batch norm; in-place-ness is an allocator detail the
    # functional runtime absorbs
    return batch_norm(input, act=act or "leaky_relu", **kwargs)


def instance_norm(input, epsilon=1e-5, param_attr=None,  # noqa: A002
                  bias_attr=None, name=None):
    from ..nn.layer.norm import InstanceNorm2D
    c = int(input.shape[1])
    layer = _cached_layer(name, ("in", c),
                          lambda: InstanceNorm2D(c, epsilon=epsilon))
    return layer(input)


def layer_norm(input, scale=True, shift=True,  # noqa: A002
               begin_norm_axis=1, epsilon=1e-5, param_attr=None,
               bias_attr=None, act=None, name=None):
    from ..nn.layer.norm import LayerNorm
    shape = tuple(int(s) for s in input.shape[begin_norm_axis:])
    layer = _cached_layer(name, ("ln", shape),
                          lambda: LayerNorm(list(shape),
                                            epsilon=epsilon))
    return _apply_act(layer(input), act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None,  # noqa: A002
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    from ..nn.layer.norm import GroupNorm
    c = int(input.shape[1])
    layer = _cached_layer(name, ("gn", c, groups),
                          lambda: GroupNorm(groups, c, epsilon=epsilon))
    return _apply_act(layer(input), act)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    from ..nn.layer.norm import SpectralNorm
    layer = _cached_layer(name, ("sn", tuple(weight.shape), dim),
                          lambda: SpectralNorm(weight.shape, dim=dim,
                                               power_iters=power_iters,
                                               eps=eps))
    return layer(weight)


def prelu(x, mode="all", param_attr=None, name=None):
    from ..nn import initializer as init_mod
    n = {"all": 1, "channel": int(x.shape[1]),
         "element": int(np.prod(x.shape[1:]))}[mode]
    w = _cached_layer(getattr(param_attr, "name", None) or name,
                      ("prelu", mode, n),
                      lambda: _Parameter._own(init_mod.Constant(0.25)(
                          (n,), "float32")))
    if mode == "channel":
        wv = w.reshape((1, -1) + (1,) * (x.ndim - 2))
    elif mode == "element":
        wv = w.reshape((1,) + tuple(x.shape[1:]))
    else:
        wv = w
    return _paddle().maximum(x, x * 0.0) + wv * _paddle().minimum(
        x, x * 0.0)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    dx, dy = int(x.shape[-1]), int(y.shape[-1])
    from ..nn import initializer as init_mod
    w = _cached_layer(name, ("bilinear", dx, dy, size),
                      lambda: _Parameter._own(init_mod.XavierNormal()(
                          (size, dx, dy), "float32")))
    from ..ops import linalg, manipulation
    # out[b, k] = x[b] @ W[k] @ y[b]: Wy = [size*dx, dy] @ y^T ->
    # [size, dx, B] -> [B, size, dx], then row-dot with x
    wy = linalg.matmul(manipulation.reshape(w, (size * dx, dy)),
                       manipulation.transpose(y, (1, 0)))
    wy = manipulation.transpose(
        manipulation.reshape(wy, (size, dx, -1)), (2, 0, 1))
    out = linalg.matmul(wy, manipulation.unsqueeze(x, -1))
    return _apply_act(manipulation.reshape(out, (-1, size)), act)


# -- pooling (fluid signatures) ----------------------------------------------

def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,  # noqa: A002
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True,
           data_format="NCHW"):
    from ..nn import functional as F
    if global_pooling:
        return (F.adaptive_max_pool2d(input, 1) if pool_type == "max"
                else F.adaptive_avg_pool2d(input, 1))
    if pool_type == "max":
        return F.max_pool2d(input, pool_size, pool_stride, pool_padding,
                            ceil_mode=ceil_mode)
    return F.avg_pool2d(input, pool_size, pool_stride, pool_padding,
                        ceil_mode=ceil_mode, exclusive=exclusive)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,  # noqa: A002
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True,
           data_format="NCDHW"):
    from ..nn import functional as F
    if global_pooling:
        return adaptive_pool3d(input, 1, pool_type)
    if pool_type == "max":
        return F.max_pool3d(input, pool_size, pool_stride, pool_padding,
                            ceil_mode=ceil_mode)
    return F.avg_pool3d(input, pool_size, pool_stride, pool_padding,
                        ceil_mode=ceil_mode, exclusive=exclusive)


def adaptive_pool2d(input, pool_size, pool_type="max",  # noqa: A002
                    require_index=False, name=None):
    from ..nn import functional as F
    if pool_type == "max":
        return F.adaptive_max_pool2d(input, pool_size,
                                     return_mask=require_index)
    return F.adaptive_avg_pool2d(input, pool_size)


def adaptive_pool3d(input, pool_size, pool_type="max",  # noqa: A002
                    require_index=False, name=None):
    from ..nn import functional as F
    if pool_type == "max":
        return F.adaptive_max_pool3d(input, pool_size,
                                     return_mask=require_index)
    return F.adaptive_avg_pool3d(input, pool_size)


# -- misc --------------------------------------------------------------------

_step_counters = {}


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Reference: a persistable int64 counter incremented per call."""
    key = counter_name or "@STEP_COUNTER@"
    t = _step_counters.get(key)
    if t is None:
        t = _paddle().to_tensor(np.asarray([begin], "int64"))
        _step_counters[key] = t
    else:
        t.value = (t + step).value
    return t


def lod_reset(x, y=None, target_lod=None):
    from ..core.lod import LoDTensor
    if isinstance(x, LoDTensor):
        x.set_lod([target_lod] if target_lod is not None else y.lod())
        return x
    return x


def lod_append(x, level):
    return x


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Reference: py_func_op — host-python op. The eager runtime IS
    python: call through. With ``backward_func`` the call is one
    ``torch.autograd.Function`` (``_PyFunc``): its backward is
    ``backward_func(*inputs, *outputs, *output_grads)`` (the inputs in
    ``skip_vars_in_backward_input`` left out), which returns one grad an
    input, as fluid's py_func_op calls it."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    if backward_func is None:
        return func(*xs)
    skip = skip_vars_in_backward_input or ()
    skip = skip if isinstance(skip, (list, tuple)) else [skip]
    keep = [not any(t is s for s in skip) for t in xs]
    outs = _PyFunc.apply(func, backward_func, keep, *[_val(t) for t in xs])
    wrapped = [Tensor._wrap(o) for o in outs]
    return wrapped[0] if len(wrapped) == 1 else wrapped


class _PyFunc(_torch.autograd.Function):
    @staticmethod
    def forward(ctx, func, backward_func, keep, *xs):
        with _torch.no_grad():
            res = func(*[Tensor._wrap(v) for v in xs])
        res = list(res) if isinstance(res, (list, tuple)) else [res]
        outs = tuple(_val(r).detach() for r in res)
        ctx.backward_func, ctx.keep, ctx.n_in = backward_func, keep, len(xs)
        ctx.save_for_backward(*xs, *outs)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        xs, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        args = [Tensor._wrap(v) for v, k in zip(xs, ctx.keep) if k]
        args += [Tensor._wrap(v) for v in outs]
        args += [Tensor._wrap(_torch.zeros_like(o) if g is None else g)
                 for g, o in zip(grads, outs)]
        with _torch.no_grad():
            got = ctx.backward_func(*args)
        got = list(got) if isinstance(got, (list, tuple)) else [got]
        return (None, None, None) + tuple(
            None if g is None else _val(g) for g in got)


def merge_selected_rows(x, name=None):
    from ..core.sparse_grad import IndexedSlices
    if isinstance(x, IndexedSlices):
        return x.coalesce()
    return x


def get_tensor_from_selected_rows(x, name=None):
    from ..core.sparse_grad import IndexedSlices
    if isinstance(x, IndexedSlices):
        return Tensor(x.to_dense())
    return x


def gather_tree(ids, parents):
    """Beam-search path backtrace (reference: gather_tree_op): ids and
    parents are [T, B, beam]; returns the full paths."""
    import numpy as _np
    idv = _np.asarray(ids.numpy())
    pv = _np.asarray(parents.numpy())
    t_max, b, beam = idv.shape
    out = _np.zeros_like(idv)
    out[-1] = idv[-1]
    par = _np.tile(_np.arange(beam)[None, :], (b, 1))
    for t in _builtin_range(t_max - 2, -1, -1):
        par = _np.take_along_axis(pv[t + 1], par, axis=-1)
        out[t] = _np.take_along_axis(idv[t], par, axis=-1)
    return _paddle().to_tensor(out)


def _fluid_unsupported(name, why):
    def stub(*a, **k):
        from ..core.errors import UnimplementedError
        raise UnimplementedError(
            f"fluid.layers.{name}: {why} (explicitly descoped — see "
            "PARITY.md 'Known descopes')")
    stub.__name__ = name
    return stub


# CTR-pipeline / niche kernels intentionally not rebuilt (documented in
# PARITY.md): each names its modern replacement or rationale.
im2sequence = _fluid_unsupported(
    "im2sequence", "use unfold() (im2col) + sequence ops")
row_conv = _fluid_unsupported(
    "row_conv", "lookahead conv for streaming ASR; use causal conv1d")
data_norm = _fluid_unsupported(
    "data_norm", "CTR summary-stat norm; use batch_norm")
similarity_focus = _fluid_unsupported(
    "similarity_focus", "niche attention mask op")
hash = _fluid_unsupported(  # noqa: A001
    "hash", "CTR feature hashing; hash ids host-side")
psroi_pool = _fluid_unsupported(
    "psroi_pool", "position-sensitive RoI; use roi_align")
prroi_pool = _fluid_unsupported(
    "prroi_pool", "precise RoI; use roi_align")
deformable_roi_pooling = _fluid_unsupported(
    "deformable_roi_pooling", "use deform_conv2d + roi_align")
filter_by_instag = _fluid_unsupported(
    "filter_by_instag", "CTR instance-tag filter; filter host-side")
continuous_value_model = _fluid_unsupported(
    "continuous_value_model", "CTR CVM op; preprocess host-side")


# ---- round-3b: remaining fluid.layers submodule surfaces -------------------
# tensor.py / control_flow.py / loss.py / sequence_lod.py / detection.py /
# rnn.py / metric_op.py (reference fluid/layers/*). Aliases keep fluid
# signatures; LoD-taking sequence ops accept the repo's LoDTensor
# (core/lod.py) or (x, lengths) pairs.

# -- tensor.py ---------------------------------------------------------------

def create_tensor(dtype, name=None, persistable=False):
    return _paddle().to_tensor(np.zeros((0,), dtype))


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    from ..nn import initializer as init_mod
    init = default_initializer or (
        init_mod.Constant(0.0) if is_bias else init_mod.XavierNormal())
    key = _reuse_key(name, ("create_parameter", tuple(shape), dtype))
    p = _layer_cache.get(key)
    if p is None:
        p = _Parameter._own(init(tuple(int(s) for s in shape), dtype))
        _layer_cache[key] = p
    return p


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    key = _reuse_key(name, ("global_var", tuple(shape), float(value)))
    t = _layer_cache.get(key)
    if t is None:
        t = _paddle().full(shape, value, dtype)
        t.persistable = persistable
        _layer_cache[key] = t
    return t


def tensor_array_to_tensor(input, axis=1, use_stack=False):  # noqa: A002
    from ..ops import manipulation
    out = (manipulation.stack(list(input), axis=axis) if use_stack
           else manipulation.concat(list(input), axis=axis))
    sizes = _paddle().to_tensor(np.asarray(
        [int(t.shape[axis]) if not use_stack else 1 for t in input],
        "int32"))
    return out, sizes


def sums(input, out=None):  # noqa: A002
    res = sum(list(input))
    if out is not None:
        out.value = res.value
        return out
    return res


def fill_constant_batch_size_like(input, shape, dtype, value,  # noqa: A002
                                  input_dim_idx=0, output_dim_idx=0,
                                  force_cpu=False):
    shape = list(shape)
    shape[output_dim_idx] = int(input.shape[input_dim_idx])
    return _paddle().full(shape, value, dtype)


def argmin(x, axis=0):
    return _paddle().argmin(x, axis=axis)


def argmax(x, axis=0):
    return _paddle().argmax(x, axis=axis)


def argsort(input, axis=-1, descending=False, name=None):  # noqa: A002
    """fluid returns (sorted_values, indices) — in that order."""
    return (_paddle().sort(input, axis=axis, descending=descending),
            _paddle().argsort(input, axis=axis, descending=descending))


def reverse(x, axis):
    return _paddle().flip(x, axis)


def has_inf(x):
    return _paddle().any(_paddle().isinf(x))


def has_nan(x):
    return _paddle().any(_paddle().isnan(x))


def isfinite(x):
    """fluid semantics: ONE bool — are ALL elements finite."""
    return _paddle().all(_paddle().isfinite(x))


def range(start, end, step, dtype, name=None):  # noqa: A001
    return _paddle().arange(start, end, step, dtype)


def linspace(start, stop, num, dtype="float32", name=None):
    return _paddle().linspace(start, stop, num, dtype)


def zeros_like(x, out=None):
    res = _paddle().zeros_like(x)
    if out is not None:
        out.value = res.value
        return out
    return res


def ones_like(x, out=None):
    res = _paddle().ones_like(x)
    if out is not None:
        out.value = res.value
        return out
    return res


def diag(diagonal):
    return _paddle().diag(diagonal)


def eye(num_rows, num_columns=None, batch_shape=None, dtype="float32",
        name=None):
    out = _paddle().eye(num_rows, num_columns, dtype=dtype)
    if batch_shape:
        for _ in batch_shape:
            out = out.unsqueeze(0)
        out = _paddle().tile(out, list(batch_shape) + [1, 1])
    return out


def triu(input, diagonal=0, name=None):  # noqa: A002
    return _paddle().triu(input, diagonal)


# -- control_flow.py ---------------------------------------------------------

def cond(pred, true_fn=None, false_fn=None, name=None):
    from ..static import nn as static_nn
    return static_nn.cond(pred, true_fn, false_fn)


def while_loop(cond_fn, body, loop_vars, is_test=False, name=None):
    from ..static import nn as static_nn
    return static_nn.while_loop(cond_fn, body, loop_vars)


def case(pred_fn_pairs, default=None, name=None):
    from ..static import nn as static_nn
    return static_nn.case(pred_fn_pairs, default)


def switch_case(branch_index, branch_fns, default=None, name=None):
    from ..static import nn as static_nn
    return static_nn.switch_case(branch_index, branch_fns, default)


def increment(x, value=1.0, in_place=True):
    from ..static.program import building_program, Variable as _SVar
    out = x + value
    if not in_place:
        return out
    if isinstance(x, _SVar):
        return building_program().alias(out, x)
    x.value = out.value
    return x


def less_than(x, y, force_cpu=None, cond=None):  # noqa: A002
    return _binop_cond(_paddle().less_than(x, y), cond)


def less_equal(x, y, cond=None):  # noqa: A002
    return _binop_cond(_paddle().less_equal(x, y), cond)


def greater_than(x, y, cond=None):  # noqa: A002
    return _binop_cond(_paddle().greater_than(x, y), cond)


def greater_equal(x, y, cond=None):  # noqa: A002
    return _binop_cond(_paddle().greater_equal(x, y), cond)


def equal(x, y, cond=None):  # noqa: A002
    return _binop_cond(_paddle().equal(x, y), cond)


def not_equal(x, y, cond=None):  # noqa: A002
    return _binop_cond(_paddle().not_equal(x, y), cond)


def _binop_cond(res, cond):
    if cond is None:
        return res
    from ..static.program import building_program, Variable as _SVar
    if isinstance(cond, _SVar):
        # fluid in-place contract inside a While body: cond reads as
        # res from here on (the loop condition update)
        return building_program().alias(res, cond)
    cond.value = res.value
    return cond


def create_array(dtype):
    return []


def array_write(x, i, array=None):
    if array is None:
        array = []
    idx = int(i.numpy()) if hasattr(i, "numpy") else int(i)
    while len(array) <= idx:
        array.append(None)
    array[idx] = x
    return array


def array_read(array, i):
    return array[int(i.numpy()) if hasattr(i, "numpy") else int(i)]


def array_length(array):
    return _paddle().to_tensor(np.asarray([len(array)], "int64"))


def is_empty(x, name=None):
    return _paddle().to_tensor(np.asarray(
        int(np.prod(x.shape)) == 0))


def Print(input, first_n=-1, message=None, summarize=20,  # noqa: A002
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    vals = np.asarray(input.numpy()).reshape(-1)
    if summarize is not None and summarize >= 0:
        vals = vals[:summarize]
    print(f"{message or 'Print'}: shape={list(input.shape)} "
          f"values={vals}")
    return input


def Assert(cond, data=None, summarize=20, name=None):  # noqa: A002
    if not bool(np.all(np.asarray(cond.numpy()))):
        raise AssertionError(
            f"fluid.layers.Assert failed"
            + ("" if data is None else
               f": {[np.asarray(d.numpy()) for d in data]}"))
    return cond


class While:
    """fluid-1.x While sub-block (reference: control_flow.py:973).

    Ops recorded inside ``block()`` become the body of ONE
    ``WhileRecord`` (``static.nn.while_loop`` at run time: on the card,
    under ``Executor.run``'s capture, a CUDA conditional while-node whose
    carry lives in buffers made before the node); the loop state is
    exactly the pre-existing variables the body writes through the
    fluid in-place contract (``increment(in_place=True)``,
    ``less_than(..., cond=cond)``, ``assign(..., output=...)``).
    Requires static mode — the construct IS a program-building
    construct. A While is not differentiable, as the reference's; train
    recurrences with StaticRNN.

    Usage (the reference's canonical counter loop)::

        i = layers.fill_constant([1], 'int64', 0)
        n = layers.fill_constant([1], 'int64', 10)
        cond = layers.less_than(i, n)
        w = layers.While(cond)
        with w.block():
            ...body ops...
            i = layers.increment(i, in_place=True)
            layers.less_than(i, n, cond=cond)
    """

    def __init__(self, cond, is_test=False, name=None):
        from ..static.program import building_program, Variable as _SVar
        prog = building_program()
        if prog is None or not isinstance(cond, _SVar):
            raise TypeError(
                "fluid.layers.While requires static mode with a "
                "program-variable cond (paddle.enable_static(), then "
                "build cond via fill_constant/less_than)")
        self._prog = prog
        self._cond = cond

    def block(self):
        return _WhileBlockGuard(self)


class _WhileBlockGuard:
    def __init__(self, w):
        self._w = w

    def __enter__(self):
        self._start = len(self._w._prog.ops)
        self._pre_vars = set(self._w._prog.vars)
        return self

    def __exit__(self, et, ev, tb):
        if et is not None:
            return False
        from ..static.program import (AliasRecord, ConstRecord, OpRecord,
                                      ScanRecord, WhileRecord)
        prog = self._w._prog
        body = prog.ops[self._start:]
        del prog.ops[self._start:]
        # loop carry = variables that exist BEFORE the block and are
        # written inside it (alias targets); names produced inside the
        # body are per-iteration temporaries
        produced, writes = set(), []

        def collect(records):
            for r in records:
                if isinstance(r, OpRecord):
                    produced.update(r.out_names)
                elif isinstance(r, ConstRecord):
                    produced.add(r.name)
                elif isinstance(r, AliasRecord):
                    if r.dst not in writes:
                        writes.append(r.dst)
                elif isinstance(r, WhileRecord):
                    collect(r.body)
                    for n in r.carry_names:
                        if n not in writes:
                            writes.append(n)
                elif isinstance(r, ScanRecord):
                    collect(r.body)

        collect(body)
        # an alias dst FIRST CREATED inside the block (assign's copy
        # variable) is a per-iteration temporary, not loop state — only
        # pre-existing variables can be carried
        carry = [self._w._cond.name] + [n for n in writes
                                        if n not in produced
                                        and n in self._pre_vars
                                        and n != self._w._cond.name]
        prog.ops.append(WhileRecord(self._w._cond.name, body, carry))
        return False


class StaticRNN:
    """fluid-1.x StaticRNN (reference: control_flow.py:451 -> the
    recurrent_op). The step block becomes the body of ONE
    ``ScanRecord`` over the sequence axis — memories are the carry, step
    inputs the xs, step outputs stacked ys. The scan runs under torch's
    autograd, so ``append_backward`` trains through it (the book-era
    PTB/seq-tagging recipes)."""

    def __init__(self, name=None):
        from ..static.program import building_program
        prog = building_program()
        if prog is None:
            raise TypeError(
                "fluid.layers.StaticRNN requires static mode "
                "(paddle.enable_static())")
        self._prog = prog
        self._seq_inputs = []   # (placeholder_name, src_name)
        self._mems = []         # [mem_name, init_spec, new_name]
        self._out_names = []    # body out names
        self._out_meta = []     # (shape, dtype) per output
        self._seq_len = None
        self._out_vars = []
        self._done = False

    def step(self):
        return _RNNStepGuard(self)

    def step_input(self, x):
        shape = x.shape
        if shape[0] in (-1, None):
            raise ValueError(
                "StaticRNN.step_input needs a static sequence length "
                f"(leading dim of {x.name} is dynamic)")
        if self._seq_len is None:
            self._seq_len = int(shape[0])
        elif int(shape[0]) != self._seq_len:
            raise ValueError("StaticRNN step inputs disagree on "
                             "sequence length")
        ph = self._prog.placeholder_var(shape[1:], x._v.dtype,
                                        "rnn_step_in")
        self._seq_inputs.append((ph.name, x.name))
        return ph

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0,
               ref_batch_dim_idx=1):
        if init is not None:
            if not init._symbolic:
                self._prog.register_persist(init)
                name, shp, dt = init.name, tuple(init.shape), \
                    init._value.dtype
            else:
                name, shp, dt = init.name, init.shape, init._v.dtype
            ph = self._prog.placeholder_var(shp, dt, "rnn_mem")
            spec = name
        else:
            if shape is None:
                raise ValueError("StaticRNN.memory needs init= or shape=")
            dt = (batch_ref._v.dtype if batch_ref is not None
                  else _torch.float32)
            ph = self._prog.placeholder_var(shape, dt, "rnn_mem")
            spec = ("zeros", tuple(shape), float(init_value),
                    str(dt).replace("torch.", ""))
        self._mems.append([ph.name, spec, None])
        return ph

    def update_memory(self, mem, x):
        for m in self._mems:
            if m[0] == mem.name:
                m[2] = x.name
                return
        raise ValueError(f"{mem.name} is not a memory of this StaticRNN")

    def step_output(self, o):
        self._out_names.append(o.name)
        self._out_meta.append((o.shape, o._v.dtype))

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self):
        if not self._done:
            raise RuntimeError("call the StaticRNN after its step() "
                               "block closes")
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return list(self._out_vars)


class _RNNStepGuard:
    def __init__(self, rnn):
        self._rnn = rnn

    def __enter__(self):
        self._start = len(self._rnn._prog.ops)
        return self

    def __exit__(self, et, ev, tb):
        if et is not None:
            return False
        from ..static.program import ScanRecord, Variable as _SVar
        rnn, prog = self._rnn, self._rnn._prog
        body = prog.ops[self._start:]
        del prog.ops[self._start:]
        if not rnn._seq_inputs:
            raise ValueError("StaticRNN needs at least one step_input")
        missing = [m[0] for m in rnn._mems if m[2] is None]
        if missing:
            raise ValueError(
                f"StaticRNN memories never updated: {missing} — call "
                "update_memory(mem, new_value) inside the step block")
        out_pairs = []
        for bname, (shp, dt) in zip(rnn._out_names, rnn._out_meta):
            name = prog._new_name("rnn_out")
            v = _SVar(name, [rnn._seq_len] + list(shp), dt, prog,
                      stop_gradient=False)
            prog.vars[name] = v
            rnn._out_vars.append(v)
            out_pairs.append((bname, name))
        prog.ops.append(ScanRecord(body, list(rnn._seq_inputs),
                                   [tuple(m) for m in rnn._mems],
                                   out_pairs))
        rnn._done = True
        return False


def _program_construct(name):
    def stub(*a, **k):
        from ..core.errors import UnimplementedError
        raise UnimplementedError(
            f"fluid.layers.{name}: fluid-1.x program-construct class; "
            "write python control flow (dy2static) or use "
            "static.nn.cond/while_loop")
    stub.__name__ = name
    return stub


def _descoped_construct(name, reason):
    def stub(*a, **k):
        from ..core.errors import UnimplementedError
        raise UnimplementedError(
            f"fluid.layers.{name} is explicitly descoped on this stack "
            f"(PARITY.md 'Known descopes'): {reason}")
    stub.__name__ = name
    return stub


Switch = _descoped_construct(
    "Switch", "use static.nn.case/switch_case — same semantics, one "
    "graph")
IfElse = _descoped_construct(
    "IfElse", "use static.nn.cond or dy2static if/else")
DynamicRNN = _descoped_construct(
    "DynamicRNN", "LoD-walking dynamic recurrence needs the fluid "
    "interpreter's dynamic shapes; use StaticRNN over padded "
    "batches (pad + sequence_mask)")
reorder_lod_tensor_by_rank = _descoped_construct(
    "reorder_lod_tensor_by_rank",
    "DynamicRNN's LoD-rank companion; padded batches make it moot")


# -- loss.py -----------------------------------------------------------------

def square_error_cost(input, label):  # noqa: A002
    from ..nn import functional as F
    return F.square_error_cost(input, label)


def mse_loss(input, label):  # noqa: A002
    from ..nn import functional as F
    return F.mse_loss(input, label)


def kldiv_loss(x, target, reduction="mean", name=None):
    from ..nn import functional as F
    return F.kl_div(x, target, reduction=reduction)


def huber_loss(input, label, delta):  # noqa: A002
    diff = _paddle().abs(input - label)
    quad = 0.5 * diff * diff
    lin = delta * diff - 0.5 * delta * delta
    return _paddle().where(diff <= delta, quad, lin)


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None, normalize=False):
    from ..nn import functional as F
    loss = F.binary_cross_entropy_with_logits(x, label,
                                              reduction="none")
    mask = (label != float(ignore_index)).astype(x.dtype)
    loss = loss * mask
    if normalize:
        loss = loss / _paddle().maximum(
            mask.sum(), _paddle().to_tensor(1.0))
    return loss


def rank_loss(label, left, right, name=None):
    """Reference rank_loss_op: cross entropy of P(left>right) =
    sigmoid(left-right) against the label:
    loss = log(1 + exp(d)) - label * d, d = left - right."""
    d = left - right
    # log(1+exp(d)) computed stably as softplus
    from ..nn import functional as F
    return F.softplus(d) - label * d


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    act = _paddle().maximum(
        -label * (left - right) + margin,
        _paddle().zeros_like(label))
    return act


from ..core.dispatch import register_op as _register_op2


@_register_op2("bpr_loss")
def _bpr_loss_op(logits, label):
    lv = label.reshape(-1).long()
    pos = _torch.take_along_dim(logits, lv[:, None], dim=-1)
    diff = pos - logits
    n = logits.shape[-1]
    loss = _torch.nn.functional.softplus(-diff)  # -log sigmoid(diff)
    mask = 1.0 - _torch.eye(n, dtype=logits.dtype, device=logits.device)[lv]
    return (loss * mask).sum(-1, keepdim=True) / (n - 1)


def bpr_loss(input, label, name=None):  # noqa: A002
    """Bayesian personalized ranking (reference bpr_loss_op): mean over
    negatives of -log sigmoid(pos_logit - neg_logit); differentiable."""
    return _bpr_loss_op(input, label)


def hsigmoid(input, label, num_classes, param_attr=None,  # noqa: A002
             bias_attr=None, name=None, path_table=None, path_code=None,
             is_custom=False, is_sparse=False):
    from ..nn import functional as F
    from ..nn import initializer as init_mod
    d = int(input.shape[-1])
    key = _reuse_key(name, ("hsigmoid", d, num_classes))
    pw = _layer_cache.get(key)
    if pw is None:
        pw = (_Parameter._own(init_mod.XavierNormal()(
            (num_classes - 1, d), "float32")),
            _Parameter._own(init_mod.Constant(0.0)(
                (num_classes - 1,), "float32")))
        _layer_cache[key] = pw
    return F.hsigmoid_loss(input, label, num_classes, pw[0], pw[1],
                           path_table=path_table, path_code=path_code)


def warpctc(input, label, blank=0, norm_by_times=False,  # noqa: A002
            input_length=None, label_length=None):
    from ..nn import functional as F
    return F.ctc_loss(input, label, input_length, label_length,
                      blank=blank, reduction="none")


def edit_distance(input, label, normalized=True,  # noqa: A002
                  ignored_tokens=None, input_length=None,
                  label_length=None):
    """Levenshtein distance per pair (reference edit_distance_op) —
    host-side DP (metric, no gradient)."""
    a = np.asarray(input.numpy())
    b = np.asarray(label.numpy())
    la = (np.asarray(input_length.numpy()).reshape(-1)
          if input_length is not None else np.full(a.shape[0], a.shape[1]))
    lb = (np.asarray(label_length.numpy()).reshape(-1)
          if label_length is not None else np.full(b.shape[0], b.shape[1]))
    outs = np.zeros((a.shape[0], 1), np.float32)
    for i in _builtin_range(a.shape[0]):
        s1 = [t for t in a[i, :int(la[i])]
              if not ignored_tokens or t not in ignored_tokens]
        s2 = [t for t in b[i, :int(lb[i])]
              if not ignored_tokens or t not in ignored_tokens]
        m, n = len(s1), len(s2)
        dp = np.zeros((m + 1, n + 1), np.int64)
        dp[:, 0] = np.arange(m + 1)
        dp[0, :] = np.arange(n + 1)
        for x_ in _builtin_range(1, m + 1):
            for y_ in _builtin_range(1, n + 1):
                dp[x_, y_] = min(dp[x_ - 1, y_] + 1, dp[x_, y_ - 1] + 1,
                                 dp[x_ - 1, y_ - 1]
                                 + (s1[x_ - 1] != s2[y_ - 1]))
        d = float(dp[m, n])
        outs[i, 0] = d / max(n, 1) if normalized else d
    return (_paddle().to_tensor(outs),
            _paddle().to_tensor(np.asarray([a.shape[0]], "int64")))


def center_loss(input, label, num_classes, alpha, param_attr=None,  # noqa: A002
                update_center=True):
    """Reference center_loss_op: 0.5*||x - c_y||^2 per sample; centers
    are a non-gradient buffer updated by the class-mean residual rule
    (grads flow to the input only, as in the reference kernel)."""
    d = int(input.shape[-1])
    key = ("center_loss_centers", num_classes, d)
    centers = _layer_cache.get(key)
    if centers is None:
        centers = Tensor(_torch.zeros((num_classes, d),
                                     device=_val(input).device),
                         stop_gradient=True)
        _layer_cache[key] = centers
    lv = _val(label).reshape(-1).long().to(centers.value.device)
    cv = centers.value
    sel = Tensor(cv[lv])                       # constant wrt autograd
    diff = input - sel
    if update_center:
        dv = _val(diff).detach()
        upd = _torch.zeros_like(cv).index_add_(0, lv, dv)
        cnt = _torch.zeros((num_classes, 1), device=cv.device).index_add_(
            0, lv, _torch.ones((lv.shape[0], 1), device=cv.device)) + 1.0
        centers.value = cv + alpha * upd / cnt
    return (0.5 * diff * diff).sum(axis=-1, keepdim=True)


_loss_unsupported_names = ("nce", "sampled_softmax_with_cross_entropy",
                           "teacher_student_sigmoid_loss")
nce = _fluid_unsupported(
    "nce", "negative sampling trains fine as a full softmax on the "
    "tensor cores; use softmax_with_cross_entropy")
sampled_softmax_with_cross_entropy = _fluid_unsupported(
    "sampled_softmax_with_cross_entropy",
    "use full softmax_with_cross_entropy (a dense product is cheap)")
teacher_student_sigmoid_loss = _fluid_unsupported(
    "teacher_student_sigmoid_loss",
    "CTR distillation loss; compose from sigmoid + log ops")


# -- sequence_lod.py ---------------------------------------------------------
# The repo carries ragged data as LoDTensor (dense + offsets,
# core/lod.py) or (padded, lengths) pairs (ops/sequence.py). Wrappers
# accept LoDTensor like the reference's LoD ops.

def _as_padded(x):
    """LoDTensor -> (padded [B, T, ...], lengths); padded Tensor passes
    through with full lengths."""
    from ..core.lod import LoDTensor
    if isinstance(x, LoDTensor):
        padded, lengths = x.to_padded()
        return padded, lengths
    lens = _paddle().full([int(x.shape[0])], int(x.shape[1]), "int64")
    return x, lens


def sequence_pad(x, pad_value, maxlen=None, name=None):
    from ..ops import sequence as seq_ops
    from ..core.lod import LoDTensor
    if isinstance(x, LoDTensor):
        padded, lengths = x.to_padded(pad_value=float(
            pad_value if not hasattr(pad_value, "numpy")
            else pad_value.numpy()))
        return padded, lengths
    return seq_ops.sequence_pad(x, pad_value=pad_value, maxlen=maxlen)


def sequence_unpad(x, length, name=None):
    from ..ops import sequence as seq_ops
    return seq_ops.sequence_unpad(x, length)


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0):  # noqa: A002
    from ..ops import sequence as seq_ops
    padded, lengths = _as_padded(input)
    return seq_ops.sequence_pool(padded, lengths,
                                 pool_type=pool_type.upper())


def sequence_softmax(input, use_cudnn=False, name=None):  # noqa: A002
    from ..ops import sequence as seq_ops
    padded, lengths = _as_padded(input)
    return seq_ops.sequence_softmax(padded, lengths)


def sequence_first_step(input):  # noqa: A002
    padded, lengths = _as_padded(input)
    return padded[:, 0]


def sequence_last_step(input):  # noqa: A002
    from ..ops import manipulation
    padded, lengths = _as_padded(input)
    idx = (lengths - 1).unsqueeze(-1)
    pv = _val(padded)
    lv = _val(idx).reshape(-1).long()
    return Tensor(pv[_torch.arange(pv.shape[0], device=pv.device), lv])


def sequence_reverse(x, name=None):
    from ..ops import sequence as seq_ops
    padded, lengths = _as_padded(x)
    return seq_ops.sequence_reverse(padded, lengths)


def sequence_expand(x, y, ref_level=-1, name=None):
    from ..ops import sequence as seq_ops
    _, y_lens = _as_padded(y)
    return seq_ops.sequence_expand(x, y_lens)


def sequence_expand_as(x, y, name=None):
    return sequence_expand(x, y)


def sequence_concat(input, name=None):  # noqa: A002
    from ..ops import manipulation
    return manipulation.concat(list(input), axis=1)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """lengths -> [B, maxlen] 0/1 mask (reference sequence_mask_op);
    delegates to the functional implementation."""
    from ..nn import functional as F
    return F.sequence_mask(x, maxlen=maxlen, dtype=dtype)


def sequence_reshape(input, new_dim):  # noqa: A002
    from ..ops import manipulation
    return manipulation.reshape(input, (int(input.shape[0]), -1,
                                        int(new_dim)))


def sequence_enumerate(input, win_size, pad_value=0, name=None):  # noqa: A002
    """Sliding windows of ids (reference sequence_enumerate_op)."""
    v = _val(input)
    b, t = v.shape[0], v.shape[1]
    cols = []
    for w in _builtin_range(win_size):
        shifted = _torch.cat(
            [v[:, int(w):],
             _torch.full((b, int(w)), pad_value, dtype=v.dtype,
                        device=v.device)], dim=1)
        cols.append(shifted)
    return Tensor(_torch.stack(cols, dim=-1))


def sequence_slice(input, offset, length, name=None):  # noqa: A002
    vn = _val(input).detach().cpu().numpy()
    off = _val(offset).detach().cpu().numpy().reshape(-1)
    ln = _val(length).detach().cpu().numpy().reshape(-1)
    v = vn
    out = np.zeros((v.shape[0], int(ln.max())) + v.shape[2:], vn.dtype)
    for i in _builtin_range(v.shape[0]):
        out[i, :int(ln[i])] = vn[i, int(off[i]):int(off[i]) + int(ln[i])]
    return Tensor(out), Tensor(np.asarray(ln, "int64"))


def sequence_scatter(input, index, updates, name=None):  # noqa: A002
    return _paddle().scatter(input, index, updates, overwrite=False)


def sequence_conv(input, num_filters, filter_size=3,  # noqa: A002
                  filter_stride=1, padding=True, padding_start=None,
                  bias_attr=None, param_attr=None, act=None, name=None):
    """Context-window conv over time (reference sequence_conv_op) —
    conv1d over the padded representation."""
    from ..nn.layer.conv import Conv1D
    padded, lengths = _as_padded(input)
    d = int(padded.shape[-1])
    layer = _cached_layer(name, ("seq_conv", d, num_filters,
                                 filter_size),
                          lambda: Conv1D(d, num_filters, filter_size,
                                         padding=(filter_size - 1) // 2
                                         if padding else 0,
                                         bias_attr=bias_attr))
    from ..ops import manipulation
    x = manipulation.transpose(padded, (0, 2, 1))   # [B, D, T]
    out = layer(x)
    return _apply_act(manipulation.transpose(out, (0, 2, 1)), act)


# -- detection.py ------------------------------------------------------------

def iou_similarity(x, y, box_normalized=True, name=None):
    """IoU matrix [N, M] (reference iou_similarity_op)."""
    a = _val(x)
    b = _val(y)
    off = 0.0 if box_normalized else 1.0
    area_a = (a[:, 2] - a[:, 0] + off) * (a[:, 3] - a[:, 1] + off)
    area_b = (b[:, 2] - b[:, 0] + off) * (b[:, 3] - b[:, 1] + off)
    lt = _torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = _torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = _torch.clamp(rb - lt + off, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return Tensor(inter / (area_a[:, None] + area_b[None, :] - inter))


def box_clip(input, im_info, name=None):  # noqa: A002
    boxes = _val(input)
    info = _val(im_info)
    h = info[0, 0] / info[0, 2] - 1.0
    w = info[0, 1] / info[0, 2] - 1.0
    zero = _torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    out = _torch.stack([
        _torch.clamp(boxes[..., 0], zero, w),
        _torch.clamp(boxes[..., 1], zero, h),
        _torch.clamp(boxes[..., 2], zero, w),
        _torch.clamp(boxes[..., 3], zero, h),
    ], dim=-1)
    return Tensor(out)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None, axis=0):
    """Encode/decode boxes against priors (reference box_coder_op)."""
    pb = _val(prior_box)
    pbv = _val(prior_box_var, _torch.float32).to(pb.device)
    tb = _val(target_box)
    off = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + off
    ph = pb[:, 3] - pb[:, 1] + off
    px = (pb[:, 2] + pb[:, 0]) / 2
    py = (pb[:, 3] + pb[:, 1]) / 2
    if pbv.ndim == 1:
        pbv = pbv[None, :].expand(pb.shape[0], 4)
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + off
        th = tb[:, 3] - tb[:, 1] + off
        tx = (tb[:, 2] + tb[:, 0]) / 2
        ty = (tb[:, 3] + tb[:, 1]) / 2
        out = _torch.stack([
            (tx[:, None] - px[None, :]) / pw[None, :],
            (ty[:, None] - py[None, :]) / ph[None, :],
            _torch.log(tw[:, None] / pw[None, :]),
            _torch.log(th[:, None] / ph[None, :]),
        ], dim=-1) / pbv[None, :, :]
        return Tensor(out)
    # decode_center_size: target [N, M, 4] deltas against priors
    if axis == 0:
        pwv, phv, pxv, pyv = (pw[None, :, None], ph[None, :, None],
                              px[None, :], py[None, :])
    else:
        pwv, phv, pxv, pyv = (pw[:, None, None], ph[:, None, None],
                              px[:, None], py[:, None])
    if pbv.ndim == 2:
        d = tb * (pbv[None, :, :] if axis == 0 else pbv[:, None, :])
    else:
        d = tb
    dx, dy, dw, dh = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    cx = dx * pwv[..., 0] + pxv
    cy = dy * phv[..., 0] + pyv
    w = _torch.exp(dw) * pwv[..., 0]
    h = _torch.exp(dh) * phv[..., 0]
    out = _torch.stack([cx - w / 2 + off / 2, cy - h / 2 + off / 2,
                       cx + w / 2 - off / 2, cy + h / 2 - off / 2],
                      dim=-1)
    return Tensor(out)


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    from ..nn import functional as F
    from ..ops import math as math_ops
    num = _paddle().cast(fg_num, "float32")
    oh = one_hot(label, int(x.shape[-1]) + 1)
    target = oh[:, 1:] if oh.shape[-1] == int(x.shape[-1]) + 1 else oh
    loss = F.sigmoid_focal_loss(x, target, reduction="none",
                                gamma=gamma, alpha=alpha)
    return math_ops.divide(loss, _paddle().maximum(
        num, _paddle().to_tensor(1.0)))


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None, scale_x_y=1.0):
    from ..vision.ops import yolo_loss as _yl
    return _yl(x, gt_box, gt_label, anchors, anchor_mask, class_num,
               ignore_thresh, downsample_ratio, gt_score=gt_score,
               use_label_smooth=use_label_smooth, scale_x_y=scale_x_y)


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None,
             scale_x_y=1.0):
    from ..vision.ops import yolo_box as _yb
    return _yb(x, img_size, anchors, class_num, conf_thresh,
               downsample_ratio, clip_bbox=clip_bbox,
               scale_x_y=scale_x_y)


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k,
                   keep_top_k, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None):
    """Per-class NMS + cross-class top-k (reference multiclass_nms_op);
    host-side composition over vision.ops.nms."""
    from ..vision.ops import nms as _nms
    bv = _val(bboxes).detach().cpu().numpy()
    sv = _val(scores).detach().cpu().numpy()
    outs = []
    n, c = sv.shape[0], sv.shape[1]
    for b in _builtin_range(n):
        dets = []
        for cls in _builtin_range(c):
            if cls == background_label:
                continue
            sc = sv[b, cls]
            keep = sc > score_threshold
            if not keep.any():
                continue
            boxes_c = bv[b][keep] if bv.ndim == 3 else bv[keep]
            sc = sc[keep]
            order = np.argsort(-sc)[:nms_top_k]
            kept = _nms(_paddle().to_tensor(boxes_c[order]),
                        iou_threshold=nms_threshold)
            kept = np.asarray(kept.numpy())
            for k in kept:
                dets.append([float(cls), float(sc[order][k])]
                            + [float(v) for v in boxes_c[order][k]])
        dets.sort(key=lambda r: -r[1])
        outs.append(np.asarray(dets[:keep_top_k], np.float32)
                    .reshape(-1, 6))
    flat = np.concatenate(outs, 0) if outs else np.zeros((0, 6),
                                                         np.float32)
    lens = np.asarray([len(o) for o in outs], "int64")
    return _paddle().to_tensor(flat), _paddle().to_tensor(lens)


def prior_box(input, image, min_sizes, max_sizes=None,  # noqa: A002
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              name=None, min_max_aspect_ratios_order=False):
    """SSD prior boxes over the feature-map grid (reference
    prior_box_op); deterministic host-side construction."""
    fh, fw = int(input.shape[2]), int(input.shape[3])
    ih, iw = int(image.shape[2]), int(image.shape[3])
    sw = steps[0] or iw / fw   # reference order: (step_w, step_h)
    sh = steps[1] or ih / fh
    ars = []
    for ar in aspect_ratios:
        ars.append(ar)
        if flip and ar != 1.0:
            ars.append(1.0 / ar)
    per = []
    for ms in min_sizes:
        per.append((ms, ms))
        for ar in ars:
            if ar == 1.0:
                continue
            per.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
    if max_sizes:
        for ms, mx in zip(min_sizes, max_sizes):
            per.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
    k = len(per)
    out = np.zeros((fh, fw, k, 4), np.float32)
    for i in _builtin_range(fh):
        for j in _builtin_range(fw):
            cx = (j + offset) * sw
            cy = (i + offset) * sh
            for p, (bw, bh) in enumerate(per):
                out[i, j, p] = [(cx - bw / 2) / iw, (cy - bh / 2) / ih,
                                (cx + bw / 2) / iw, (cy + bh / 2) / ih]
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          out.shape).copy()
    return _paddle().to_tensor(out), _paddle().to_tensor(var)


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,  # noqa: A002
                     variance=(0.1, 0.1, 0.2, 0.2), stride=None,
                     offset=0.5, name=None):
    """RPN anchors over the grid (reference anchor_generator_op)."""
    fh, fw = int(input.shape[2]), int(input.shape[3])
    sw, sh = stride              # reference order: [stride_w, stride_h]
    per = []
    for size in anchor_sizes:
        area = float(size) * float(size)
        for ar in aspect_ratios:
            w = np.sqrt(area / ar)
            h = w * ar
            per.append((w, h))
    out = np.zeros((fh, fw, len(per), 4), np.float32)
    for i in _builtin_range(fh):
        for j in _builtin_range(fw):
            cx = (j + offset) * sw
            cy = (i + offset) * sh
            for p, (w, h) in enumerate(per):
                out[i, j, p] = [cx - w / 2, cy - h / 2,
                                cx + w / 2, cy + h / 2]
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          out.shape).copy()
    return _paddle().to_tensor(out), _paddle().to_tensor(var)


_det_pipeline = (
    "legacy detection-pipeline kernel; modern pipelines compose these "
    "host-side (PaddleDetection-style python)")
density_prior_box = _fluid_unsupported("density_prior_box", _det_pipeline)
multi_box_head = _fluid_unsupported("multi_box_head", _det_pipeline)
bipartite_match = _fluid_unsupported("bipartite_match", _det_pipeline)
target_assign = _fluid_unsupported("target_assign", _det_pipeline)
detection_output = _fluid_unsupported("detection_output", _det_pipeline)
ssd_loss = _fluid_unsupported("ssd_loss", _det_pipeline)
rpn_target_assign = _fluid_unsupported("rpn_target_assign",
                                       _det_pipeline)
retinanet_target_assign = _fluid_unsupported("retinanet_target_assign",
                                             _det_pipeline)
roi_perspective_transform = _fluid_unsupported(
    "roi_perspective_transform", _det_pipeline)
generate_proposal_labels = _fluid_unsupported(
    "generate_proposal_labels", _det_pipeline)
generate_proposals = _fluid_unsupported("generate_proposals",
                                        _det_pipeline)
generate_mask_labels = _fluid_unsupported("generate_mask_labels",
                                          _det_pipeline)
polygon_box_transform = _fluid_unsupported("polygon_box_transform",
                                           _det_pipeline)
locality_aware_nms = _fluid_unsupported("locality_aware_nms",
                                        _det_pipeline)
matrix_nms = _fluid_unsupported("matrix_nms", _det_pipeline)
retinanet_detection_output = _fluid_unsupported(
    "retinanet_detection_output", _det_pipeline)


# -- rnn.py ------------------------------------------------------------------

def _nn():
    import paddle_tpu_torch.nn as _n
    return _n


from ..nn.layer.rnn import RNNCellBase as RNNCell  # noqa: N812
# (a real base class: fluid user code subclasses fluid.layers.RNNCell)


def GRUCell(hidden_size, *a, **k):  # noqa: N802
    return _nn().GRUCell(hidden_size, hidden_size)


def LSTMCell(hidden_size, *a, **k):  # noqa: N802
    return _nn().LSTMCell(hidden_size, hidden_size)


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    from ..ops import manipulation
    x = manipulation.transpose(inputs, (1, 0, 2)) if time_major \
        else inputs
    if is_reverse:
        x = _paddle().flip(x, axis=[1])
    layer = _nn().RNN(cell)
    out, state = layer(x, initial_states)
    if is_reverse:
        out = _paddle().flip(out, axis=[1])
    if time_major:
        out = manipulation.transpose(out, (1, 0, 2))
    return out, state


def birnn(cell_fw, cell_bw, inputs, initial_states=None,
          sequence_length=None, time_major=False, **kwargs):
    layer = _nn().BiRNN(cell_fw, cell_bw)
    return layer(inputs, initial_states)


class Decoder:
    """Abstract decode contract (reference fluid/layers/rnn.py Decoder):
    subclass and implement initialize/step/finalize, drive with
    dynamic_decode."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError


def BeamSearchDecoder(*a, **k):  # noqa: N802
    return _nn().BeamSearchDecoder(*a, **k)


def dynamic_decode(decoder, inits=None, max_step_num=32, **kwargs):
    return _nn().dynamic_decode(decoder, inits=inits,
                                max_step_num=max_step_num, **kwargs)


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,  # noqa: A002
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    d = int(input.shape[-1])
    layer = _cached_layer(name, ("lstm", d, hidden_size, num_layers,
                                 is_bidirec),
                          lambda: _nn().LSTM(
                              d, hidden_size, num_layers=num_layers,
                              direction="bidirect" if is_bidirec
                              else "forward"))
    out, (h, c) = layer(input, (init_h, init_c))
    return out, h, c


def dynamic_gru(input, size, param_attr=None, bias_attr=None,  # noqa: A002
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False):
    d = int(input.shape[-1])
    layer = _cached_layer(None, ("dyn_gru", d, size),
                          lambda: _nn().GRU(d, size))
    x = _paddle().flip(input, axis=[1]) if is_reverse else input
    out, _ = layer(x, h_0.unsqueeze(0) if h_0 is not None else None)
    return _paddle().flip(out, axis=[1]) if is_reverse else out


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,  # noqa: A002
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    d = int(input.shape[-1])
    cell = _cached_layer(None, ("gru_unit", d, size),
                         lambda: _nn().GRUCell(d, size // 3))
    h = cell(input, hidden)[1]
    return h, h, h


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    d = int(x_t.shape[-1])
    hd = int(hidden_t_prev.shape[-1])
    cell = _cached_layer(name, ("lstm_unit", d, hd),
                         lambda: _nn().LSTMCell(d, hd))
    _, (h, c) = cell(x_t, (hidden_t_prev, cell_t_prev))
    return h, c


dynamic_lstm = _fluid_unsupported(
    "dynamic_lstm", "use fluid.layers.lstm or paddle.nn.LSTM")
dynamic_lstmp = _fluid_unsupported(
    "dynamic_lstmp", "projection LSTM; use paddle.nn.LSTM with proj_size")
beam_search = _fluid_unsupported(
    "beam_search", "stepwise beam op; use BeamSearchDecoder + "
    "dynamic_decode")
beam_search_decode = _fluid_unsupported(
    "beam_search_decode", "use gather_tree on dynamic_decode outputs")
DecodeHelper = _program_construct("DecodeHelper")
TrainingHelper = _program_construct("TrainingHelper")
GreedyEmbeddingHelper = _program_construct("GreedyEmbeddingHelper")
SampleEmbeddingHelper = _program_construct("SampleEmbeddingHelper")
BasicDecoder = _program_construct("BasicDecoder")


# -- metric_op.py ------------------------------------------------------------

def auc(input, label, curve="ROC", num_thresholds=4095,  # noqa: A002
        topk=1, slide_steps=1):
    """Streaming-free AUC over this batch (reference auc_op reduced:
    single-shot; use paddle.metric.Auc for streaming)."""
    from ..metric import Auc
    m = Auc(num_thresholds=num_thresholds)
    m.update(np.asarray(input.numpy()), np.asarray(label.numpy()))
    val = m.accumulate()
    T = _paddle().to_tensor
    return (T(np.float32(val)), T(np.float32(val)),
            [T(np.zeros(1, np.int64))] * 4)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    from ..nn import functional as F
    return F.npair_loss(anchor, positive, labels, l2_reg=l2_reg)


distribute_fpn_proposals = _fluid_unsupported(
    "distribute_fpn_proposals", _det_pipeline)
collect_fpn_proposals = _fluid_unsupported(
    "collect_fpn_proposals", _det_pipeline)
box_decoder_and_assign = _fluid_unsupported(
    "box_decoder_and_assign", _det_pipeline)


# -- learning_rate_scheduler.py ---------------------------------------------
# fluid's decay functions return the CURRENT lr value given the global
# step counter (autoincreased_step_counter); modern code uses
# optimizer.lr schedulers — these forward to the same math.

def _global_step():
    t = _step_counters.get("@LR_DECAY_COUNTER@")
    if t is None:
        t = _paddle().to_tensor(np.asarray([0], "int64"))
        _step_counters["@LR_DECAY_COUNTER@"] = t
    return t


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _paddle().cast(_global_step(), "float32")
    exp = step / decay_steps
    if staircase:
        exp = _paddle().floor(exp)
    return learning_rate * (decay_rate ** exp)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _paddle().cast(_global_step(), "float32")
    exp = step / decay_steps
    if staircase:
        exp = _paddle().floor(exp)
    return learning_rate * _paddle().exp(-1.0 * decay_rate * exp)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _paddle().cast(_global_step(), "float32")
    frac = step / decay_steps
    if staircase:
        frac = _paddle().floor(frac)
    return learning_rate / (1.0 + decay_rate * frac)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    step = _paddle().cast(_global_step(), "float32")
    if cycle:
        div = _paddle().ceil(_paddle().maximum(
            step / decay_steps, _paddle().to_tensor(1.0)))
        decay = decay_steps * div
    else:
        decay = float(decay_steps)
        step = _paddle().minimum(step, _paddle().to_tensor(decay))
    return ((learning_rate - end_learning_rate)
            * ((1.0 - step / decay) ** power)) + end_learning_rate


def piecewise_decay(boundaries, values):
    step = int(_global_step().numpy()[0])
    for b, v in zip(boundaries, values):
        if step < b:
            return _paddle().to_tensor(np.float32(v))
    return _paddle().to_tensor(np.float32(values[len(boundaries)]))


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    step = _paddle().cast(_global_step(), "float32") + 1.0
    return (learning_rate * (d_model ** -0.5)
            * _paddle().minimum(step ** -0.5,
                                step * (warmup_steps ** -1.5)))


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _paddle().cast(_global_step(), "float32")
    epoch = _paddle().floor(step / step_each_epoch)
    return learning_rate * 0.5 * (
        _paddle().cos(epoch * float(np.pi) / epochs) + 1.0)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _paddle().cast(_global_step(), "float32")
    warm = start_lr + (end_lr - start_lr) * step / warmup_steps
    base = learning_rate if not hasattr(learning_rate, "numpy") \
        else learning_rate
    cond = step < float(warmup_steps)
    return _paddle().where(cond, warm * _paddle().ones_like(step),
                           base * _paddle().ones_like(step))


# -- io.py / distributions re-exports ---------------------------------------

def load(out, file_path, load_as_fp16=None):
    v = _paddle().load(file_path)
    out.value = (v.value if hasattr(v, "value")
                 else _paddle().to_tensor(v).value)
    return out


read_file = _program_construct("read_file")
double_buffer = _program_construct("double_buffer")
py_reader = _program_construct("py_reader")
create_py_reader_by_data = _program_construct("create_py_reader_by_data")

from ..distribution import (  # noqa: E402,F401
    Uniform, Normal, Categorical, MultivariateNormalDiag)
