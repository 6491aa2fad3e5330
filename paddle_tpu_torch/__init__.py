"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference; this package computes
the same functions with PyTorch for plain tensor code and hand-written
CUDA C++ kernels (``csrc/``, built for ``sm_90a`` at first use) where
the reference had a Pallas TPU kernel. It never imports ``jax`` or
``paddle_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper computes its plain PyTorch version.

Ported so far: GPT-124M paged serving (``serving.ServingEngine`` over
``text.models.GPTForCausalLM``) with the paged decode-attention kernel
and the flash-attention forward kernel, and the model's own
``generate()`` (greedy, top-k sampling, beam search); training of the
GPT, tied head (the default) or untied (``model(ids, labels=labels)``,
``loss.backward()``, every optimizer of ``optimizer`` with
``regularizer`` objects, ``state_dict`` and ``minimize``, the clips of
``nn``, ``optimizer.lr``), with per-block recompute, under
``amp.auto_cast`` O1/O2 with ``amp.GradScaler`` or in f32, with the
flash-attention backward kernels and the fused linear cross-entropy
kernels; ``seed`` seeds the dropout generators. The Paddle-style eager
core: ``Tensor``/``Parameter`` over a torch tensor with ``to_tensor``,
the dtypes and Places, ``set_device``, ``set_flags``, ``no_grad`` /
``enable_grad``, ``autograd.PyLayer`` and ``grad`` on torch's autograd,
and the math, reduction, logic, creation, manipulation and search ops
(``paddle_tpu_torch.add``, ``sum``, ``zeros``, ``reshape``, ``topk``,
...), which are also the Tensor's operators and methods. The ``nn``
surface: ``nn.Layer`` and the common, activation, container and loss
layers, ``LayerNorm``, ``nn.initializer`` and ``ParamAttr``, and
``nn.functional`` (the activations, dropouts, ``linear``, ``layer_norm``,
``embedding``, the losses, and ``scaled_dot_product_attention`` through
the flash kernels); the optimizers take ``Layer.parameters()``.
``paddle_tpu_torch.tensor`` forwards the names as the reference's
``paddle.tensor`` does. The vision surface: the conv, pooling, batch /
group / instance norm and resampling ops and layers, ``vision.models``
(LeNet, ResNet, VGG, MobileNet), ``vision.ops``, ``vision.transforms``,
``vision.datasets`` over ``io``'s dataset classes. The recurrent
surface: ``nn.LSTM``/``GRU``/``SimpleRNN``, the cells, ``nn.RNN``/
``BiRNN``, ``BeamSearchDecoder``/``dynamic_decode``, the CTC and
hierarchical-sigmoid losses, ``gather_tree``; LoD tensors
(``core.lod``) and the sequence ops with the CRF (``ops.sequence``);
``io.DataLoader`` with its samplers and worker processes,
``text.datasets``, ``metric``, and ``Model`` (``fit``, ``evaluate``,
``predict``), ``callbacks``, ``summary`` and ``flops`` of ``hapi``.
``jit.to_static`` converts a step's Tensor control flow (dy2static) and
captures the whole step as one CUDA graph on the card, a Tensor
``if``/``while`` as CUDA conditional nodes; ``static`` builds programs
(``enable_static()``, ``program_guard``, ``Executor``, ``static.nn``),
and ``enable_static()`` puts ``Model``'s steps through ``to_static``;
``analysis`` attributes a Tensor that leaks out of a captured branch;
``reader``, the
legacy ``dataset`` reader creators, ``distribution`` and ``core.native``
(the C++ runtime's bindings). Deployment: ``jit.save``/``jit.load``
(the forward recorded as a static program beside its parameters),
``inference`` (``Config``, ``create_predictor``, ``PredictorPool``: the
loaded program replayed as a CUDA graph), ``quantization`` (QAT, PTQ,
W8A8 int8 through ``torch._int_mm`` on the card), ``onnx.export``,
``device`` (memory queries, streams) and ``version``. Eager code runs
lazily by default (``FLAGS_lazy_eager``, ``core/lazy.py``): an eager
training step is deferred into one graph, run at ``clear_grad()`` or a
host read and, on the card, replayed as one CUDA graph from its third
step; ``_C_ops`` holds the ops' fast entry points and ``profiler`` the
``record_scope`` instrument and a ``Profiler`` writing chrome traces.
``distributed`` holds collectives, data, tensor, sequence and pipeline
parallelism, ZeRO, MoE and sharded checkpoints; ``fluid`` the 1.x
compat layer. The last modules: ``incubate`` (``asp`` 2:4 sparsity,
``LookAhead``, ``ModelAverage``, ``softmax_mask_fuse``,
``checkpoint.auto_checkpoint``), ``utils.cpp_extension`` (host C++ ops
built with ``g++``) and ``utils.unique_name``, ``sysconfig``, ``hub``,
``compat`` and ``text.gpt3_1p3b``: every module and public name of the
reference has its counterpart here, or a reason in
``tests/test_torch_api_surface.py``.
"""
from . import (  # noqa: F401
    amp, autograd, framework, io, nn, optimizer, regularizer, tensor, utils)
from .autograd import grad
from .core import errors
from .core.device import (
    CPUPlace, CUDAPinnedPlace, CUDAPlace, Place, device_count, get_device,
    get_place, is_compiled_with_cuda, is_compiled_with_npu,
    is_compiled_with_rocm, is_compiled_with_tpu, is_compiled_with_xpu,
    resolve_device, set_device)
from .core.dispatch import enable_grad, is_grad_enabled, no_grad
from .core.dtype import (
    bfloat16, complex64, complex128, float16, float32, float64,
    get_default_dtype, int8, int16, int32, int64, set_default_dtype, uint8)
from .core.dtype import bool_ as bool  # noqa: A004
from .core.flags import get_flags, set_flags
from .core.rng import default_generator, seed
from .core.tensor import Parameter, Tensor
from .framework.io_utils import load, save
from . import ops  # attaches the operators and methods to Tensor
from . import vision  # noqa: E402
from . import observability, profiler  # noqa: E402,F401
from . import _C_ops  # noqa: E402,F401
from . import jit, metric, static, text  # noqa: E402,F401
from . import dataset, distribution, reader  # noqa: E402,F401
from . import distributed  # noqa: E402,F401
from .distributed import DataParallel  # noqa: E402,F401
from . import incubate  # noqa: E402,F401
from . import fluid  # noqa: E402,F401
from .static import (  # noqa: E402,F401
    disable_static, enable_static, in_dynamic_mode)
from . import device, onnx, quantization, version  # noqa: E402,F401
from .device import get_cudnn_version  # noqa: E402,F401
from .hapi import callbacks  # noqa: E402,F401
from .hapi.model import Model  # noqa: E402,F401
from .hapi.summary import flops, summary  # noqa: E402,F401
from .ops.logic import (
    allclose, bitwise_and, bitwise_not, bitwise_or, bitwise_xor, equal,
    equal_all, greater_equal, greater_than, is_empty, is_tensor, isclose,
    less_equal, less_than, logical_and, logical_not, logical_or,
    logical_xor, not_equal)
from .ops.math import (  # noqa: A004
    abs, acos, add, add_n, addmm, angle, asin, asinh, acosh, atan, atan2,
    atanh, bmm, cast, ceil, clip, clone, conj, cos, cosh, cross, cumprod,
    cumsum, cumulative_trapezoid, deg2rad, diff, digamma, divide, dot,
    einsum, erf, erfinv, exp, expm1, floor, floor_divide, floor_mod, fmax,
    fmin, frac, heaviside, histogram, hypot, i0, igamma, imag, increment,
    inner, isfinite, isinf, isnan, kron, lerp, lgamma, log, log1p, log2,
    log10, logaddexp, logcumsumexp, logit, matmul, maximum, minimum, mm,
    mod, multiply, mv, nan_to_num, neg, outer, polygamma, pow, rad2deg,
    real, reciprocal, remainder, renorm, round, rsqrt, scale, sigmoid,
    sign, sin, sinh, sqrt, square, stanh, subtract, tan, tanh, trace,
    trapezoid, trunc, vander)
from .ops.creation import (
    arange, assign, bernoulli, create_parameter, diag, diagflat, empty,
    empty_like, eye, full, full_like, linspace, logspace, multinomial,
    normal, ones, ones_like, rand, rand_like, randint, randn, randperm,
    standard_normal, to_tensor, tril, triu, uniform, zeros, zeros_like)
from .ops.manipulation import (  # noqa: A004
    as_complex, as_real, broadcast_shape, broadcast_tensors, broadcast_to,
    chunk, concat, crop, crop_tensor, diagonal, expand, expand_as, flatten,
    flip, gather, gather_nd, index_add, index_add_, index_fill,
    index_fill_, index_sample, index_select, masked_fill, masked_select,
    meshgrid, moveaxis, multiplex, numel, put_along_axis, repeat_interleave,
    reshape, reshape_, reverse, roll, rot90, scatter, scatter_,
    scatter_nd, scatter_nd_add, shape, shard_index, slice, split, squeeze,
    squeeze_, stack, strided_slice, t, take_along_axis, tensordot, tile,
    tolist, transpose, unbind, unfold, unsqueeze, unsqueeze_, unstack,
    view_as_complex, view_as_real, where)
from .ops.nn_ops import one_hot
from .ops import linalg
from .ops.linalg import (
    cholesky, cholesky_solve, corrcoef, cov, det, eig, eigh, eigvalsh,
    householder_product, inverse, lstsq, lu, matrix_power, matrix_rank,
    multi_dot, pinv, qr, slogdet, solve, svd, triangular_solve)
from .ops.search import (
    argmax, argmin, argsort, bincount, bucketize, kthvalue, mode, nonzero,
    searchsorted, sort, topk, unique)
from .nn.initializer import ParamAttr
from .ops.reduction import (  # noqa: A004
    all, amax, amin, any, count_nonzero, dist, logsumexp, max, mean,
    median, min, nanmean, nanmedian, nanquantile, nansum, norm, prod,
    quantile, std, sum, var)
from .ops.math import multiply as elementwise_mul, tanh_  # noqa: E402
from .core.device import NPUPlace, TPUPlace, XPUPlace  # noqa: E402
from .core.dtype import DType as dtype  # noqa: E402
from . import compat, hub, sysconfig  # noqa: E402,F401

import numpy as _np  # noqa: E402

__version__ = version.full_version

# the reference's remaining top-level names (paddle_tpu/__init__.py:
# 105-265; python/paddle/__init__.py)
VarBase = Tensor    # Paddle's imperative VarBase


def is_grad_enabled_():
    return is_grad_enabled()


def rank(x):
    """The rank of ``x`` as a 0-d Tensor on the current device."""
    return to_tensor(_np.asarray(x.ndim if isinstance(x, Tensor)
                                 else _np.ndim(x)))


def enable_dygraph(place=None):
    return disable_static(place)


def disable_dygraph():
    return enable_static()


def in_dygraph_mode():
    return in_dynamic_mode()


def set_grad_enabled(mode):
    """A context manager that turns autograd on or off."""
    return enable_grad() if mode else no_grad()


_print_options = {"precision": 8, "threshold": 1000, "edgeitems": 3,
                  "linewidth": 80, "sci_mode": None}


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Reference ``python/paddle/tensor/to_string.py`` set_printoptions:
    kept in ``_print_options`` and set on numpy, which prints a Tensor's
    values."""
    kw = {}
    if precision is not None:
        _print_options["precision"] = precision
        kw["precision"] = precision
    if threshold is not None:
        _print_options["threshold"] = threshold
        kw["threshold"] = threshold
    if edgeitems is not None:
        _print_options["edgeitems"] = edgeitems
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        _print_options["linewidth"] = linewidth
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        _print_options["sci_mode"] = sci_mode
        kw["suppress"] = not sci_mode
    _np.set_printoptions(**kw)


def get_cuda_rng_state():
    """The states of the port's default generators on every card, card
    0 first (``paddle.get_cuda_rng_state``); raises without CUDA."""
    import torch
    from .core import rng as _rng
    resolve_device("cuda")
    return [_rng.get_state(torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state):
    """Set the port's default generators on the cards to ``state`` (from
    ``get_cuda_rng_state``): the draws after it repeat."""
    import torch
    from .core import rng as _rng
    resolve_device("cuda")
    for i, s in enumerate(state):
        _rng.set_state(s, torch.device("cuda", i))


def monkey_patch_math_varbase():
    """No-op: the Tensor's operators are attached at import
    (``ops/__init__.py``)."""
    return None


def monkey_patch_variable():
    return None


def check_shape(shape):
    """Static-graph shape validation (reference
    ``fluid/layers/utils.py`` check_shape)."""
    for s in shape if not isinstance(shape, (int,)) else [shape]:
        if isinstance(s, int) and s < -1:
            raise ValueError(f"invalid dim {s} in shape {shape}")


def batch(reader, batch_size, drop_last=False):
    """Batch a sample reader into a batch reader (``paddle.batch``)."""
    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batch_reader


__all__ = [n for n in dir() if not n.startswith("_")]
