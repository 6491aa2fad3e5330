"""The reference's analytic-against-numeric grad sweep
(``tests/test_op_grads_sweep.py``, the OpTest.check_grad pattern)
through the port's eager path, once under lazy eager and once
immediate: for every case, the grad of ``sum(fn(x))`` by
``backward()`` against central differences (``tests/grad_check.py``,
the reference's tolerances), and against the reference's analytic grad
of the same case (1e-4 of the largest, plus 1e-6 for the grads that
sum to about zero). The inputs are the reference's
(``_X``, ``_POS``, ``_UNIT``, ``_IMG``, drawn from ``RandomState(0)`` in
its order)."""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from grad_check import numeric_grad
from paddle_tpu_torch.core import device as device_mod

REF_TOL = 1e-4
# the f32 noise of a grad that sums to about zero (softmax, layer_norm
# and normalize under sum()), below which "of the largest" means nothing
REF_ATOL = 1e-6

_rs = np.random.RandomState(0)
_X = _rs.uniform(0.3, 1.7, (3, 4)).astype(np.float64) \
    * np.where(_rs.rand(3, 4) < 0.5, -1.0, 1.0)
_POS = _rs.uniform(0.3, 1.7, (3, 4))
_UNIT = _rs.uniform(-0.9, 0.9, (3, 4))
_IMG = _rs.uniform(0.3, 1.7, (2, 3, 6, 6)) \
    * np.where(_rs.rand(2, 3, 6, 6) < 0.5, -1.0, 1.0)
_ms = np.random.RandomState(1)
_A = _ms.randn(3, 4)
_B = _ms.randn(4, 2)
_W = _ms.randn(4, 3, 3, 3) * 0.3
_EMB = _ms.randn(4, 5)
_LABELS = _ms.randint(0, 4, (3,)).astype("int64")
_COND = _ms.rand(3, 4) < 0.5


def _unary(P):
    F = P.nn.functional
    t32 = lambda a: P.to_tensor(np.asarray(a, np.float32))  # noqa: E731
    return {
        "exp": (lambda t: t.exp(), _X),
        "log": (lambda t: t.log(), _POS),
        "sqrt": (lambda t: t.sqrt(), _POS),
        "rsqrt": (lambda t: t.rsqrt(), _POS),
        "tanh": (lambda t: t.tanh(), _X),
        "sigmoid": (lambda t: F.sigmoid(t), _X),
        "relu": (lambda t: F.relu(t), _X),
        "leaky_relu": (lambda t: F.leaky_relu(t, 0.1), _X),
        "elu": (lambda t: F.elu(t), _X),
        "selu": (lambda t: F.selu(t), _X),
        "gelu": (lambda t: F.gelu(t), _X),
        "softplus": (lambda t: F.softplus(t), _X),
        "softsign": (lambda t: F.softsign(t), _X),
        "silu": (lambda t: F.silu(t), _X),
        "hardswish": (lambda t: F.hardswish(t), _UNIT),
        "abs": (lambda t: t.abs(), _X),
        "square": (lambda t: t.square(), _X),
        "sin": (lambda t: t.sin(), _X),
        "cos": (lambda t: t.cos(), _X),
        "atan": (lambda t: t.atan(), _X),
        "asin": (lambda t: t.asin(), _UNIT),
        "erf": (lambda t: t.erf(), _X),
        "reciprocal": (lambda t: t.reciprocal(), _POS),
        "pow3": (lambda t: t.pow(3), _X),
        "softmax": (lambda t: F.softmax(t, axis=-1), _X),
        "log_softmax": (lambda t: F.log_softmax(t, axis=-1), _X),
        "mean": (lambda t: t.mean(axis=1), _X),
        "sum_axis": (lambda t: t.sum(axis=0), _X),
        "cumsum": (lambda t: t.cumsum(axis=1), _X),
        "logsumexp": (lambda t: t.logsumexp(axis=1), _X),
        "transpose": (lambda t: t.transpose((1, 0)), _X),
        "reshape": (lambda t: t.reshape((4, 3)), _X),
        "slice": (lambda t: t[1:, :2], _X),
        "flip": (lambda t: t.flip(axis=0), _X),
        "tile": (lambda t: t.tile((2, 1)), _X),
        "squeeze_unsqueeze": (lambda t: t.unsqueeze(0).squeeze(0), _X),
        "clip_interior": (lambda t: t.clip(-5.0, 5.0), _X),
        "pad": (lambda t: F.pad(t, [1, 1, 1, 1]), _IMG),
        "avg_pool2d": (lambda t: F.avg_pool2d(t, 2), _IMG),
        "max_pool2d": (lambda t: F.max_pool2d(t, 2), _IMG),
        "adaptive_avg_pool2d": (lambda t: F.adaptive_avg_pool2d(t, 3),
                                _IMG),
        "interp_nearest": (
            lambda t: F.interpolate(t, size=(12, 12), mode="nearest"), _IMG),
        "interp_bilinear": (
            lambda t: F.interpolate(t, size=(12, 12), mode="bilinear"),
            _IMG),
        "layer_norm_x": (
            lambda t: F.layer_norm(t, (4,), None, None, 1e-5), _X),
        "normalize": (lambda t: F.normalize(t, axis=1), _X),
        "mse_vs_const": (
            lambda t: F.mse_loss(t, t32(np.ones((3, 4))), reduction="none"),
            _X),
        "huber_smooth_l1": (
            lambda t: F.smooth_l1_loss(t, t32(np.zeros((3, 4)))), _X),
        "tanhshrink": (lambda t: F.tanhshrink(t), _X),
        "hardtanh": (lambda t: F.hardtanh(t, -5.0, 5.0), _X),
        "celu": (lambda t: F.celu(t), _X),
        "mish": (lambda t: F.mish(t), _X),
        "log1p": (lambda t: t.log1p(), _POS),
        "expm1": (lambda t: t.expm1(), _X),
        "sinh": (lambda t: t.sinh(), _UNIT),
        "cosh": (lambda t: t.cosh(), _UNIT),
        "tan": (lambda t: t.tan(), _UNIT),
        "acos": (lambda t: t.acos(), _UNIT),
        "prod_axis": (lambda t: t.prod(axis=1), _POS),
        "amax_distinct": (lambda t: t.max(axis=1), _X),
        "roll": (lambda t: t.roll(1, axis=1), _X),
        "index_select": (
            lambda t: P.index_select(
                t, P.to_tensor(np.asarray([2, 0], "int64")), axis=0), _X),
        "broadcast_to": (lambda t: t.unsqueeze(0).expand((2, 3, 4)), _X),
        "kron_like_outer": (
            lambda t: t.reshape((12, 1)).matmul(t.reshape((1, 12))), _X),
        "logcumsumexp_like": (
            lambda t: t.cumsum(axis=1).exp().log(), _UNIT),
        "avg_pool1d": (
            lambda t: F.avg_pool1d(t.reshape((3, 1, 4)), 2), _X),
        "trilinear_interp": (
            lambda t: F.interpolate(t.reshape((1, 1, 3, 2, 2)),
                                    size=(6, 4, 4), mode="trilinear"), _X),
        "group_norm_fn": (
            lambda t: F.group_norm(t.reshape((1, 4, 3, 1)), 2,
                                   epsilon=1e-5), _X),
        "bce_with_logits": (
            lambda t: F.binary_cross_entropy_with_logits(
                t, t32((np.abs(_X) > 1.0))), _X),
        "kl_div_logtarget": (
            lambda t: F.kl_div(F.log_softmax(t, axis=-1),
                               t32(np.full((3, 4), 0.25))), _X),
        "margin_ranking": (
            lambda t: F.margin_ranking_loss(
                t, t32(_POS), t32(np.sign(_X - _POS)), margin=0.1), _X),
        "logsigmoid": (lambda t: F.log_sigmoid(t), _X),
    }


def _multi(P):
    """The reference's multi-input cases (``TestMultiInputGrads``), on
    inputs drawn here."""
    F = P.nn.functional
    t32 = lambda a: P.to_tensor(np.asarray(a, np.float32))  # noqa: E731
    return {
        "matmul_left": (lambda t: t.matmul(t32(_B)), _A, {}),
        "matmul_right": (lambda t: t32(_A).matmul(t), _B, {}),
        "add": (lambda t: t + t32(_POS), _X, {}),
        "sub": (lambda t: t - t32(_POS), _X, {}),
        "mul": (lambda t: t * t32(_POS), _X, {}),
        "div": (lambda t: t / t32(_POS), _X, {}),
        "maximum": (lambda t: t.maximum(t32(_POS)), _X, {}),
        "minimum": (lambda t: t.minimum(t32(_POS)), _X, {}),
        "conv2d_input": (lambda t: F.conv2d(t, t32(_W), padding=1), _IMG,
                         {"rtol": 3e-2, "atol": 5e-3}),
        "conv2d_weight": (lambda t: F.conv2d(t32(_IMG), t, padding=1), _W,
                          {"rtol": 3e-2, "atol": 5e-3}),
        "cross_entropy": (
            lambda t: F.cross_entropy(t, P.to_tensor(_LABELS)), _X, {}),
        "embedding": (
            lambda t: F.embedding(
                P.to_tensor(np.asarray([0, 2, 2, 1], "int64")), t), _EMB,
            {}),
        "gather": (
            lambda t: P.gather(t, P.to_tensor(np.asarray([2, 0], "int64")),
                               axis=0), _X, {}),
        "where_x": (lambda t: P.where(P.to_tensor(_COND), t, t32(_POS)),
                    _X, {}),
        "where_y": (lambda t: P.where(P.to_tensor(_COND), t32(_POS), t),
                    _X, {}),
        "concat": (lambda t: P.concat([t, t32(_POS)], axis=0), _X, {}),
        "split": (lambda t: P.split(t, 2, axis=1)[0], _X, {}),
        "batch_norm_train": (
            lambda t: F.batch_norm(t, t32(np.zeros(3)), t32(np.ones(3)),
                                   t32(np.ones(3)), t32(np.zeros(3)),
                                   training=True),
            _IMG, {"rtol": 3e-2, "atol": 5e-3}),
    }


@pytest.fixture(autouse=True, params=["lazy", "immediate"])
def _both_engines(request):
    """Every check runs through both of the port's eager executors."""
    prev = paddle.get_flags(["FLAGS_lazy_eager"])["FLAGS_lazy_eager"]
    paddle.set_flags({"FLAGS_lazy_eager": request.param == "lazy"})
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    paddle.set_flags({"FLAGS_lazy_eager": prev})
    device_mod._current_place = None
    torch.set_num_threads(before)


def _analytic(P, fn, x_np):
    t = P.to_tensor(x_np.astype("float32"))
    t.stop_gradient = False
    fn(t).sum().backward()
    return np.asarray(t.grad.numpy(), np.float64)


_REF_GRADS = {}


def _ref_grad(key, fn, x_np):
    """The reference's analytic grad of the case (its lazy engine)."""
    if key not in _REF_GRADS:
        _REF_GRADS[key] = _analytic(ref, fn, x_np)
    return _REF_GRADS[key]


def _check(key, fn, ref_fn, x_np, rtol=2e-2, atol=2e-3):
    def scalar(x):
        return float(fn(paddle.to_tensor(x.astype("float32"))).sum()
                     .numpy())

    analytic = _analytic(paddle, fn, x_np)
    numeric = numeric_grad(scalar, x_np.astype(np.float64).copy())
    np.testing.assert_allclose(analytic, numeric, rtol=rtol, atol=atol)
    want = _ref_grad(key, ref_fn, x_np)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(analytic - want).max()) \
        <= REF_TOL * scale + REF_ATOL


@pytest.mark.parametrize("name", sorted(_unary(paddle)))
def test_unary_grad(name):
    fn, x = _unary(paddle)[name]
    _check(name, fn, _unary(ref)[name][0], x)


@pytest.mark.parametrize("name", sorted(_multi(paddle)))
def test_multi_input_grad(name):
    fn, x, tol = _multi(paddle)[name]
    _check(name, fn, _multi(ref)[name][0], x, **tol)
