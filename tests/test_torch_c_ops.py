"""``paddle_tpu_torch._C_ops`` against the ops it names and against the
reference's ``paddle_tpu._C_ops`` (tests/test_c_ops_and_flags.py's
convention): the alternating ``'attr', value`` calls of ``matmul_v2``,
``softmax`` and ``concat`` (with the generated spellings ``trans_x`` /
``trans_y`` and the defaults of calls that leave attributes out) equal
the registry op's calls and the reference's values, under lazy eager
and immediate; a required attribute left out raises ``TypeError``; an
unknown op ``AttributeError``; the wrapper is cached in the module and
``dir()`` lists the registry."""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch import _C_ops
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.core import dispatch, lazy

_rs = np.random.RandomState(0)
A = _rs.randn(3, 4).astype(np.float32)
B = _rs.randn(4, 5).astype(np.float32)
BT = _rs.randn(5, 4).astype(np.float32)


@pytest.fixture(autouse=True, params=["lazy", "immediate"])
def _engine(request):
    prev = paddle.get_flags(["FLAGS_lazy_eager"])["FLAGS_lazy_eager"]
    paddle.set_flags({"FLAGS_lazy_eager": request.param == "lazy"})
    paddle.set_device("cpu")
    yield request.param
    paddle.set_flags({"FLAGS_lazy_eager": prev})
    device_mod._current_place = None


def _both(fn):
    got = fn(paddle, _C_ops)
    want = fn(ref, ref._C_ops)
    return np.asarray(got.numpy()), np.asarray(want.numpy())


def test_matmul_v2_attribute_pairs(_engine):
    x, y, yt = (paddle.to_tensor(a) for a in (A, B, BT))
    out = _C_ops.matmul_v2(x, y, "trans_x", False, "trans_y", False)
    assert isinstance(out._v, lazy.LazyArray) == (_engine == "lazy")
    np.testing.assert_array_equal(
        out.numpy(), paddle.matmul(x, y).numpy())
    np.testing.assert_array_equal(
        _C_ops.matmul_v2(x, yt, "trans_y", True).numpy(),
        paddle.matmul(x, yt, transpose_y=True).numpy())
    np.testing.assert_array_equal(
        _C_ops.matmul_v2(x, y).numpy(), out.numpy())
    got, want = _both(lambda P, C: C.matmul_v2(
        P.to_tensor(A), P.to_tensor(BT), "trans_x", False, "trans_y", True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_softmax_attribute_pairs():
    x = paddle.to_tensor(A)
    np.testing.assert_array_equal(
        _C_ops.softmax(x, "axis", 0).numpy(),
        paddle.nn.functional.softmax(x, axis=0).numpy())
    np.testing.assert_array_equal(
        _C_ops.softmax(x).numpy(),
        paddle.nn.functional.softmax(x, axis=-1).numpy())
    got, want = _both(lambda P, C: C.softmax(P.to_tensor(A), "axis", 0))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_concat_attribute_pairs():
    x, y = paddle.to_tensor(A), paddle.to_tensor(A * 2)
    np.testing.assert_array_equal(
        _C_ops.concat(x, y, "axis", 1).numpy(),
        paddle.concat([x, y], axis=1).numpy())
    got, want = _both(lambda P, C: C.concat(
        P.to_tensor(A), P.to_tensor(A * 2), "axis", 1))
    np.testing.assert_array_equal(got, want)


def test_missing_attribute_and_unknown_op():
    x = paddle.to_tensor(A)
    required = [n for n, op in dispatch._REGISTRY.items()
                if n not in _C_ops._DEFAULTS and n == "transpose2"]
    assert required, "transpose2 takes a required attribute"
    with pytest.raises(TypeError, match="requires attrs"):
        _C_ops.transpose2(x)
    with pytest.raises(AttributeError, match="no registered op"):
        _C_ops.definitely_not_an_op


def test_wrapper_cached_and_listed():
    f = _C_ops.softmax
    assert _C_ops.__dict__["softmax"] is f and f.op is dispatch._REGISTRY[
        "softmax"]
    names = dir(_C_ops)
    assert {"matmul_v2", "softmax", "concat"} <= set(names)
    assert names == sorted(dispatch._REGISTRY)
