"""paddle_tpu_torch's eager Tensor against the JAX package's on the CPU:
the scenarios of tests/test_tensor.py (their ``zeros``/``ones`` inputs,
and ``test_methods``' ``reshape``, ``transpose``, ``T``, ``unsqueeze`` and
``flatten`` among them), every elementwise, reduction and logic op of
the core on the same inputs, and the dtype, Place, flag, error and
``enforce`` surfaces.

Forward values are held with f32 ``allclose`` (rtol 1e-6, atol 1e-6:
one op on the same f32 inputs, the libraries' last-bit rounding
differences only); grads of one op likewise at rtol 1e-5.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.core import errors, flags, rng

RTOL = ATOL = 1e-6
GRAD_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _both(fn):
    """``fn(package)`` through the reference and the port."""
    return fn(ref), fn(paddle)


# ------------------------------------------------- tests/test_tensor.py

def test_to_tensor_dtypes():
    for pkg in (ref, paddle):
        assert pkg.to_tensor([1.0, 2.0]).dtype == pkg.float32
        assert pkg.to_tensor([1, 2]).dtype == pkg.int64
        assert pkg.to_tensor(np.zeros((2, 2), np.float64)).dtype \
            == pkg.float64
        assert pkg.to_tensor(3).dtype == pkg.int64
        assert pkg.to_tensor(2.5).dtype == pkg.float32
        assert pkg.to_tensor(True).dtype == pkg.bool


def test_shape_numel_ndim():
    for pkg in (ref, paddle):
        t = pkg.zeros([2, 3, 4])
        assert t.shape == [2, 3, 4]
        assert t.ndim == 3 and t.dim() == 3
        assert t.numel() == 24 and t.size == 24
        assert len(t) == 2


def test_numpy_roundtrip():
    arr = np.random.RandomState(0).randn(3, 4).astype("float32")
    for pkg in (ref, paddle):
        np.testing.assert_array_equal(pkg.to_tensor(arr).numpy(), arr)


def test_operators():
    def run(pkg):
        a = pkg.to_tensor([1.0, 2.0, 3.0])
        b = pkg.to_tensor([4.0, 5.0, 6.0])
        i = pkg.to_tensor([7, -7, 9])
        outs = [a + b, a - b, a * b, b / a, a ** 2, -a, a + 1, 2 * a,
                1 - a, 2 / a, a ** 0.5, 2 ** a, abs(-a), a @ b, i // 2,
                i % 4, i / 2, i + 1.5, a % 2.0]
        assert (a + 1).dtype == pkg.float32   # a scalar keeps the dtype
        assert (i / 2).dtype == pkg.float32   # "/" is true division
        return [(o.numpy(), o.dtype.name) for o in outs]
    want, got = _both(run)
    for (w, wd), (g, gd) in zip(want, got):
        assert wd == gd
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_comparisons():
    def run(pkg):
        a = pkg.to_tensor([1.0, 2.0, 3.0])
        b = pkg.to_tensor([3.0, 2.0, 1.0])
        t = pkg.to_tensor([True, False, True])
        u = pkg.to_tensor([True, True, False])
        return [o.numpy().tolist() for o in (
            a < b, a == b, a != b, a <= b, a > b, a >= b, a == 2.0,
            ~t, t & u, t | u, t ^ u)]
    want, got = _both(run)
    assert got == want
    assert got[0] == [True, False, False]


def test_matmul_operator():
    b_np = np.random.RandomState(1).randn(3, 3).astype("float32")
    for pkg in (ref, paddle):
        a = pkg.to_tensor(np.eye(3, dtype="float32"))
        b = pkg.to_tensor(b_np)
        np.testing.assert_allclose((a @ b).numpy(), b_np)


def test_indexing():
    base = np.arange(24).reshape(2, 3, 4).astype("float32")

    def run(pkg):
        t = pkg.to_tensor(base)
        idx = pkg.to_tensor(np.array([1, 0]))
        mask = pkg.to_tensor(base > 10)
        return [o.numpy() for o in (
            t[0], t[:, 1], t[0, 1, 2], t[..., -1], t[idx], t[None, 1],
            t[:, ::2], t[[1, 0], 1], t[mask], t[1, 1:, None])]
    want, got = _both(run)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], base[0])
    np.testing.assert_array_equal(got[4], base[[1, 0]])


def test_setitem_inplace():
    def run(pkg):
        t = pkg.zeros([3, 3])
        t[1] = 5.0
        t[0, 0] = -1.0
        t[2, 1:] = pkg.to_tensor([7.0, 8.0])
        t[:, 0] = np.array([1.0, 2.0, 3.0], np.float32)
        return t.numpy()
    want, got = _both(run)
    np.testing.assert_array_equal(got, want)
    assert got[1].tolist() == [2, 5, 5] and got[0, 0] == 1


def test_setitem_keeps_a_parameters_identity_and_grad():
    w = paddle.Parameter(np.ones(3, np.float32))
    (w * 2).sum().backward()
    w[0] = 9.0
    assert not w.stop_gradient and w.is_leaf
    np.testing.assert_array_equal(w.numpy(), [9, 1, 1])
    np.testing.assert_array_equal(w.grad.numpy(), [2, 2, 2])


def test_set_value_and_item():
    for pkg in (ref, paddle):
        t = pkg.zeros([2, 2])
        t.set_value(np.ones((2, 2), np.float32))
        assert t.numpy().sum() == 4
        s = pkg.to_tensor(3.5)
        assert s.item() == pytest.approx(3.5)
        assert float(s) == pytest.approx(3.5)
        assert int(pkg.to_tensor(7)) == 7
        with pytest.raises(pkg.errors.InvalidArgumentError):
            t.set_value(np.ones((3,), np.float32))


def test_astype_cast():
    def run(pkg):
        t = pkg.to_tensor([1.5, 2.5, -1.5])
        i = t.astype("int32")
        b = pkg.cast(t, "bfloat16")
        c = t.cast(pkg.float64)
        return (i.dtype.name, i.numpy().tolist(), b.dtype.name,
                np.asarray(b.numpy(), np.float32).tolist(), c.dtype.name)
    want, got = _both(run)
    assert got == want
    assert got[:3] == ("int32", [1, 2, -1], "bfloat16")


def test_detach_clone():
    for pkg in (ref, paddle):
        t = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
        d = t.detach()
        assert d.stop_gradient and not t.stop_gradient
        c = t.clone()
        np.testing.assert_array_equal(c.numpy(), t.numpy())
        assert not c.stop_gradient          # clone is differentiable


def test_methods():
    """test_tensor.py::test_methods: its reductions, and its reshape,
    transpose, T, unsqueeze and flatten (shapes and values)."""
    x = np.random.RandomState(2).randn(2, 8).astype("float32")

    def run(pkg):
        t = pkg.to_tensor(x)
        assert t.sum().shape == []
        assert t.mean(axis=1).shape == [2]
        assert t.reshape([4, 4]).shape == [4, 4]
        assert t.transpose([1, 0]).shape == [8, 2]
        assert t.T.shape == [8, 2]
        assert t.unsqueeze(0).shape == [1, 2, 8]
        assert t.flatten().shape == [16]
        assert t.max().numpy() == x.max()
        return [o.numpy() for o in (
            t.sum(), t.mean(axis=1), t.max(), t.min(axis=0, keepdim=True),
            t.prod(axis=1), t.std(), t.var(axis=1, unbiased=False),
            t.logsumexp(axis=1), t.norm(), t.abs().sqrt(), t.exp().log(),
            t.reshape([4, 4]), t.transpose([1, 0]), t.T, t.unsqueeze(0),
            t.flatten())]
    want, got = _both(run)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_manipulation_and_search_methods():
    """The ops of the nn slice as Tensor methods (reference
    ops/__init__.py's patch), on the same input in both packages."""
    x = np.random.RandomState(4).randn(3, 4).astype("float32")

    def run(pkg):
        t = pkg.to_tensor(x)
        i = pkg.to_tensor(np.array([2, 0], np.int64))
        outs = [t.reshape([4, 3]), t.transpose([1, 0]), t.t(),
                t.flatten(), t.unsqueeze(1), t.unsqueeze(0).squeeze(0),
                t.tile([2, 1]), t.flip([1]), t.roll(1, axis=0),
                t.gather(i), t.index_select(i, axis=1), t.argmax(axis=1),
                t.argmin(), t.argsort(axis=0), t.sort(axis=1),
                t.topk(2)[0], t.topk(2)[1], t.kthvalue(2)[0],
                t.split(2, axis=1)[1], t.chunk(3)[2], t.unbind(1)[3],
                t.softmax(),
                t.tril(), t.triu(1), t.zeros_like(), t.full_like(2.0),
                t.expand([2, 3, 4]), t.moveaxis(0, 1),
                t.masked_fill(t > 0, 0.0), t.rank()]
        return [o.numpy() for o in outs]
    want, got = _both(run)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_repr_does_not_crash():
    assert "Tensor" in repr(paddle.ones([2]))
    assert "Parameter" in repr(paddle.Parameter(np.ones(2, np.float32)))
    assert "bfloat16" in repr(paddle.to_tensor([1.0]).astype("bfloat16"))


def test_tensor_iteration_protocol():
    for pkg in (ref, paddle):
        t = pkg.to_tensor(np.asarray([[1.0, 2.0], [3.0, 4.0]], "float32"))
        assert [r.numpy().tolist() for r in t] == [[1.0, 2.0], [3.0, 4.0]]
        assert len(t) == 2
        assert t.element_size() == 4
        assert t.ndimension() == 2
        s = pkg.to_tensor(np.asarray(1.0, "float32"))
        with pytest.raises(TypeError):
            iter(s)
        with pytest.raises(TypeError):
            len(s)


def test_parameter_and_stop_gradient_defaults():
    for pkg in (ref, paddle):
        t = pkg.to_tensor([1.0])
        p = pkg.Parameter(np.ones(2, np.float32))
        assert t.stop_gradient and not t.persistable
        assert not p.stop_gradient and p.persistable and p.trainable
        assert p.name.startswith("param_")
        frozen = pkg.Parameter(np.ones(2, np.float32), trainable=False)
        assert frozen.stop_gradient
        assert (t + p).stop_gradient is False
        assert (t + t).stop_gradient is True
    with pytest.raises(TypeError):
        paddle.to_tensor([1, 2]).stop_gradient = False   # ints take none


# ------------------------------------------------- every op of the core

_RS = np.random.RandomState(3)
_A = _RS.uniform(0.2, 0.9, (3, 4)).astype("float32")
_B = _RS.uniform(0.2, 0.9, (3, 4)).astype("float32")
_S = _RS.randn(3, 4).astype("float32")
_M = _RS.randn(4, 5).astype("float32")
_I = _RS.randint(-9, 9, (3, 4)).astype("int64")
_J = _RS.randint(1, 5, (3, 4)).astype("int64")
_V3 = _RS.randn(2, 3).astype("float32")

# (name, call(pkg, *tensors), inputs, differentiable)
_OPS = [
    ("add", lambda p, a, b: p.add(a, b), (_S, _B), True),
    ("subtract", lambda p, a, b: p.subtract(a, b), (_S, _B), True),
    ("multiply", lambda p, a, b: p.multiply(a, b), (_S, _B), True),
    ("divide", lambda p, a, b: p.divide(a, b), (_S, _B), True),
    ("divide_int", lambda p, a, b: p.divide(a, b), (_I, _J), False),
    ("floor_divide", lambda p, a, b: p.floor_divide(a, b), (_I, _J), False),
    ("remainder", lambda p, a, b: p.remainder(a, b), (_I, _J), False),
    ("maximum", lambda p, a, b: p.maximum(a, b), (_S, _B), True),
    ("minimum", lambda p, a, b: p.minimum(a, b), (_S, _B), True),
    ("fmax", lambda p, a, b: p.fmax(a, b), (_S, _B), True),
    ("pow", lambda p, a, b: p.pow(a, b), (_A, _B), True),
    ("pow_int", lambda p, a: p.pow(a, 3), (_S,), True),
    ("pow_neg", lambda p, a: p.pow(a, -2), (_A,), True),
    ("pow_float", lambda p, a: p.pow(a, 0.5), (_A,), True),
    ("atan2", lambda p, a, b: p.atan2(a, b), (_S, _B), True),
    ("hypot", lambda p, a, b: p.hypot(a, b), (_S, _B), True),
    ("logaddexp", lambda p, a, b: p.logaddexp(a, b), (_S, _B), True),
    ("heaviside", lambda p, a, b: p.heaviside(a, b), (_S, _B), False),
    ("kron", lambda p, a, b: p.kron(a, b), (_V3, _V3), True),
    ("outer", lambda p, a, b: p.outer(a[0], b[1]), (_S, _B), True),
    ("inner", lambda p, a, b: p.inner(a, b), (_S, _B), True),
    ("abs", lambda p, a: p.abs(a), (_S,), True),
    ("neg", lambda p, a: p.neg(a), (_S,), True),
    ("exp", lambda p, a: p.exp(a), (_S,), True),
    ("expm1", lambda p, a: p.expm1(a), (_S,), True),
    ("log", lambda p, a: p.log(a), (_A,), True),
    ("log2", lambda p, a: p.log2(a), (_A,), True),
    ("log10", lambda p, a: p.log10(a), (_A,), True),
    ("log1p", lambda p, a: p.log1p(a), (_A,), True),
    ("sqrt", lambda p, a: p.sqrt(a), (_A,), True),
    ("rsqrt", lambda p, a: p.rsqrt(a), (_A,), True),
    ("square", lambda p, a: p.square(a), (_S,), True),
    ("sin", lambda p, a: p.sin(a), (_S,), True),
    ("cos", lambda p, a: p.cos(a), (_S,), True),
    ("tan", lambda p, a: p.tan(a), (_A,), True),
    ("asin", lambda p, a: p.asin(a), (_A,), True),
    ("acos", lambda p, a: p.acos(a), (_A,), True),
    ("atan", lambda p, a: p.atan(a), (_S,), True),
    ("sinh", lambda p, a: p.sinh(a), (_S,), True),
    ("cosh", lambda p, a: p.cosh(a), (_S,), True),
    ("tanh", lambda p, a: p.tanh(a), (_S,), True),
    ("asinh", lambda p, a: p.asinh(a), (_S,), True),
    ("acosh", lambda p, a: p.acosh(a + 1.5), (_A,), True),
    ("atanh", lambda p, a: p.atanh(a), (_A,), True),
    ("floor", lambda p, a: p.floor(a), (_S,), False),
    ("ceil", lambda p, a: p.ceil(a), (_S,), False),
    ("round", lambda p, a: p.round(a * 4), (_S,), False),
    ("round_half", lambda p, a: p.round(a),
     (np.array([0.5, 1.5, 2.5, -0.5, -2.5, 0.49], "float32"),), False),
    ("trunc", lambda p, a: p.trunc(a), (_S,), False),
    ("frac", lambda p, a: p.frac(a * 3), (_S,), True),
    ("sign", lambda p, a: p.sign(a), (_S,), False),
    ("reciprocal", lambda p, a: p.reciprocal(a), (_A,), True),
    ("erf", lambda p, a: p.erf(a), (_S,), True),
    ("erfinv", lambda p, a: p.erfinv(a * 0.9), (_A,), True),
    ("lgamma", lambda p, a: p.lgamma(a), (_A,), True),
    ("digamma", lambda p, a: p.digamma(a), (_A,), True),
    ("sigmoid", lambda p, a: p.sigmoid(a), (_S,), True),
    ("i0", lambda p, a: p.i0(a), (_S,), False),
    ("deg2rad", lambda p, a: p.deg2rad(a), (_S,), True),
    ("rad2deg", lambda p, a: p.rad2deg(a), (_S,), True),
    ("logit", lambda p, a: p.logit(a), (_A,), True),
    ("nan_to_num", lambda p, a: p.nan_to_num(p.log(a - 0.5)), (_A,), False),
    ("isnan", lambda p, a: p.isnan(p.log(a - 0.5)), (_A,), False),
    ("isinf", lambda p, a: p.isinf(p.log(a - 0.5)), (_A,), False),
    ("isfinite", lambda p, a: p.isfinite(p.log(a - 0.5)), (_A,), False),
    ("clone", lambda p, a: p.clone(a), (_S,), True),
    ("cast", lambda p, a: p.cast(a, "float64"), (_S,), True),
    ("scale", lambda p, a: p.scale(a, 2.0, 0.5), (_S,), True),
    ("scale_before", lambda p, a: p.scale(a, 2.0, 0.5, False), (_S,), True),
    ("scale_act", lambda p, a: p.scale(a, 2.0, act="tanh"), (_S,), True),
    ("clip", lambda p, a: p.clip(a, -0.5, 0.7), (_S,), True),
    ("clip_min", lambda p, a: p.clip(a, min=0.1), (_S,), True),
    ("lerp", lambda p, a, b: p.lerp(a, b, 0.3), (_S, _B), True),
    ("matmul", lambda p, a, m: p.matmul(a, m), (_S, _M), True),
    ("matmul_t", lambda p, a, b: p.matmul(a, b, transpose_y=True),
     (_S, _B), True),
    ("bmm", lambda p, a, b: p.bmm(a[None], b[None]), (_S, _M), True),
    ("dot", lambda p, a, b: p.dot(a, b), (_S, _B), True),
    ("mv", lambda p, m, v: p.mv(m, v[:, 0]), (_S, _M), True),
    ("addmm", lambda p, a, m, c: p.addmm(c, a, m, 0.5, 2.0),
     (_S, _M, _M[:3]), True),
    ("cumsum", lambda p, a: p.cumsum(a, axis=1), (_S,), True),
    ("cumsum_flat", lambda p, a: p.cumsum(a), (_S,), True),
    ("cumprod", lambda p, a: p.cumprod(a, dim=0), (_S,), True),
    ("stanh", lambda p, a: p.stanh(a), (_S,), True),
    ("einsum", lambda p, a, m: p.einsum("ij,jk->ik", a, m), (_S, _M), True),
    ("trace", lambda p, a: p.trace(a, offset=1), (_S,), True),
    ("diff", lambda p, a: p.diff(a, axis=1), (_S,), True),
    ("add_n", lambda p, a, b: p.add_n([a, b, a]), (_S, _B), True),
    ("cross", lambda p, a, b: p.cross(a, b), (_V3, _V3[::-1].copy()), True),
    ("histogram", lambda p, a: p.histogram(a, bins=5), (_S,), False),
    ("histogram_range", lambda p, a: p.histogram(a, 4, -1, 1), (_S,), False),
    ("renorm", lambda p, a: p.renorm(a, 2.0, 0, 1.0), (_S,), True),
    ("vander", lambda p, a: p.vander(a[0], 3), (_S,), False),
    ("logcumsumexp", lambda p, a: p.logcumsumexp(a, axis=0), (_S,), True),
    ("trapezoid", lambda p, a: p.trapezoid(a, dx=0.5), (_S,), True),
    ("cumulative_trapezoid", lambda p, a: p.cumulative_trapezoid(a, axis=0),
     (_S,), True),
    ("polygamma", lambda p, a: p.polygamma(a, 1), (_A,), False),
    ("igamma", lambda p, a, b: p.igamma(a, b), (_A, _B), False),
    ("sum", lambda p, a: p.sum(a), (_S,), True),
    ("sum_axis", lambda p, a: p.sum(a, axis=[0, 1], keepdim=True), (_S,),
     True),
    ("sum_int", lambda p, a: p.sum(a, axis=1), (_I,), False),
    ("mean", lambda p, a: p.mean(a, axis=0), (_S,), True),
    ("max", lambda p, a: p.max(a, axis=1), (_S,), True),
    ("min", lambda p, a: p.min(a), (_S,), True),
    ("prod", lambda p, a: p.prod(a, axis=1), (_S,), True),
    ("prod_all", lambda p, a: p.prod(a), (_A,), True),
    ("all", lambda p, a: p.all(a > 0, axis=1), (_S,), False),
    ("any", lambda p, a: p.any(a > 1), (_S,), False),
    ("std", lambda p, a: p.std(a, axis=1), (_S,), True),
    ("var", lambda p, a: p.var(a, unbiased=False), (_S,), True),
    ("median", lambda p, a: p.median(a, axis=1), (_S,), True),
    ("median_all", lambda p, a: p.median(a), (_S,), True),
    ("quantile", lambda p, a: p.quantile(a, 0.3, axis=0), (_S,), True),
    ("quantile_keep", lambda p, a: p.quantile(a, 0.7, axis=1, keepdim=True),
     (_S,), True),
    ("logsumexp", lambda p, a: p.logsumexp(a, axis=1), (_S,), True),
    ("count_nonzero", lambda p, a: p.count_nonzero(a, axis=0), (_I,), False),
    ("norm_fro", lambda p, a: p.norm(a), (_S,), True),
    ("norm_p", lambda p, a: p.norm(a, p=3, axis=1), (_S,), True),
    ("norm_inf", lambda p, a: p.norm(a, p=float("inf"), axis=0), (_S,), True),
    ("dist", lambda p, a, b: p.dist(a, b, p=1.0), (_S, _B), True),
    ("nansum", lambda p, a: p.nansum(p.log(a - 0.5), axis=1), (_A,), False),
    ("nanmean", lambda p, a: p.nanmean(p.log(a - 0.5)), (_A,), False),
    ("nanmedian", lambda p, a: p.nanmedian(p.log(a - 0.5), axis=1), (_A,),
     False),
    ("nanquantile", lambda p, a: p.nanquantile(p.log(a - 0.5), 0.4),
     (_A,), False),
    ("isclose", lambda p, a, b: p.isclose(a, a + b * 1e-7), (_S, _B), False),
    ("allclose", lambda p, a, b: p.allclose(a, b), (_S, _B), False),
    ("equal_all", lambda p, a: p.equal_all(a, a), (_S,), False),
    ("bitwise", lambda p, a, b: p.bitwise_xor(p.bitwise_and(a, b),
                                              p.bitwise_not(a)),
     (_I, _J), False),
]


def _run_op(pkg, call, inputs, grad):
    ts = [pkg.to_tensor(x, stop_gradient=not (grad and x.dtype.kind == "f"))
          for x in inputs]
    out = call(pkg, *ts)
    res = {"out": out.numpy(), "dtype": out.dtype.name}
    if grad:
        out.sum().backward() if out.ndim else out.backward()
        res["grads"] = [t.grad.numpy() if t.grad is not None else None
                        for t in ts]
    return res


@pytest.mark.parametrize("name,call,inputs,grad", _OPS,
                         ids=[o[0] for o in _OPS])
def test_op_matches_the_reference(name, call, inputs, grad):
    """Each op of the core on the same inputs as the reference's: the
    same dtype and values and, for a differentiable one, the same grads
    of its sum."""
    want = _run_op(ref, call, inputs, grad)
    got = _run_op(paddle, call, inputs, grad)
    assert got["dtype"] == want["dtype"]
    np.testing.assert_allclose(got["out"], want["out"], rtol=RTOL * 10,
                               atol=ATOL, equal_nan=True)
    if grad:
        for g, w in zip(got["grads"], want["grads"]):
            if w is None:
                assert g is None
            else:
                np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=1e-6)


def test_methods_and_inplace_variants():
    x = np.random.RandomState(4).uniform(0.5, 2.0, (2, 3)).astype("float32")

    def run(pkg):
        t = pkg.to_tensor(x)
        outs = [t.exp(), t.log(), t.sqrt(), t.clip(0.6, 1.5), t.scale(3.0),
                t.tanh(), t.maximum(t * 0.5), t.cumsum(1), t.logsumexp(),
                t.equal(t), t.isfinite(), t.matmul(t, transpose_y=True)]
        u = pkg.to_tensor(x.copy())
        u.add_(t)
        u.scale_(0.5)
        u.sqrt_()
        u.clip_(max=1.2)
        return [o.numpy() for o in outs] + [u.numpy()]
    want, got = _both(run)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-6)


# -------------------------------------- dtypes, Places, flags, errors

def test_dtype_surface():
    from paddle_tpu.core import dtype as rdt
    from paddle_tpu_torch.core import dtype as tdt
    names = [d.name for d in rdt._ALL]
    assert names == [d.name for d in tdt._ALL]
    for alias in list(rdt._ALIASES) + names:
        assert tdt.to_paddle_dtype(alias).name \
            == rdt.to_paddle_dtype(alias).name
    assert tdt.to_torch_dtype("bf16") is torch.bfloat16
    assert tdt.to_paddle_dtype(torch.int32) == paddle.int32
    assert tdt.to_paddle_dtype(np.float16) == "float16"
    assert paddle.float32 == "float32" and paddle.float32 != paddle.float64
    assert paddle.bfloat16.is_floating and paddle.int8.is_integer
    assert paddle.complex64.is_complex and not paddle.bool.is_floating
    with pytest.raises(ValueError):
        tdt.to_paddle_dtype("float8")
    assert paddle.get_default_dtype() == ref.get_default_dtype() \
        == "float32"
    try:
        paddle.set_default_dtype("float64")
        assert paddle.get_default_dtype() == "float64"
        with pytest.raises(TypeError):
            paddle.set_default_dtype("int32")
    finally:
        paddle.set_default_dtype("float32")


def test_place_surface_and_set_device():
    try:
        assert paddle.set_device("cpu") == paddle.CPUPlace()
        assert paddle.get_device() == "cpu"
        assert repr(paddle.get_place()) == repr(ref.CPUPlace()) \
            == "Place(cpu)"
        t = paddle.to_tensor([1.0])
        assert t.place == paddle.CPUPlace() and t.place.is_cpu_place()
        assert t.value.device.type == "cpu"
        assert repr(paddle.CUDAPlace(1)) == "Place(gpu:1)"
        assert paddle.CUDAPlace(0).torch_device() == torch.device("cuda", 0)
        assert paddle.CUDAPinnedPlace().is_cuda_pinned_place()
        assert paddle.is_compiled_with_cuda() == (torch.version.cuda
                                                  is not None)
        assert not paddle.is_compiled_with_tpu()
        assert not paddle.is_compiled_with_rocm()
        with pytest.raises(ValueError):
            paddle.set_device("quantum")
        # the card's name, as the reference's accelerator's
        assert paddle.set_device("gpu:0") == paddle.CUDAPlace(0)
        assert paddle.get_device() == "gpu:0"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                paddle.to_tensor([1.0])
            with pytest.raises(RuntimeError, match="CUDA"):
                paddle.resolve_device()
    finally:
        paddle.set_device("cpu")
    assert paddle.device_count() == (torch.cuda.device_count()
                                     if torch.cuda.is_available() else 0)


def test_default_generator_follows_set_device():
    """``default_generator()`` is the current device's (the card's
    unless set_device says otherwise), and ``seed()`` reseeds every one
    made so far; on a host without CUDA neither makes a CUDA one."""
    try:
        paddle.set_device("cpu")
        g = paddle.default_generator()
        assert g is rng.default_generator("cpu")
        assert g.device == torch.device("cpu")
        paddle.seed(5)
        a = torch.rand(3, generator=paddle.default_generator())
        paddle.seed(5)
        assert torch.equal(a, torch.rand(3, generator=g))
        if not torch.cuda.is_available():
            device_mod._current_place = None     # the card, which is absent
            with pytest.raises(RuntimeError, match="CUDA"):
                paddle.default_generator()
            paddle.seed(1)
            assert all(d.type == "cpu" for d in rng._generators)
    finally:
        paddle.set_device("cpu")


def test_flags_surface():
    from paddle_tpu.core import flags as rflags
    assert set(flags._DEFAULTS) == set(rflags._DEFAULTS)
    for k, v in rflags._DEFAULTS.items():
        if k != "FLAGS_compilation_cache_dir":
            assert flags._DEFAULTS[k] == v, k
    try:
        paddle.set_flags({"FLAGS_check_nan_inf": "1",
                          "FLAGS_fuse_parameter_memory_size": 8})
        assert paddle.get_flags(["FLAGS_check_nan_inf",
                                 "FLAGS_fuse_parameter_memory_size"]) == {
            "FLAGS_check_nan_inf": True,
            "FLAGS_fuse_parameter_memory_size": 8.0}
        x = paddle.to_tensor([0.0, 1.0])
        with pytest.raises(FloatingPointError, match="log"):
            paddle.log(x)
        paddle.set_flags({"FLAGS_check_nan_inf": False})
        assert bool(paddle.isinf(paddle.log(x))[0])
        assert paddle.get_flags("FLAGS_lazy_eager") == {
            "FLAGS_lazy_eager": True}
    finally:
        flags._flags.clear()


def test_error_classes_and_enforce():
    from paddle_tpu.core import errors as rerr
    names = [c.__name__ for c in rerr._ALL]
    assert names == [c.__name__ for c in errors._ALL]
    for rc, tc in zip(rerr._ALL, errors._ALL):
        assert rc.code == tc.code
        assert [b.__name__ for b in rc.__mro__[1:]] \
            == [b.__name__ for b in tc.__mro__[1:]]
        assert errors.error_for_code(tc.code) is tc
    assert errors.error_for_code("NOPE") is errors.FatalError
    with pytest.raises(ValueError):          # natural builtin too
        errors.enforce(False, "bad")
    cases = [(errors.enforce_eq, 1, 2), (errors.enforce_ne, 1, 1),
             (errors.enforce_gt, 1, 1), (errors.enforce_ge, 0, 1),
             (errors.enforce_lt, 1, 1), (errors.enforce_le, 2, 1)]
    for fn, a, b in cases:
        with pytest.raises(errors.InvalidArgumentError):
            fn(a, b)
        getattr(rerr, fn.__name__)   # the reference has the same helper
    for fn, a, b in [(errors.enforce_eq, 1, 1), (errors.enforce_gt, 2, 1)]:
        fn(a, b)
    with pytest.raises(errors.NotFoundError):
        errors.enforce_not_none(None)
    assert errors.enforce_not_none(3) == 3
    with pytest.raises(errors.UnavailableError):
        errors.enforce(False, "x", exc=errors.UnavailableError)
    assert paddle.errors is errors


def test_grad_mode_is_per_thread():
    """no_grad on one thread leaves another's recording on, as the
    reference's thread-local flag does."""
    seen = {}
    inside, release = threading.Event(), threading.Event()

    def other():
        inside.wait(5)
        x = paddle.to_tensor([1.0], stop_gradient=False)
        seen["other"] = (x * 2).stop_gradient
        release.set()

    t = threading.Thread(target=other)
    t.start()
    with paddle.no_grad():
        assert not paddle.is_grad_enabled()
        inside.set()
        release.wait(5)
        x = paddle.to_tensor([1.0], stop_gradient=False)
        seen["main"] = (x * 2).stop_gradient
    t.join(5)
    assert seen == {"other": False, "main": True}
    assert paddle.is_grad_enabled()


def test_amp_casts_at_dispatch():
    """Under auto_cast O1 the white-list matmul runs in bf16 and the
    black-list exp stays f32, in both packages."""
    x = np.random.RandomState(5).randn(4, 4).astype("float32")

    def run(pkg):
        t = pkg.to_tensor(x)
        with pkg.amp.auto_cast(level="O1", dtype="bfloat16"):
            mm = pkg.matmul(t, t)
            e = pkg.exp(t)
            s = t + t
        return mm.dtype.name, e.dtype.name, s.dtype.name
    want, got = _both(run)
    assert got == want == ("bfloat16", "float32", "float32")


def test_register_op_contract():
    from paddle_tpu_torch.core.dispatch import get_op, register_op

    @register_op("test_torch_tensor_twice")
    def _twice(x, *, k):
        return x * k, x + k

    assert get_op("test_torch_tensor_twice") is _twice
    a, b = _twice(paddle.to_tensor([1.0, 2.0]), k=3.0)
    assert a.numpy().tolist() == [3.0, 6.0] and b.numpy().tolist() == [4, 5]
    assert "test_torch_tensor_twice" in repr(_twice)
