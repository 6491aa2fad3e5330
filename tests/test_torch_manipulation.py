"""paddle_tpu_torch's manipulation and search ops against the JAX
package's on the CPU: every op of ``ops/manipulation.py`` (but
``unfold``) and ``ops/search.py`` on the same numpy inputs from a seeded
``RandomState``, Paddle's conventions among them (``reshape``'s 0,
``split``'s -1 section, ``squeeze`` on a non-1 axis, int64 indices,
stable ``sort``/``argsort`` on ties, ``where`` with one argument), the
reference scenarios of tests/test_ops.py's ``TestManipulation`` and
``TestSearch`` and of tests/test_op_grads_sweep.py's
``test_gather_and_index``, ``test_where_both_branches`` and
``test_concat_split``, and the in-place variants.

Forward values are held with f32 ``allclose`` (rtol 1e-6, atol 1e-6)
and the same dtype; the grads of a case (the sum of its float outputs
against a fixed cotangent) at rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod

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


_rs = np.random.RandomState(0)
X = _rs.randn(2, 3, 4).astype(np.float32)
M = _rs.randn(4, 5).astype(np.float32)
V = _rs.randn(6).astype(np.float32)
SQ = _rs.randn(1, 3, 1).astype(np.float32)
IMG = _rs.randn(1, 2, 3, 4).astype(np.float32)
TIES = np.array([[1.0, 3.0, 1.0, 2.0, 3.0], [0.5, 0.5, 0.5, -1.0, 2.0]],
                np.float32)
IDX = np.array([2, 0, 3], np.int64)
COND = _rs.rand(4, 5) < 0.5
INTS = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], np.int64)


def _i64(*a):
    return np.array(a, np.int64)


# name -> (fn(P, *tensors), inputs, indices of the inputs to differentiate)
CASES = {
    # reshape with Paddle's 0 ("copy this input dim") and -1
    "reshape": (lambda P, x: P.reshape(x, [4, 6]), [X], [0]),
    "reshape_zero": (lambda P, x: P.reshape(x, [0, -1]), [X], [0]),
    "reshape_zero_mid": (lambda P, x: P.reshape(x, [0, 0, 2, 2]), [X], [0]),
    "reshape_method": (lambda P, x: x.reshape((3, 8)), [X], [0]),
    "transpose": (lambda P, x: P.transpose(x, [2, 0, 1]), [X], [0]),
    "t": (lambda P, m: P.t(m), [M], [0]),
    "T": (lambda P, m: m.T, [M], [0]),
    "flatten": (lambda P, x: P.flatten(x), [X], [0]),
    "flatten_range": (lambda P, x: P.flatten(x, 1, 2), [X], [0]),
    "squeeze_all": (lambda P, s: P.squeeze(s), [SQ], [0]),
    "squeeze_axis": (lambda P, s: P.squeeze(s, axis=0), [SQ], [0]),
    "squeeze_non1_noop": (lambda P, s: P.squeeze(s, axis=[1, 2]), [SQ], [0]),
    "unsqueeze": (lambda P, s: P.unsqueeze(s, [0, 4]), [SQ], [0]),
    "unsqueeze_neg": (lambda P, x: P.unsqueeze(x, -1), [X], [0]),
    "concat": (lambda P, x, y: P.concat([x, y], axis=1), [X, X * 2], [0, 1]),
    "concat_split": (lambda P, m, n: P.split(P.concat([m, n], axis=0), 2,
                                             axis=1)[0],
                     [M[:, :4], M[:, 1:]], [0, 1]),
    "stack": (lambda P, x, y: P.stack([x, y]), [X, X + 1], [0, 1]),
    "stack_last": (lambda P, x, y: P.stack([x, y], axis=-1), [X, X - 1],
                   [0, 1]),
    "split_equal": (lambda P, x: P.split(x, 3, axis=1), [X], [0]),
    "split_sections_neg": (lambda P, x: P.split(x, [1, -1], axis=1), [X],
                           [0]),
    "split_sections": (lambda P, x: P.split(x, [1, 2, 1], axis=2), [X], [0]),
    "chunk": (lambda P, x: P.chunk(x, 2, axis=2), [X], [0]),
    "unbind": (lambda P, x: P.unbind(x, axis=1), [X], [0]),
    "unstack": (lambda P, x: P.unstack(x, axis=2), [X], [0]),
    "gather_rows": (lambda P, x, i: P.gather(x, i), [M, IDX], [0]),
    "gather_axis1": (lambda P, x, i: P.gather(x, i, axis=1), [M, IDX], [0]),
    "gather_scalar": (lambda P, x, i: P.gather(x, i), [M, np.int64(1)], [0]),
    "gather_nd": (lambda P, x, i: P.gather_nd(x, i),
                  [M, _i64([0, 1], [2, 2], [3, 4])], [0]),
    "gather_nd_rows": (lambda P, x, i: P.gather_nd(x, i),
                       [X, _i64([1], [0])], [0]),
    "take_along_axis": (lambda P, x, i: P.take_along_axis(x, i, 1),
                        [M, _rs.randint(0, 5, (4, 3)).astype(np.int64)],
                        [0]),
    "put_along_axis_assign": (
        lambda P, x, i, v: P.put_along_axis(x, i, v, 1),
        [M, _i64([0], [2], [4], [1]), np.float32(7.0)], [0]),
    "put_along_axis_add": (
        lambda P, x, i, v: P.put_along_axis(x, i, v, 0, reduce="add"),
        [M, _i64([0, 0, 1, 1, 0], [0, 2, 1, 1, 0]),
         _rs.randn(2, 5).astype(np.float32)], [0, 2]),
    "put_along_axis_mul": (
        lambda P, x, i, v: P.put_along_axis(x, i, v, 1, reduce="mul"),
        [M, _i64([1, 3], [0, 0], [4, 2], [2, 2]),
         _rs.randn(4, 2).astype(np.float32)], []),
    "index_select": (lambda P, x, i: P.index_select(x, i, axis=1),
                     [M, IDX], [0]),
    "index_sample": (lambda P, x, i: P.index_sample(x, i),
                     [M, _rs.randint(0, 5, (4, 2)).astype(np.int64)], [0]),
    "scatter_overwrite": (lambda P, x, i, u: P.scatter(x, i, u),
                          [M, _i64(0, 2), np.ones((2, 5), np.float32)],
                          [0, 2]),
    "scatter_accumulate": (
        lambda P, x, i, u: P.scatter(x, i, u, overwrite=False),
        [M, _i64(1, 1, 3), _rs.randn(3, 5).astype(np.float32)], [0, 2]),
    "scatter_index_2d": (lambda P, x, i, u: P.scatter(x, i, u),
                         [M, _i64([3], [1]), np.zeros((2, 5), np.float32)],
                         [0]),
    "scatter_nd_add": (lambda P, x, i, u: P.scatter_nd_add(x, i, u),
                       [M, _i64([0, 1], [0, 1], [3, 2]),
                        np.array([1.0, 2.0, 3.0], np.float32)], [0, 2]),
    "scatter_nd": (lambda P, i, u: P.scatter_nd(i, u, [4]),
                   [_i64([1], [2], [1]), np.array([9.0, 8.0, 7.0],
                                                  np.float32)], [1]),
    "tile": (lambda P, x: P.tile(x, [1, 2, 1]), [X], [0]),
    "tile_more_dims": (lambda P, m: P.tile(m, [2, 1, 2]), [M], [0]),
    "expand": (lambda P, r: P.expand(r, [3, 4, 5]), [M[:1]], [0]),
    "expand_minus1": (lambda P, r: P.expand(r, [2, -1, 5]), [M[:1]], [0]),
    "expand_as": (lambda P, r, m: P.expand_as(r, m), [V[:1], M], [0]),
    "broadcast_to": (lambda P, v: P.broadcast_to(v, [2, 6]), [V], [0]),
    "broadcast_tensors": (lambda P, a, b: P.broadcast_tensors([a, b]),
                          [M[:, :1], V[:5]], [0, 1]),
    "flip": (lambda P, x: P.flip(x, [0, 2]), [X], [0]),
    "reverse": (lambda P, x: P.reverse(x, 1), [X], [0]),
    "roll_flat": (lambda P, v: P.roll(v, 2), [V], [0]),
    "roll_axis": (lambda P, x: P.roll(x, [1, -1], axis=[0, 2]), [X], [0]),
    "rot90": (lambda P, m: P.rot90(m, 3), [M], [0]),
    "repeat_interleave": (lambda P, m: P.repeat_interleave(m, 2, axis=1),
                          [M], [0]),
    "repeat_interleave_flat": (lambda P, m: P.repeat_interleave(m, 3),
                               [M], [0]),
    "pad_constant": (lambda P, x: P.nn.functional.pad(x, [1, 1, 2, 0],
                                                      value=0.5),
                     [IMG], [0]),
    "pad_reflect": (lambda P, x: P.nn.functional.pad(x, [2, 1, 1, 2],
                                                     mode="reflect"),
                    [IMG], [0]),
    "pad_replicate": (lambda P, x: P.nn.functional.pad(x, [1, 2],
                                                       mode="replicate"),
                      [IMG], [0]),
    "pad_circular": (lambda P, x: P.nn.functional.pad(x, [1, 1, 1, 1],
                                                      mode="circular"),
                     [IMG], [0]),
    "pad_every_dim": (lambda P, m: P.nn.functional.pad(m, [1, 0, 0, 2]),
                      [M], [0]),
    "pad_nhwc": (lambda P, x: P.nn.functional.pad(
        x, [1, 1, 2, 2], data_format="NHWC"), [IMG], [0]),
    "where": (lambda P, c, x, y: P.where(c, x, y),
              [COND, M, M * -3.0], [1, 2]),
    "where_scalar": (lambda P, c, x: P.where(c, x, 0.5), [COND, M], [1]),
    "where_one_arg": (lambda P, c: P.where(c), [COND], []),
    "masked_select": (lambda P, x, c: P.masked_select(x, c), [M, COND], []),
    "masked_fill": (lambda P, x, c: P.masked_fill(x, c, -2.5), [M, COND],
                    [0]),
    "meshgrid": (lambda P, a, b: P.meshgrid(a, b), [V[:3], V[2:]], [0, 1]),
    "shard_index": (lambda P, i: P.shard_index(i, 10, 3, 1), [
        INTS[:, None]], []),
    "numel": (lambda P, x: P.numel(x), [X], []),
    "shape": (lambda P, x: P.shape(x), [X], []),
    "diagonal": (lambda P, x: P.diagonal(x, 1, 1, 2), [X], [0]),
    "multiplex": (lambda P, a, b, i: P.multiplex([a, b], i),
                  [M, M * 2, np.array([[1], [0], [1], [1]], np.int32)],
                  [0, 1]),
    "crop": (lambda P, m: P.crop(m, shape=[2, -1], offsets=[1, 2]), [M],
             [0]),
    "crop_clamped": (lambda P, m: P.crop(m, shape=[3, 2], offsets=[3, 4]),
                     [M], [0]),
    "moveaxis": (lambda P, x: P.moveaxis(x, [0, 1], [2, 0]), [X], [0]),
    "index_add": (lambda P, x, i, v: P.index_add(x, i, 0, v),
                  [M, _i64(1, 3, 1), _rs.randn(3, 5).astype(np.float32)],
                  [0, 2]),
    "index_fill": (lambda P, x, i: P.index_fill(x, i, 1, 4.0),
                   [M, _i64(0, 3)], [0]),
    "tensordot_int": (lambda P, a, b: P.tensordot(a, b, 1),
                      [X, M], [0, 1]),
    "tensordot_axes": (lambda P, a, b: P.tensordot(a, b, [[2], [0]]),
                       [X, M], [0, 1]),
    "as_real": (lambda P, c: P.as_real(c),
                [(M + 1j * M[::-1]).astype(np.complex64)], []),
    "as_complex": (lambda P, x: P.as_complex(x),
                   [_rs.randn(3, 2).astype(np.float32)], []),
    # search
    "argmax_flat": (lambda P, m: P.argmax(m), [M], []),
    "argmax_axis_keepdim": (lambda P, m: P.argmax(m, axis=1, keepdim=True),
                            [M], []),
    "argmax_int32": (lambda P, m: P.argmax(m, axis=0, dtype="int32"), [M],
                     []),
    "argmin": (lambda P, m: P.argmin(m, axis=-1), [M], []),
    "topk": (lambda P, m: P.topk(m, 3, axis=1), [M], [0]),
    "topk_smallest_axis0": (lambda P, m: P.topk(m, 2, axis=0,
                                                largest=False), [M], [0]),
    "topk_method": (lambda P, v: v.topk(2), [V], [0]),
    "argsort_ties": (lambda P, t: P.argsort(t, axis=1), [TIES], []),
    "argsort_ties_desc": (lambda P, t: P.argsort(t, axis=1,
                                                 descending=True),
                          [TIES], []),
    "sort": (lambda P, m: P.sort(m, axis=1), [M], [0]),
    "sort_desc_axis0": (lambda P, m: P.sort(m, axis=0, descending=True),
                        [M], [0]),
    "nonzero": (lambda P, i: P.nonzero(i), [INTS.reshape(2, 5) % 3], []),
    "nonzero_tuple": (lambda P, i: P.nonzero(i, as_tuple=True),
                      [INTS.reshape(2, 5) % 3], []),
    "searchsorted": (lambda P, s, v: P.searchsorted(s, v),
                     [np.sort(V), V[::-1].copy()], []),
    "searchsorted_right": (lambda P, s, v: P.searchsorted(s, v, right=True),
                           [np.array([1.0, 2.0, 2.0, 3.0], np.float32),
                            np.array([2.0, 0.0, 3.5], np.float32)], []),
    "bucketize": (lambda P, v, s: P.bucketize(v, s),
                  [V, np.array([-1.0, 0.0, 1.0], np.float32)], []),
    "unique": (lambda P, i: P.unique(i), [INTS], []),
    "unique_all": (lambda P, i: P.unique(i.reshape([2, 5]),
                                         return_index=True,
                                         return_inverse=True,
                                         return_counts=True), [INTS], []),
    "kthvalue": (lambda P, m: P.kthvalue(m, 2, axis=1), [M], [0]),
    "kthvalue_keepdim": (lambda P, t: P.kthvalue(t, 3, axis=1,
                                                 keepdim=True), [TIES], []),
    "mode": (lambda P, t: P.mode(t, axis=-1), [TIES], []),
    "bincount": (lambda P, i: P.bincount(i), [INTS], []),
    "bincount_weights": (lambda P, i, w: P.bincount(i, w, minlength=12),
                         [INTS, _rs.rand(10).astype(np.float32)], []),
}


def _cotangent(k, shape):
    return np.asarray(np.random.RandomState(100 + k).randn(*shape),
                      np.float32)


def _run(P, fn, inputs, grad_idx):
    ts = []
    for i, a in enumerate(inputs):
        t = P.to_tensor(a)
        if i in grad_idx:
            t.stop_gradient = False
        ts.append(t)
    out = fn(P, *ts)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    values = [np.asarray(o.numpy()) for o in outs]
    dtypes = [o.dtype.name for o in outs]
    grads = []
    if grad_idx:
        total = None
        for k, o in enumerate(outs):
            if "float" in o.dtype.name and not o.stop_gradient:
                term = (o * P.to_tensor(_cotangent(k, o.shape))).sum()
                total = term if total is None else total + term
        total.backward()
        grads = [ts[i].grad.numpy() for i in grad_idx]
    return values, dtypes, grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_the_reference(name):
    fn, inputs, grad_idx = CASES[name]
    want, want_dt, want_g = _run(ref, fn, inputs, grad_idx)
    got, got_dt, got_g = _run(paddle, fn, inputs, grad_idx)
    assert got_dt == want_dt
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=1e-6)


@pytest.mark.parametrize("axes,starts,ends,strides", [
    ([0, 2], [0, -3], [1, 4], None),
    ([1, 2], [0, 0], [3, 4], [2, 3]),
    ([2], [3], [0], [-2]),
    ([1], [-100], [100], None),
])
def test_slice_and_strided_slice_against_numpy(axes, starts, ends, strides):
    """Held to numpy's slicing: the reference's ``_slice`` calls its
    module's own ``slice`` op where it means the builtin
    (paddle_tpu/ops/manipulation.py:176) and raises TypeError."""
    t = paddle.to_tensor(X, stop_gradient=False)
    if strides is None:
        out = paddle.slice(t, axes, starts, ends)
        strides = [1] * len(axes)
    else:
        out = paddle.strided_slice(t, axes, starts, ends, strides)
    idx = [slice(None)] * X.ndim
    for a, s, e, d in zip(axes, starts, ends, strides):
        idx[a] = slice(s, e, d)
    want = X[tuple(idx)]
    np.testing.assert_array_equal(out.numpy(), want)
    out.sum().backward()
    g = np.zeros_like(X)
    g[tuple(idx)] = 1.0
    np.testing.assert_array_equal(t.grad.numpy(), g)
    with pytest.raises(TypeError):
        ref.slice(ref.to_tensor(X), axes, starts, ends)


def test_reshape_zero_without_an_input_dim_raises():
    for P in (ref, paddle):
        with pytest.raises(P.errors.InvalidArgumentError):
            P.reshape(P.to_tensor(V), [0, 0])


def test_test_ops_manipulation_scenarios():
    """tests/test_ops.py's TestManipulation and TestSearch, in both
    packages on the same inputs."""
    x = np.arange(24).reshape(2, 3, 4).astype("float32")
    for P in (ref, paddle):
        parts = P.split(P.to_tensor(x), 3, axis=1)
        assert len(parts) == 3 and parts[0].shape == [2, 1, 4]
        parts = P.split(P.to_tensor(x), [1, -1], axis=1)
        assert parts[1].shape == [2, 2, 4]
        np.testing.assert_array_equal(
            P.expand(P.ones([1, 3]), [4, 3]).numpy(), np.ones((4, 3)))
        s = P.to_tensor(SQ)
        assert P.squeeze(s).shape == [3]
        assert P.squeeze(s, axis=0).shape == [3, 1]
        assert P.unsqueeze(s, [0, 4]).shape == [1, 1, 3, 1, 1]
        out = P.put_along_axis(P.zeros([3, 1]), P.to_tensor(_i64([0], [0])),
                               P.to_tensor(np.array([[1.0], [2.0]],
                                                    np.float32)),
                               axis=0, reduce="add")
        assert out.numpy()[0, 0] == pytest.approx(3.0)
        nz = P.nonzero(P.to_tensor(np.array([0, 1, 0, 2])))
        np.testing.assert_array_equal(nz.numpy(), [[1], [3]])
        assert nz.dtype == P.int64
        u = P.unique(P.to_tensor(np.array([3, 1, 3, 2])))
        np.testing.assert_array_equal(u.numpy(), [1, 2, 3])
        v, i = P.topk(P.to_tensor(M), 3, axis=1)
        assert i.dtype == P.int64 and v.shape == [4, 3]
        assert P.argmax(P.to_tensor(M), axis=1).dtype == P.int64


@pytest.mark.parametrize("name", ["reshape_", "squeeze_", "unsqueeze_",
                                  "flatten_", "scatter_", "index_add_",
                                  "index_fill_"])
def test_inplace_variants(name):
    """The shape-changing in-place variants swap the tensor's value and
    keep the Tensor, as tests/test_ops.py::test_inplace_variants."""
    calls = {
        "reshape_": lambda P, t: t.reshape_([12, 2]),
        "squeeze_": lambda P, t: P.squeeze_(t, 0),
        "unsqueeze_": lambda P, t: t.unsqueeze_(1),
        "flatten_": lambda P, t: t.flatten_(),
        "scatter_": lambda P, t: P.scatter_(
            t, P.to_tensor(_i64(1)), P.to_tensor(np.full((1, 3, 4), 5.0,
                                                         np.float32))),
        "index_add_": lambda P, t: P.index_add_(
            t, P.to_tensor(_i64(0, 0)), 2,
            P.to_tensor(np.ones((2, 3, 2), np.float32))),
        "index_fill_": lambda P, t: P.index_fill_(
            t, P.to_tensor(_i64(2)), 1, -1.0),
    }

    def run(P):
        t = P.to_tensor(X)
        out = calls[name](P, t)
        assert out is t
        return t.numpy(), t.shape

    (want, ws), (got, gs) = run(ref), run(paddle)
    assert gs == ws
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_a_views_write_reaches_its_source():
    """The documented divergence: reshape returns a torch view, so a
    write into it is seen by the source (the reference's arrays are
    immutable)."""
    t = paddle.to_tensor(np.zeros((2, 3), np.float32))
    r = t.reshape([6])
    r[0] = 1.0
    assert t.numpy()[0, 0] == 1.0
    rt = ref.to_tensor(np.zeros((2, 3), np.float32))
    rr = rt.reshape([6])
    rr[0] = 1.0
    assert rt.numpy()[0, 0] == 0.0
