"""paddle_tpu_torch's convolutions and pools against the JAX package's on
the CPU: every conv (1d, 2d, 3d, the transposes) with its grads, XLA's
``SAME`` (asymmetric at stride 2) and ``VALID``, the 4-element padding,
NHWC, groups, dilation; every pool (max and average in 1d, 2d and 3d,
the adaptive ones, ``ceil_mode``, ``exclusive``, ``divisor_override``,
NDHWC), the masks of the with-index pools, and the max pool's gradient
on planted ties, which the reference's chain of ``jnp.maximum`` splits
1/4, 1/4, 1/2 in window order (``F.max_pool2d`` gives it all to one
element; the port's chain of ``torch.maximum`` splits it as the
reference does). The scenarios of tests/test_autograd.py's
``test_conv2d_grad`` and tests/test_functional_gaps.py's pool masks run
against both packages.

Values at f32 ``allclose`` rtol 1e-5 / atol 1e-5 (a conv's sums run in
another order: XLA's against oneDNN's), grads (against a fixed
cotangent) at rtol 1e-4 / atol 1e-5; pools, which only pick and add
a few values, at 1e-6; masks and tie grads exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod

RTOL = ATOL = 1e-5
GRAD_RTOL = 1e-4
POOL_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def F(P):
    return P.nn.functional


_rs = np.random.RandomState(0)


def _r(*shape):
    return _rs.randn(*shape).astype(np.float32)


X2 = _r(2, 4, 9, 9)
X2_NHWC = X2.transpose(0, 2, 3, 1).copy()
W2 = _r(6, 4, 3, 3)
WG = _r(6, 2, 3, 3)           # groups=2
WDW = _r(4, 1, 3, 3)          # depthwise
B6 = _r(6)
X1 = _r(2, 4, 11)
W1 = _r(5, 4, 3)
X3 = _r(1, 3, 5, 6, 7)
W3 = _r(4, 3, 2, 3, 2)
WT2 = _r(4, 3, 3, 3)          # transposed: [in, out/groups, k, k]
WT2G = _r(4, 2, 3, 3)         # groups=2: out = 4
WT1 = _r(4, 3, 4)
WT3 = _r(3, 2, 2, 2, 3)
XP = _r(2, 3, 7, 8)
XP1 = _r(2, 3, 10)
XP3 = _r(1, 2, 5, 6, 7)


def _cot(k, shape):
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
            if "float" in o.dtype.name:
                term = (o * P.to_tensor(_cot(k, o.shape))).sum()
                total = term if total is None else total + term
        total.backward()
        grads = [ts[i].grad.numpy() for i in grad_idx]
    return values, dtypes, grads


CONVS = {
    "conv2d": (lambda P, x, w, b: F(P).conv2d(x, w, b), [X2, W2, B6],
               [0, 1, 2]),
    "conv2d_pad_stride": (lambda P, x, w: F(P).conv2d(
        x, w, stride=2, padding=1), [X2, W2], [0, 1]),
    "conv2d_pair_pad_dilation": (lambda P, x, w: F(P).conv2d(
        x, w, padding=(2, 1), dilation=(2, 1)), [X2, W2], [0, 1]),
    "conv2d_pad4": (lambda P, x, w: F(P).conv2d(
        x, w, padding=[0, 2, 1, 0]), [X2, W2], [0, 1]),
    "conv2d_same_s1": (lambda P, x, w: F(P).conv2d(x, w, padding="SAME"),
                       [X2, W2], [0, 1]),
    "conv2d_same_s2": (lambda P, x, w: F(P).conv2d(
        x, w, stride=2, padding="same"), [X2[:, :, :8, :8], W2], [0, 1]),
    "conv2d_same_s2_k2": (lambda P, x, w: F(P).conv2d(
        x, w[:, :, :2, :2], stride=2, padding="SAME"), [X2, W2], [0, 1]),
    "conv2d_same_s3_dilated": (lambda P, x, w: F(P).conv2d(
        x, w, stride=3, padding="SAME", dilation=2), [X2, W2], [0, 1]),
    "conv2d_valid": (lambda P, x, w: F(P).conv2d(
        x, w, stride=2, padding="VALID"), [X2, W2], [0, 1]),
    "conv2d_nhwc": (lambda P, x, w, b: F(P).conv2d(
        x, w, b, stride=2, padding=1, data_format="NHWC"),
        [X2_NHWC, W2, B6], [0, 1, 2]),
    "conv2d_nhwc_same": (lambda P, x, w: F(P).conv2d(
        x, w, stride=2, padding="SAME", data_format="NHWC"),
        [X2_NHWC, W2], [0, 1]),
    "conv2d_groups": (lambda P, x, w, b: F(P).conv2d(
        x, w, b, padding=1, groups=2), [X2, WG, B6], [0, 1, 2]),
    "conv2d_depthwise_s2": (lambda P, x, w: F(P).conv2d(
        x, w, stride=2, padding=1, groups=4), [X2, WDW], [0, 1]),
    "conv1d": (lambda P, x, w: F(P).conv1d(x, w, stride=2, padding=1),
               [X1, W1], [0, 1]),
    "conv1d_same": (lambda P, x, w: F(P).conv1d(x, w, stride=2,
                                                 padding="SAME"),
                    [X1, W1], [0, 1]),
    "conv1d_dilated_bias": (lambda P, x, w, b: F(P).conv1d(
        x, w, b[:5], dilation=2), [X1, W1, B6], [0, 1, 2]),
    "conv3d": (lambda P, x, w: F(P).conv3d(x, w, stride=(1, 2, 1),
                                           padding=1), [X3, W3], [0, 1]),
    "conv3d_same": (lambda P, x, w: F(P).conv3d(x, w, stride=2,
                                                padding="SAME"),
                    [X3, W3], [0, 1]),
    "conv3d_ndhwc": (lambda P, x, w: F(P).conv3d(
        x, w, padding=1, data_format="NDHWC"),
        [X3.transpose(0, 2, 3, 4, 1).copy(), W3], [0, 1]),
    "conv2d_transpose": (lambda P, x, w, b: F(P).conv2d_transpose(
        x, w, b[:3], stride=2, padding=1, output_padding=1),
        [X2, WT2, B6], [0, 1, 2]),
    "conv2d_transpose_dilated": (lambda P, x, w: F(P).conv2d_transpose(
        x, w, stride=(2, 1), padding=(0, 1), dilation=2), [X2, WT2], [0, 1]),
    "conv2d_transpose_groups": (lambda P, x, w: F(P).conv2d_transpose(
        x, w, stride=2, groups=2, output_size=[99, 99]), [X2, WT2G],
        [0, 1]),
    "conv1d_transpose": (lambda P, x, w: F(P).conv1d_transpose(
        x, w, stride=3, padding=1, output_padding=2), [X1, WT1], [0, 1]),
    "conv3d_transpose": (lambda P, x, w: F(P).conv3d_transpose(
        x, w, stride=2, padding=(0, 1, 1)), [X3, WT3], [0, 1]),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv_and_its_grads(name):
    fn, inputs, grad_idx = CONVS[name]
    (w, wd, wg), (g, gd, gg) = (_run(P, fn, inputs, grad_idx)
                                for P in (ref, paddle))
    assert gd == wd
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=ATOL)


def test_same_padding_at_stride_2_puts_the_larger_half_at_the_end():
    """XLA's SAME on 8 rows, k 3, stride 2: 4 outputs need 9 rows, one
    of padding, at the end (none at the start): the first output's
    window starts on row 0."""
    x = np.zeros((1, 1, 8, 8), np.float32)
    x[0, 0, 0, 0] = 1.0
    w = np.zeros((1, 1, 3, 3), np.float32)
    w[0, 0, 0, 0] = 1.0
    for P in (ref, paddle):
        out = F(P).conv2d(P.to_tensor(x), P.to_tensor(w), stride=2,
                          padding="SAME").numpy()
        assert out.shape == (1, 1, 4, 4) and out[0, 0, 0, 0] == 1.0


def test_conv2d_grad_scenario():
    """tests/test_autograd.py::test_conv2d_grad in both packages: the
    grad of sum(conv2d(x, w)) in x."""
    rs = np.random.RandomState(7)
    x_np, w_np = rs.randn(1, 2, 6, 6), rs.randn(3, 2, 3, 3)
    grads = []
    for P in (ref, paddle):
        x = P.to_tensor(x_np.astype(np.float32), stop_gradient=False)
        w = P.to_tensor(w_np.astype(np.float32), stop_gradient=False)
        F(P).conv2d(x, w).sum().backward()
        grads.append((x.grad.numpy(), w.grad.numpy()))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=ATOL)
    np.testing.assert_allclose(grads[1][0][0], _xgrad_of_sum_conv(w_np),
                               rtol=1e-4, atol=1e-4)


def _xgrad_of_sum_conv(w):
    """d sum(conv2d(x, w)) / dx for a [1, 2, 6, 6] x, by hand."""
    g = np.zeros((2, 6, 6))
    for i in range(4):
        for j in range(4):
            g[:, i:i + 3, j:j + 3] += w.sum(0)
    return g


POOLS = {
    "max_pool2d": (lambda P, x: F(P).max_pool2d(x, 2), [XP], [0]),
    "max_pool2d_3s2p1": (lambda P, x: F(P).max_pool2d(x, 3, 2, 1), [XP],
                         [0]),
    "max_pool2d_ceil": (lambda P, x: F(P).max_pool2d(
        x, 3, 2, ceil_mode=True), [XP], [0]),
    "max_pool2d_ceil_pad": (lambda P, x: F(P).max_pool2d(
        x, (2, 3), (2, 2), (1, 0), ceil_mode=True), [XP], [0]),
    "max_pool2d_mask": (lambda P, x: F(P).max_pool2d(
        x, 3, 2, 1, return_mask=True), [XP], [0]),
    "max_pool2d_mask_ceil": (lambda P, x: F(P).max_pool2d(
        x, 2, 2, ceil_mode=True, return_mask=True), [XP], [0]),
    "avg_pool2d": (lambda P, x: F(P).avg_pool2d(x, 2), [XP], [0]),
    "avg_pool2d_exclusive_pad": (lambda P, x: F(P).avg_pool2d(
        x, 3, 2, 1), [XP], [0]),
    "avg_pool2d_inclusive_pad": (lambda P, x: F(P).avg_pool2d(
        x, 3, 2, 1, exclusive=False), [XP], [0]),
    "avg_pool2d_unread_args": (lambda P, x: F(P).avg_pool2d(
        x, 3, 2, 1, ceil_mode=True, divisor_override=5,
        data_format="NHWC"), [XP], [0]),
    "adaptive_avg_pool2d": (lambda P, x: F(P).adaptive_avg_pool2d(
        x, (1, 1)), [XP], [0]),
    "adaptive_avg_pool2d_divides": (lambda P, x: F(P).adaptive_avg_pool2d(
        x, (7, 4)), [XP], [0]),
    "adaptive_avg_pool2d_resizes": (lambda P, x: F(P).adaptive_avg_pool2d(
        x, (3, 5)), [XP], [0]),
    "adaptive_max_pool2d": (lambda P, x: F(P).adaptive_max_pool2d(
        x, (7, 2)), [XP], [0]),
    "adaptive_max_pool2d_mask": (lambda P, x: F(P).adaptive_max_pool2d(
        x, (1, 4), return_mask=True), [XP], [0]),
    "max_pool1d": (lambda P, x: F(P).max_pool1d(x, 3, 2, 1), [XP1], [0]),
    "max_pool1d_mask": (lambda P, x: F(P).max_pool1d(
        x, 2, return_mask=True), [XP1], [0]),
    "avg_pool1d": (lambda P, x: F(P).avg_pool1d(x, 3, 2, 1), [XP1], [0]),
    "adaptive_avg_pool1d": (lambda P, x: F(P).adaptive_avg_pool1d(x, 5),
                            [XP1], [0]),
    "adaptive_avg_pool1d_resizes": (lambda P, x: F(P).adaptive_avg_pool1d(
        x, 4), [XP1], [0]),
    "adaptive_max_pool1d_mask": (lambda P, x: F(P).adaptive_max_pool1d(
        x, 2, return_mask=True), [XP1], [0]),
    "max_pool3d": (lambda P, x: F(P).max_pool3d(x, 2, 2, 1), [XP3], [0]),
    "max_pool3d_ceil": (lambda P, x: F(P).max_pool3d(
        x, 2, 2, ceil_mode=True), [XP3], [0]),
    "max_pool3d_mask": (lambda P, x: F(P).max_pool3d(
        x, (2, 3, 2), 2, 1, return_mask=True), [XP3], [0]),
    "max_pool3d_ndhwc": (lambda P, x: F(P).max_pool3d(
        x, 2, 2, data_format="NDHWC"),
        [XP3.transpose(0, 2, 3, 4, 1).copy()], [0]),
    "avg_pool3d": (lambda P, x: F(P).avg_pool3d(x, 2, 2, 1), [XP3], [0]),
    "avg_pool3d_ceil": (lambda P, x: F(P).avg_pool3d(
        x, 2, 2, ceil_mode=True), [XP3], [0]),
    "avg_pool3d_divisor": (lambda P, x: F(P).avg_pool3d(
        x, 2, 2, 1, divisor_override=3), [XP3], [0]),
    "avg_pool3d_inclusive": (lambda P, x: F(P).avg_pool3d(
        x, 3, 2, 1, exclusive=False), [XP3], [0]),
    "adaptive_avg_pool3d": (lambda P, x: F(P).adaptive_avg_pool3d(
        x, (5, 3, 1)), [XP3], [0]),
    "adaptive_max_pool3d": (lambda P, x: F(P).adaptive_max_pool3d(
        x, (1, 2, 7)), [XP3], [0]),
    "adaptive_max_pool3d_mask": (lambda P, x: F(P).adaptive_max_pool3d(
        x, (5, 3, 1), return_mask=True), [XP3], [0]),
}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pool_and_its_grad(name):
    fn, inputs, grad_idx = POOLS[name]
    (w, wd, wg), (g, gd, gg) = (_run(P, fn, inputs, grad_idx)
                                for P in (ref, paddle))
    assert gd == wd
    for a, b in zip(g, w):
        assert a.shape == b.shape
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=POOL_TOL, atol=POOL_TOL)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, rtol=POOL_TOL, atol=POOL_TOL)


def _tied():
    """[1, 1, 4, 4]: the top-left 3x3 window holds three equal maxima
    (window slots 0, 4 and 8), another window two, the rest distinct."""
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4) / 100.0
    x[0, 0, 0, 0] = x[0, 0, 1, 1] = x[0, 0, 2, 2] = 5.0
    x[0, 0, 3, 3] = 5.0
    return x


@pytest.mark.parametrize("P", [ref, paddle], ids=["ref", "port"])
def test_max_pool_tie_grads_split_down_the_chain(P):
    x = P.to_tensor(_tied(), stop_gradient=False)
    F(P).max_pool2d(x, 3, 1).sum().backward()
    g = x.grad.numpy()[0, 0]
    # window (0, 0) holds all three: the chain gives 1/4, 1/4, 1/2;
    # windows (0, 1) and (1, 0) hold two of them (1/2 each); window
    # (1, 1) holds (1, 1), (2, 2) and (3, 3)
    assert g[0, 0] == 0.25
    assert g[1, 1] == 0.25 + 0.5 + 0.5 + 0.25
    assert g[2, 2] == 0.5 + 0.5 + 0.5 + 0.25
    assert g[3, 3] == 0.5
    assert g.sum() == 4.0


def test_max_pool_ties_both_packages_and_torch_builtin_differs():
    """bf16 activations tie often: the port's grads equal the
    reference's element by element on tied inputs at several window
    shapes, with and without the mask; torch's own max pool routes the
    whole grad of a tie to one element."""
    rs = np.random.RandomState(3)
    x = rs.randint(0, 3, (2, 2, 7, 7)).astype(np.float32)
    cot = rs.randn(2, 2, 4, 4).astype(np.float32)
    for ks, st, pad in (((3, 3), 2, 0), ((3, 3), 2, 1), ((2, 2), 2, 0)):
        got = []
        for P in (ref, paddle):
            xt = P.to_tensor(x, stop_gradient=False)
            out = F(P).max_pool2d(xt, ks, st, pad)
            c = cot[:, :, :out.shape[2], :out.shape[3]]
            (out * P.to_tensor(np.ascontiguousarray(c))).sum().backward()
            got.append(xt.grad.numpy())
        # overlapping windows add their shares in another order
        np.testing.assert_allclose(got[0], got[1], rtol=POOL_TOL,
                                   atol=1e-7)
    xt = torch.tensor(x, requires_grad=True)
    torch.nn.functional.max_pool2d(xt, 3, 2).sum().backward()
    port = paddle.to_tensor(x, stop_gradient=False)
    F(paddle).max_pool2d(port, 3, 2).sum().backward()
    assert not np.array_equal(xt.grad.numpy(), port.grad.numpy())
    for P in (ref, paddle):
        xt = P.to_tensor(x, stop_gradient=False)
        out, mask = F(P).max_pool2d(xt, 3, 2, 1, return_mask=True)
        out.sum().backward()
        got.append((mask.numpy(), xt.grad.numpy()))
    # the masks take the first maximum; amax splits a tie evenly (1/3s
    # added in another order across overlapping windows)
    np.testing.assert_array_equal(got[-2][0], got[-1][0])
    np.testing.assert_allclose(got[-2][1], got[-1][1], rtol=POOL_TOL,
                               atol=1e-7)


@pytest.mark.parametrize("P", [ref, paddle], ids=["ref", "port"])
class TestFunctionalGapsScenarios:
    """tests/test_functional_gaps.py's pool scenarios (:13-100), each in
    both packages."""

    def test_mask_matches_numpy_argmax(self, P):
        x = np.random.RandomState(0).randn(2, 3, 8, 8).astype(np.float32)
        out, mask = F(P).max_pool2d(P.to_tensor(x), 2, 2, return_mask=True)
        o, m = out.numpy(), mask.numpy()
        assert o.shape == (2, 3, 4, 4) and m.shape == (2, 3, 4, 4)
        for n in range(2):
            for c in range(3):
                for i in range(4):
                    for j in range(4):
                        win = x[n, c, 2 * i:2 * i + 2, 2 * j:2 * j + 2]
                        assert o[n, c, i, j] == win.max()
                        r, co = np.unravel_index(int(m[n, c, i, j]), (8, 8))
                        assert x[n, c, r, co] == win.max()

    def test_mask_with_padding(self, P):
        x = P.to_tensor(np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4))
        _, mask = F(P).max_pool2d(x, 3, 2, padding=1, return_mask=True)
        assert int(mask.numpy()[0, 0, -1, -1]) == 15

    def test_max_pool1d_and_3d_masks(self, P):
        rs = np.random.RandomState(1)
        x1 = rs.randn(2, 3, 8).astype(np.float32)
        o1, m1 = F(P).max_pool1d(P.to_tensor(x1), 2, 2, return_mask=True)
        for n in range(2):
            for c in range(3):
                for i in range(4):
                    assert x1[n, c, int(m1.numpy()[n, c, i])] == \
                        o1.numpy()[n, c, i]
        x3 = rs.randn(1, 2, 4, 4, 4).astype(np.float32)
        o3, m3 = F(P).max_pool3d(P.to_tensor(x3), 2, 2, return_mask=True)
        flat = x3.reshape(1, 2, -1)
        for c in range(2):
            got = np.take(flat[0, c], m3.numpy()[0, c].reshape(-1))
            np.testing.assert_allclose(got, o3.numpy()[0, c].reshape(-1))

    def test_ceil_mode_with_mask_matches_value_path(self, P):
        rs = np.random.RandomState(9)
        x = rs.randn(1, 1, 5, 5).astype(np.float32)
        plain = F(P).max_pool2d(P.to_tensor(x), 2, 2, ceil_mode=True)
        out, mask = F(P).max_pool2d(P.to_tensor(x), 2, 2, ceil_mode=True,
                                    return_mask=True)
        assert out.shape == plain.shape == [1, 1, 3, 3]
        np.testing.assert_allclose(out.numpy(), plain.numpy())
        got = np.take(x.reshape(-1), mask.numpy().reshape(-1))
        np.testing.assert_allclose(got, out.numpy().reshape(-1))
        x3 = rs.randn(1, 1, 5, 5, 5).astype(np.float32)
        p3 = F(P).max_pool3d(P.to_tensor(x3), 2, 2, ceil_mode=True)
        o3, _ = F(P).max_pool3d(P.to_tensor(x3), 2, 2, ceil_mode=True,
                                return_mask=True)
        assert o3.shape == p3.shape == [1, 1, 3, 3, 3]
        np.testing.assert_allclose(o3.numpy(), p3.numpy())

    def test_ceil_mode_2d_adds_partial_window(self, P):
        x = P.to_tensor(np.arange(25, dtype=np.float32).reshape(1, 1, 5, 5))
        assert F(P).max_pool2d(x, 2, 2, ceil_mode=True).shape == [1, 1, 3, 3]
        assert F(P).max_pool2d(x, 2, 2, ceil_mode=False).shape \
            == [1, 1, 2, 2]

    def test_adaptive_masks(self, P):
        x = np.random.RandomState(2).randn(1, 2, 8, 8).astype(np.float32)
        out, mask = F(P).adaptive_max_pool2d(P.to_tensor(x), 4,
                                             return_mask=True)
        flat = x.reshape(1, 2, -1)
        for c in range(2):
            got = np.take(flat[0, c], mask.numpy()[0, c].reshape(-1))
            np.testing.assert_allclose(got, out.numpy()[0, c].reshape(-1))

    def test_ndhwc_matches_ncdhw_transposed(self, P):
        x = np.random.RandomState(3).randn(2, 4, 6, 6, 3).astype(np.float32)
        out = F(P).max_pool3d(P.to_tensor(x), 2, 2, data_format="NDHWC")
        want = F(P).max_pool3d(P.to_tensor(x.transpose(0, 4, 1, 2, 3)), 2,
                               2)
        np.testing.assert_allclose(out.numpy().transpose(0, 4, 1, 2, 3),
                                   want.numpy())


def test_adaptive_max_pool_takes_only_sizes_that_divide():
    x = np.zeros((1, 1, 7, 7), np.float32)
    with pytest.raises(AssertionError):
        F(ref).adaptive_max_pool2d(ref.to_tensor(x), 3)
    with pytest.raises(ValueError):
        F(paddle).adaptive_max_pool2d(paddle.to_tensor(x), 3)
    with pytest.raises(ValueError):
        F(paddle).adaptive_max_pool3d(
            paddle.to_tensor(np.zeros((1, 1, 4, 4, 5), np.float32)), 2)


LAYERS = {
    "Conv2D": lambda P: P.nn.Conv2D(4, 6, 3, stride=2, padding=1),
    "Conv2D_nobias_groups": lambda P: P.nn.Conv2D(4, 6, 3, groups=2,
                                                  bias_attr=False),
    "Conv1D": lambda P: P.nn.Conv1D(4, 5, 3, padding=1),
    "Conv3D": lambda P: P.nn.Conv3D(4, 2, 2),
    "Conv2DTranspose": lambda P: P.nn.Conv2DTranspose(4, 3, 3, stride=2),
    "Conv1DTranspose": lambda P: P.nn.Conv1DTranspose(4, 3, 3, stride=2),
    "Conv3DTranspose": lambda P: P.nn.Conv3DTranspose(4, 2, 2, stride=2),
    "MaxPool2D": lambda P: P.nn.MaxPool2D(3, 2, 1),
    "MaxPool2D_ceil": lambda P: P.nn.MaxPool2D(2, ceil_mode=True),
    "AvgPool2D": lambda P: P.nn.AvgPool2D(3, 2, 1),
    "MaxPool1D": lambda P: P.nn.MaxPool1D(2),
    "AvgPool1D": lambda P: P.nn.AvgPool1D(3, 1, 1, exclusive=False),
    "AdaptiveAvgPool2D": lambda P: P.nn.AdaptiveAvgPool2D((1, 1)),
    "AdaptiveMaxPool2D": lambda P: P.nn.AdaptiveMaxPool2D(2),
    "AdaptiveAvgPool1D": lambda P: P.nn.AdaptiveAvgPool1D(3),
    "AdaptiveMaxPool1D": lambda P: P.nn.AdaptiveMaxPool1D(2),
    "MaxPool3D": lambda P: P.nn.MaxPool3D(2),
    "AvgPool3D": lambda P: P.nn.AvgPool3D(2, 1),
    "AdaptiveAvgPool3D": lambda P: P.nn.AdaptiveAvgPool3D(2),
    "AdaptiveMaxPool3D": lambda P: P.nn.AdaptiveMaxPool3D((2, 1, 2)),
}
_LAYER_IN = {1: _r(2, 4, 12), 2: _r(2, 4, 8, 8), 3: _r(1, 4, 4, 6, 4)}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_carries_the_reference_weights(name):
    """The same construction in both packages: the same state_dict keys
    and shapes; the reference's weights carried over give its forward and
    its input grad."""
    layers = [LAYERS[name](P) for P in (ref, paddle)]
    sd = {k: v.numpy() for k, v in layers[0].state_dict().items()}
    assert list(sd) == list(layers[1].state_dict())
    assert layers[1].set_state_dict(sd) == []
    nd = 1 if "1D" in name else 3 if "3D" in name else 2
    got = []
    for P, layer in zip((ref, paddle), layers):
        x = P.to_tensor(_LAYER_IN[nd], stop_gradient=False)
        out = layer(x)
        (out * P.to_tensor(_cot(0, out.shape))).sum().backward()
        got.append((out.numpy(), x.grad.numpy()))
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=GRAD_RTOL,
                               atol=ATOL)
