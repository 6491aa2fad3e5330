"""paddle_tpu_torch's resampling against the JAX package's on the CPU:
``interpolate`` in every mode and alignment (values and grads), the port's
``image_resize`` against ``jax.image.resize`` itself on shrinking,
growing and mixed shapes (the reference's non-aligned linear and cubic
modes, its adaptive average pool over bins that do not divide and
``transforms.Resize`` call it: it antialiases when it shrinks, its cubic
is Keys' a = -0.5, neither of which ``F.interpolate`` does), ``grid_sample``
in every mode and padding (points outside the map included),
``affine_grid``, ``pixel_shuffle``, ``unfold``, ``temporal_shift`` and the
layers over them. tests/test_functional_gaps.py's interpolate scenarios
(:174-250) run against both packages.

Values at f32 ``allclose`` rtol 1e-5 / atol 1e-5 (the resize is a
product over an axis, in another order than XLA's einsum), grads at
rtol 1e-4 / atol 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.ops.nn_ops import image_resize

RTOL = ATOL = 1e-5
GRAD_RTOL = 1e-4


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


X = _r(2, 3, 6, 7)
X1 = _r(2, 3, 9)
X3 = _r(1, 2, 4, 5, 3)


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
    if grad_idx:
        (out * P.to_tensor(_cot(0, out.shape))).sum().backward()
    return out.numpy(), out.dtype.name, [ts[i].grad.numpy()
                                         for i in grad_idx]


def _interp(size=None, scale=None, mode="nearest", align=False):
    return lambda P, x: F(P).interpolate(x, size=size, scale_factor=scale,
                                         mode=mode, align_corners=align)


CASES = {}
for _mode in ("nearest", "bilinear", "bicubic"):
    for _align in (False, True):
        for _tag, _size in (("grow", (11, 13)), ("shrink", (3, 2)),
                            ("mixed", (9, 4)), ("same_h", (6, 3))):
            CASES[f"{_mode}_{'aligned' if _align else 'half'}_{_tag}"] = (
                _interp(_size, mode=_mode, align=_align), [X], [0])
CASES.update({
    "bilinear_scale_factor": (_interp(scale=1.5, mode="bilinear"), [X], [0]),
    "nearest_scale_pair": (_interp(scale=[2, 0.5]), [X], [0]),
    "bilinear_out_one_aligned": (_interp((1, 1), mode="bilinear",
                                         align=True), [X], [0]),
    "linear_1d_shrink": (_interp((4,), mode="linear"), [X1], [0]),
    "linear_1d_grow_aligned": (_interp((20,), mode="linear", align=True),
                               [X1], [0]),
    "nearest_1d": (_interp((5,)), [X1], [0]),
    "trilinear_mixed": (_interp((2, 9, 3), mode="trilinear"), [X3], [0]),
    "trilinear_aligned": (_interp((6, 3, 5), mode="trilinear", align=True),
                          [X3], [0]),
    "upsample": (lambda P, x: F(P).upsample(x, size=[12, 14],
                                            mode="bilinear"), [X], [0]),
    "pixel_shuffle": (lambda P, x: F(P).pixel_shuffle(x, 2),
                      [_r(2, 8, 3, 4)], [0]),
    "temporal_shift": (lambda P, x: F(P).temporal_shift(x, 3),
                       [_r(6, 8, 2, 3)], [0]),
    "temporal_shift_ratio": (lambda P, x: F(P).temporal_shift(
        x, 2, shift_ratio=0.3), [_r(4, 7, 2, 2)], [0]),
    "unfold": (lambda P, x: F(P).unfold(x, 3), [X], [0]),
    "unfold_strided_padded_dilated": (lambda P, x: F(P).unfold(
        x, [2, 3], strides=[2, 1], paddings=1, dilations=[1, 2]), [X], [0]),
    "affine_grid_aligned": (lambda P, t: F(P).affine_grid(
        t, [2, 3, 4, 5]), [_r(2, 2, 3)], [0]),
    "affine_grid_half": (lambda P, t: F(P).affine_grid(
        t, [2, 1, 3, 6], align_corners=False), [_r(2, 2, 3)], [0]),
})
_GRID = (_rs.uniform(-1.3, 1.3, (2, 4, 5, 2))).astype(np.float32)
for _mode in ("bilinear", "nearest"):
    for _pad in ("zeros", "border", "reflection"):
        for _align in (True, False):
            CASES[f"grid_sample_{_mode}_{_pad}_{int(_align)}"] = (
                (lambda m, p, a: lambda P, x, g: F(P).grid_sample(
                    x, g, mode=m, padding_mode=p, align_corners=a))(
                        _mode, _pad, _align),
                [X, _GRID], [0, 1] if _mode == "bilinear" else [0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_resample_and_its_grads(name):
    fn, inputs, grad_idx = CASES[name]
    (w, wd, wg), (g, gd, gg) = (_run(P, fn, inputs, grad_idx)
                                for P in (ref, paddle))
    assert gd == wd and g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=ATOL)


RESIZES = [
    ((2, 3, 16, 12), (2, 3, 5, 4)),        # shrink: antialiased
    ((2, 3, 5, 4), (2, 3, 16, 13)),        # grow
    ((2, 3, 16, 5), (2, 3, 7, 11)),        # shrink one axis, grow the other
    ((3, 10, 9), (3, 10, 4)),              # transforms.Resize's CHW
    ((1, 2, 7, 7), (1, 2, 3, 3)),          # adaptive_avg_pool2d's case
    ((1, 2, 6, 9, 4), (1, 2, 3, 9, 7)),    # 3-D, one axis unchanged
]


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("shapes", RESIZES, ids=lambda s: "x".join(
    map(str, s[0])) + "-" + "x".join(map(str, s[1])))
def test_image_resize_is_jax_image_resize(method, shapes):
    src, dst = shapes
    x = np.random.RandomState(len(src)).randn(*src).astype(np.float32)
    want = np.asarray(jax.image.resize(x, dst, method=method))
    got = image_resize(torch.from_numpy(x), dst, method).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_image_resize_is_not_f_interpolate():
    """Shrinking, jax.image.resize's triangle widens by the factor (an
    alternating +1/-1 row, the highest frequency, averages to about 0
    there and not through F.interpolate); growing, its cubic (a = -0.5)
    parts from torch's bicubic (a = -0.75)."""
    x = torch.tensor([1.0, -1.0] * 8).reshape(1, 1, 1, 16)
    got = image_resize(x, (1, 1, 1, 5), "linear")
    want = np.asarray(jax.image.resize(x.numpy(), (1, 1, 1, 5), "linear"))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert got.abs().max() < 0.25
    plain = torch.nn.functional.interpolate(x, size=(1, 5), mode="bilinear")
    assert plain.abs().max() > 0.5
    y = torch.from_numpy(_r(1, 1, 4, 4))
    cubic = image_resize(y, (1, 1, 9, 9), "cubic")
    np.testing.assert_allclose(
        cubic.numpy(), np.asarray(jax.image.resize(y.numpy(), (1, 1, 9, 9),
                                                   "cubic")), atol=1e-5)
    torch_cubic = torch.nn.functional.interpolate(y, size=(9, 9),
                                                  mode="bicubic")
    assert (cubic - torch_cubic).abs().max() > 1e-2


@pytest.mark.parametrize("P", [ref, paddle], ids=["ref", "port"])
class TestInterpolateScenarios:
    """tests/test_functional_gaps.py's TestInterpolateAlignCorners, each
    in both packages."""

    def test_bilinear_align_corners_exact(self, P):
        x = np.random.RandomState(13).randn(1, 1, 3, 3).astype(np.float32)
        out = F(P).interpolate(P.to_tensor(x), size=(5, 5), mode="bilinear",
                               align_corners=True).numpy()

        def interp1d(v, out_len):
            in_len = v.shape[0]
            pos = np.arange(out_len) * (in_len - 1) / (out_len - 1)
            i0 = np.clip(np.floor(pos), 0, in_len - 1).astype(int)
            i1 = np.clip(i0 + 1, 0, in_len - 1)
            w = (pos - i0).astype(np.float32)
            return v[i0] * (1 - w) + v[i1] * w
        want = x[0, 0]
        want = np.stack([interp1d(want[:, j], 5)
                         for j in range(want.shape[1])], 1)
        want = np.stack([interp1d(want[i, :], 5)
                         for i in range(want.shape[0])], 0)
        np.testing.assert_allclose(out[0, 0], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out[0, 0, 0, 0], x[0, 0, 0, 0],
                                   rtol=1e-6)
        np.testing.assert_allclose(out[0, 0, -1, -1], x[0, 0, -1, -1],
                                   rtol=1e-6)

    def test_align_corners_differs_from_half_pixel(self, P):
        x = P.to_tensor(np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4))
        a = F(P).interpolate(x, size=(7, 7), mode="bilinear",
                             align_corners=True).numpy()
        b = F(P).interpolate(x, size=(7, 7), mode="bilinear",
                             align_corners=False).numpy()
        assert not np.allclose(a, b)

    def test_bicubic_align_corners_preserves_corners(self, P):
        x = np.random.RandomState(14).randn(1, 2, 4, 4).astype(np.float32)
        out = F(P).interpolate(P.to_tensor(x), size=(9, 9), mode="bicubic",
                               align_corners=True).numpy()
        np.testing.assert_allclose(out[0, :, 0, 0], x[0, :, 0, 0],
                                   rtol=1e-5)
        np.testing.assert_allclose(out[0, :, -1, -1], x[0, :, -1, -1],
                                   rtol=1e-5)

    def test_grad_flows_through_align_corners(self, P):
        x = P.to_tensor(np.random.RandomState(15).randn(1, 1, 3, 3)
                        .astype(np.float32), stop_gradient=False)
        F(P).interpolate(x, size=(6, 6), mode="bilinear",
                         align_corners=True).sum().backward()
        assert x.grad is not None and np.isfinite(x.grad.numpy()).all()

    def test_nearest_indexing_matches_reference(self, P):
        x = P.to_tensor(np.asarray([[[10.0, 20.0]]], np.float32))
        out = F(P).interpolate(x, size=(3,), mode="nearest").numpy()
        assert list(out[0, 0]) == [10.0, 10.0, 20.0]
        x3 = P.to_tensor(np.asarray([[[1.0, 2.0, 3.0]]], np.float32))
        out2 = F(P).interpolate(x3, size=(5,), mode="nearest",
                                align_corners=True).numpy()
        assert list(out2[0, 0]) == [1.0, 2.0, 2.0, 3.0, 3.0]

    def test_align_corners_out_len_one_samples_origin(self, P):
        x = P.to_tensor(np.arange(9, dtype=np.float32).reshape(1, 1, 3, 3))
        out = F(P).interpolate(x, size=(1, 1), mode="bilinear",
                               align_corners=True).numpy()
        assert float(out[0, 0, 0, 0]) == 0.0


def test_size_as_a_tensor_and_unknown_mode():
    for P in (ref, paddle):
        out = F(P).interpolate(P.to_tensor(X),
                               size=P.to_tensor(np.array([3, 4])),
                               mode="bilinear")
        assert out.shape == [2, 3, 3, 4]
        with pytest.raises(KeyError):
            F(P).interpolate(P.to_tensor(X), size=(3, 4), mode="area")
        with pytest.raises(ValueError):
            F(P).grid_sample(P.to_tensor(X), P.to_tensor(_GRID),
                             padding_mode="wrap")


LAYERS = {
    "Upsample": (lambda P: P.nn.Upsample(scale_factor=2, mode="bicubic"), X),
    "Upsample_size": (lambda P: P.nn.Upsample(size=[4, 9],
                                              mode="bilinear"), X),
    "UpsamplingBilinear2D": (lambda P: P.nn.UpsamplingBilinear2D(
        size=[8, 8]), X),
    "UpsamplingNearest2D": (lambda P: P.nn.UpsamplingNearest2D(
        scale_factor=3), X),
    "PixelShuffle": (lambda P: P.nn.PixelShuffle(3), _r(1, 9, 2, 3)),
    "Unfold": (lambda P: P.nn.Unfold([2, 2], strides=2, paddings=1), X),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer(name):
    make, x_np = LAYERS[name]
    got = []
    for P in (ref, paddle):
        x = P.to_tensor(x_np, stop_gradient=False)
        out = make(P)(x)
        (out * P.to_tensor(_cot(2, out.shape))).sum().backward()
        got.append((out.numpy(), x.grad.numpy()))
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=GRAD_RTOL,
                               atol=ATOL)
