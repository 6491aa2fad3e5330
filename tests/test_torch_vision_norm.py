"""paddle_tpu_torch's batch, group and instance norms and
``local_response_norm`` against the JAX package's on the CPU: values and
grads of each op in each branch (training, inference, ``use_global_stats``,
NCHW / NHWC / NCL / NCDHW), the layers with the reference's weights
carried over, and the batch norm's running statistics over 3 training
steps and then the eval branch. The running update is the reference's,
``running * momentum + batch * (1 - momentum)`` with the *biased* batch
variance (``F.batch_norm`` takes ``1 - momentum`` and the unbiased one),
and it leaves no graph on the buffers. Under ``auto_cast`` O2 the
reference casts ``batch_norm_train``'s x, scale and bias to bf16 (its
name is not on the black list, where ``batch_norm`` is), under O1 it
casts nothing; so does the port.

Values at f32 ``allclose`` rtol 1e-5 / atol 1e-5 (means and variances
over a few hundred elements in another order), grads at rtol 1e-4 /
atol 1e-5, running statistics at rtol 1e-6 / atol 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod

RTOL = ATOL = 1e-5
GRAD_RTOL = 1e-4
STAT_TOL = 1e-6


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


def _r(*shape, scale=1.0, shift=0.0):
    return (_rs.randn(*shape) * scale + shift).astype(np.float32)


X = _r(4, 3, 5, 5, scale=2.0, shift=0.5)
X_NHWC = X.transpose(0, 2, 3, 1).copy()
X_NCL = _r(6, 3, 7)
X_5D = _r(2, 3, 3, 4, 2)
X_G = _r(2, 6, 4, 3)
C3 = _r(3, scale=0.2, shift=1.0)
B3 = _r(3)
C6 = _r(6, scale=0.2, shift=1.0)
B6 = _r(6)
RM = _r(3, scale=0.3)
RV = np.abs(_r(3)) + 0.5


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
    (out * P.to_tensor(_cot(0, out.shape))).sum().backward()
    return out.numpy(), out.dtype.name, [ts[i].grad.numpy()
                                         for i in grad_idx]


CASES = {
    "bn_train": (lambda P, x, w, b, m, v: F(P).batch_norm(
        x, m, v, w, b, training=True), [X, C3, B3, RM, RV], [0, 1, 2]),
    "bn_train_no_affine": (lambda P, x, m, v: F(P).batch_norm(
        x, m, v, training=True, epsilon=1e-3), [X, RM, RV], [0]),
    "bn_infer": (lambda P, x, w, b, m, v: F(P).batch_norm(
        x, m, v, w, b), [X, C3, B3, RM, RV], [0, 1, 2]),
    "bn_global_stats_in_training": (lambda P, x, w, b, m, v: F(P).batch_norm(
        x, m, v, w, b, training=True, use_global_stats=True),
        [X, C3, B3, RM, RV], [0, 1, 2]),
    "bn_train_nhwc": (lambda P, x, w, b, m, v: F(P).batch_norm(
        x, m, v, w, b, training=True, data_format="NHWC"),
        [X_NHWC, C3, B3, RM, RV], [0, 1, 2]),
    "bn_train_ncl": (lambda P, x, w, b, m, v: F(P).batch_norm(
        x, m, v, w, b, training=True, data_format="NCL"),
        [X_NCL, C3, B3, RM, RV], [0, 1, 2]),
    "bn_train_ncdhw": (lambda P, x, w, b, m, v: F(P).batch_norm(
        x, m, v, w, b, training=True, data_format="NCDHW"),
        [X_5D, C3, B3, RM, RV], [0, 1, 2]),
    "group_norm": (lambda P, x, w, b: F(P).group_norm(x, 3, w, b),
                   [X_G, C6, B6], [0, 1, 2]),
    "group_norm_one_group_eps": (lambda P, x: F(P).group_norm(
        x, 1, epsilon=1e-2, data_format="NHWC"), [X_G], [0]),
    "group_norm_ncl": (lambda P, x, w, b: F(P).group_norm(x, 3, w[:3], b[:3]),
                       [X_NCL, C3, B3], [0, 1, 2]),
    "instance_norm": (lambda P, x, w, b: F(P).instance_norm(
        x, weight=w, bias=b), [X, C3, B3], [0, 1, 2]),
    "instance_norm_unread_args": (lambda P, x, m, v: F(P).instance_norm(
        x, m, v, training=False, momentum=0.1, epsilon=1e-3,
        data_format="NHWC"), [X_NCL, RM, RV], [0]),
    "instance_norm_5d": (lambda P, x: F(P).instance_norm(x), [X_5D], [0]),
    "local_response_norm": (lambda P, x: F(P).local_response_norm(
        x, 3), [X_G], [0]),
    "local_response_norm_even": (lambda P, x: F(P).local_response_norm(
        x, 4, alpha=1e-2, beta=0.5, k=2.0), [X_G], [0]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_norm_and_its_grads(name):
    fn, inputs, grad_idx = CASES[name]
    (w, wd, wg), (g, gd, gg) = (_run(P, fn, inputs, grad_idx)
                                for P in (ref, paddle))
    assert gd == wd
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=ATOL)


@pytest.mark.parametrize("layer", ["BatchNorm", "BatchNorm1D",
                                   "BatchNorm2D", "BatchNorm3D",
                                   "SyncBatchNorm"])
def test_running_statistics_over_three_steps_then_eval(layer):
    """Three training steps on other batches: after each, ``_mean`` and
    ``_variance`` equal the reference's and the momentum rule with the
    biased variance by hand; the buffers hold no graph; then eval
    normalizes by them in both packages."""
    shape = {"BatchNorm1D": (5, 3, 6), "BatchNorm3D": (2, 3, 2, 3, 2)}.get(
        layer, (4, 3, 4, 4))
    rs = np.random.RandomState(11)
    batches = [(rs.randn(*shape) * (1 + i) + i).astype(np.float32)
               for i in range(4)]
    layers = [getattr(P.nn, layer)(3, momentum=0.8) for P in (ref, paddle)]
    sd = {k: v.numpy() for k, v in layers[0].state_dict().items()}
    assert list(sd) == ["weight", "bias", "_mean", "_variance"]
    assert list(layers[1].state_dict()) == list(sd)
    layers[1].set_state_dict(sd)
    mean, var = np.zeros(3), np.ones(3)
    axes = tuple(i for i in range(len(shape)) if i != 1)
    for step in range(3):
        got = []
        for P, lay in zip((ref, paddle), layers):
            x = P.to_tensor(batches[step], stop_gradient=False)
            out = lay(x)
            (out * P.to_tensor(_cot(step, out.shape))).sum().backward()
            got.append((out.numpy(), x.grad.numpy(), lay._mean.numpy(),
                        lay._variance.numpy()))
        mean = mean * 0.8 + batches[step].mean(axis=axes) * 0.2
        var = var * 0.8 + batches[step].var(axis=axes) * 0.2
        (wo, wg, wm, wv), (go, gg, gm, gv) = got
        np.testing.assert_allclose(go, wo, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gg, wg, rtol=GRAD_RTOL, atol=ATOL)
        np.testing.assert_allclose(gm, wm, rtol=STAT_TOL, atol=STAT_TOL)
        np.testing.assert_allclose(gv, wv, rtol=STAT_TOL, atol=STAT_TOL)
        np.testing.assert_allclose(gv, var, rtol=1e-5)
        np.testing.assert_allclose(gm, mean, rtol=1e-5, atol=1e-6)
        for buf in (layers[1]._mean, layers[1]._variance):
            assert not buf.value.requires_grad and buf.value.grad_fn is None
    outs = []
    for P, lay in zip((ref, paddle), layers):
        lay.eval()
        outs.append(lay(P.to_tensor(batches[3])).numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        outs[1].mean(axis=axes),
        ((batches[3] - mean.reshape([1, 3] + [1] * (len(shape) - 2)))
         / np.sqrt(var.reshape([1, 3] + [1] * (len(shape) - 2)) + 1e-5)
         ).mean(axis=axes), rtol=1e-4, atol=1e-5)


def test_a_second_backward_after_a_training_step():
    """The running update leaves no step's graph behind: two steps, each
    with its own backward, run as in the reference, and a buffer set
    from a numpy array keeps the update rule."""
    bn = paddle.nn.BatchNorm2D(3)
    for i in range(2):
        x = paddle.to_tensor(X * (i + 1), stop_gradient=False)
        bn(x).sum().backward()
    assert bn.weight.grad is not None
    bn.set_state_dict({"_mean": np.ones(3, np.float32)})
    bn(paddle.to_tensor(X))
    np.testing.assert_allclose(bn._mean.numpy(),
                               0.9 + 0.1 * X.mean(axis=(0, 2, 3)),
                               rtol=1e-6)


NORM_LAYERS = {
    "GroupNorm": (lambda P: P.nn.GroupNorm(3, 6), X_G),
    "GroupNorm_no_affine": (lambda P: P.nn.GroupNorm(
        2, 6, weight_attr=False, bias_attr=False), X_G),
    "InstanceNorm2D": (lambda P: P.nn.InstanceNorm2D(3), X),
    "InstanceNorm1D": (lambda P: P.nn.InstanceNorm1D(3), X_NCL),
    "InstanceNorm3D": (lambda P: P.nn.InstanceNorm3D(3), X_5D),
    "LocalResponseNorm": (lambda P: P.nn.LocalResponseNorm(5), X_G),
    "BatchNorm2D_eval": (lambda P: P.nn.BatchNorm2D(3).eval(), X),
    "BatchNorm2D_nhwc": (lambda P: P.nn.BatchNorm2D(
        3, data_format="NHWC"), X_NHWC),
    "BatchNorm2D_global_stats": (lambda P: P.nn.BatchNorm2D(
        3, use_global_stats=True), X),
}


@pytest.mark.parametrize("name", sorted(NORM_LAYERS))
def test_norm_layer_carries_the_reference_weights(name):
    make, x_np = NORM_LAYERS[name]
    layers = [make(P) for P in (ref, paddle)]
    sd = {k: v.numpy() + 0.1 * np.arange(v.numpy().size).reshape(
        v.shape).astype(np.float32) for k, v in layers[0].state_dict().items()}
    assert list(sd) == list(layers[1].state_dict())
    for lay in layers:
        assert lay.set_state_dict(sd) == []
    got = []
    for P, lay in zip((ref, paddle), layers):
        x = P.to_tensor(x_np, stop_gradient=False)
        out = lay(x)
        (out * P.to_tensor(_cot(1, out.shape))).sum().backward()
        got.append((out.numpy(), x.grad.numpy()))
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=GRAD_RTOL,
                               atol=ATOL)


def test_convert_sync_batchnorm_returns_the_layer():
    bn = paddle.nn.SyncBatchNorm(3)
    assert paddle.nn.SyncBatchNorm.convert_sync_batchnorm(bn) is bn


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_dtypes_under_auto_cast(level, training):
    """O2 casts batch_norm_train's (and batch_norm_infer's) float inputs
    to bf16, so the output is bf16; O1 casts none of them and the f32
    scale promotes a bf16 x to f32; the running statistics stay f32 and
    take the rule above in both packages."""
    got = []
    for P in (ref, paddle):
        bn = P.nn.BatchNorm2D(3)
        if not training:
            bn.eval()
        x = P.cast(P.to_tensor(X), "bfloat16")
        with P.amp.auto_cast(level=level, dtype="bfloat16"):
            out = bn(x)
            out32 = bn(P.to_tensor(X))
        got.append((out.dtype.name, out32.dtype.name, bn._mean.dtype.name,
                    np.asarray(P.cast(out, "float32").numpy()),
                    bn._mean.numpy(), bn._variance.numpy()))
    (wd, wd32, wmd, wo, wm, wv), (gd, gd32, gmd, go, gm, gv) = got
    assert (gd, gd32, gmd) == (wd, wd32, wmd)
    assert gd == ("bfloat16" if level == "O2" else "float32")
    assert gmd == "float32"
    # bf16 results: a bf16 ulp of the largest output
    np.testing.assert_allclose(go, wo, atol=2 ** -7 * np.abs(wo).max())
    np.testing.assert_allclose(gm, wm, rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(gv, wv, rtol=1e-2, atol=1e-3)
