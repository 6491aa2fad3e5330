"""The port's ``incubate`` optimizers and softmaxes
(``paddle_tpu_torch/incubate/__init__.py``) against the reference's on
the CPU, with ``FLAGS_lazy_eager`` on and off in both packages (oracles:
``tests/test_api_round2.py:279-300``).

* ``LookAhead`` (k = 2 and 5) over SGD on a small MLP of the Paddle
  surface, the same weights and batches in both packages, 7 steps: the
  losses, the weights and the slow copies at atol 1e-6 (f32, SGD's
  update is linear in the grads, which differ by their summation order);
  the port's lazy run equals its immediate run bit for bit, so the k-th
  step's interpolation is never replayed from another step's graph.
* ``ModelAverage``: ``apply()`` gives the reference's average (and the
  numpy mean of the snapshots, rtol 1e-6); ``restore()`` gives the
  weights back bit for bit; ``apply(need_restore=False)`` keeps the
  average.
* ``softmax_mask_fuse`` and ``softmax_mask_fuse_upper_triangle`` at
  [2, 3, 8, 8] f32 against the reference's at rtol 1e-6, atol 1e-7;
  the causal one masks with -1e9 (a row of -inf scores stays finite).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu.core import lazy as ref_lazy
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.core import lazy

ATOL = 1e-6


@pytest.fixture(params=[True, False], ids=["lazy", "immediate"])
def lazy_flag(request):
    prev = {P: P.get_flags(["FLAGS_lazy_eager"])["FLAGS_lazy_eager"]
            for P in (ref, paddle)}
    for P in (ref, paddle):
        P.set_flags({"FLAGS_lazy_eager": request.param})
    paddle.set_device("cpu")
    yield request.param
    lazy.flush()
    ref_lazy.flush()
    for P, v in prev.items():
        P.set_flags({"FLAGS_lazy_eager": v})
    device_mod._current_place = None


def _state():
    rs = np.random.RandomState(5)
    return {"0.weight": rs.randn(16, 32).astype(np.float32) * 0.3,
            "0.bias": rs.randn(32).astype(np.float32) * 0.1,
            "2.weight": rs.randn(32, 4).astype(np.float32) * 0.3,
            "2.bias": rs.randn(4).astype(np.float32) * 0.1}


def _mlp(P):
    net = P.nn.Sequential(P.nn.Linear(16, 32), P.nn.ReLU(),
                          P.nn.Linear(32, 4))
    assert net.set_state_dict(_state()) == []
    return net


def _batch(step):
    rs = np.random.RandomState(100 + step)
    return rs.randn(8, 16).astype(np.float32), \
        rs.randn(8, 4).astype(np.float32)


def _weights(net):
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


def _lookahead_run(P, k, steps=7):
    net = _mlp(P)
    la = P.incubate.LookAhead(
        P.optimizer.SGD(0.1, parameters=net.parameters()), alpha=0.5, k=k)
    losses = []
    for step in range(steps):
        x, y = _batch(step)
        loss = ((net(P.to_tensor(x)) - P.to_tensor(y)) ** 2).mean()
        loss.backward()
        la.step()
        la.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, _weights(net), [np.asarray(s) if P is ref
                                   else s.cpu().numpy() for s in la._slow]


@pytest.mark.parametrize("k", [2, 5])
def test_lookahead_matches_reference(lazy_flag, k):
    jl, jw, js = _lookahead_run(ref, k)
    tl, tw, ts = _lookahead_run(paddle, k)
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=ATOL)
    for name in jw:
        np.testing.assert_allclose(tw[name], jw[name], rtol=0, atol=ATOL,
                                   err_msg=name)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    # lazily, the port gives its immediate run's bits
    if lazy_flag:
        paddle.set_flags({"FLAGS_lazy_eager": False})
        il, iw, _ = _lookahead_run(paddle, k)
        assert il == tl
        for name in tw:
            np.testing.assert_array_equal(iw[name], tw[name])


def test_lookahead_forwards_to_inner(lazy_flag):
    net = _mlp(paddle)
    inner = paddle.optimizer.SGD(0.1, parameters=net.parameters())
    la = paddle.incubate.LookAhead(inner, alpha=0.5, k=2)
    assert la.inner_optimizer is inner
    assert la.get_lr() == inner.get_lr()
    x, y = _batch(0)
    loss = ((net(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
    assert la.minimize(loss) == (None, None)
    assert la._slow is not None and la._step == 1
    la.clear_grad()
    assert all(p.grad is None for p in net.parameters())


def _average_run(P):
    net = _mlp(P)
    opt = P.optimizer.SGD(0.1, parameters=net.parameters())
    ma = P.incubate.ModelAverage(0.15, parameters=net.parameters())
    snaps = []
    for step in range(3):
        x, y = _batch(step)
        loss = ((net(P.to_tensor(x)) - P.to_tensor(y)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        ma.step()
        snaps.append(_weights(net))
    return net, ma, snaps


def test_model_average_apply_restore(lazy_flag):
    jnet, jma, _ = _average_run(ref)
    tnet, tma, snaps = _average_run(paddle)
    before = _weights(tnet)
    jma.apply()
    tma.apply()
    got, want = _weights(tnet), _weights(jnet)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=ATOL,
                                   err_msg=name)
        mean = np.mean([s[name] for s in snaps], axis=0)
        np.testing.assert_allclose(got[name], mean, rtol=1e-6, atol=1e-7)
    tma.restore()
    for name, v in _weights(tnet).items():
        np.testing.assert_array_equal(v, before[name])
    tma.apply(need_restore=False)
    tma.restore()       # nothing to restore
    for name, v in _weights(tnet).items():
        np.testing.assert_array_equal(v, got[name])
    with pytest.raises(ValueError):
        paddle.incubate.ModelAverage(0.15)


def test_model_average_constant_is_itself(lazy_flag):
    """The reference's oracle: the average of unchanged weights is the
    weights."""
    net = _mlp(paddle)
    ma = paddle.incubate.ModelAverage(parameters=net.parameters())
    w = _weights(net)
    for _ in range(3):
        ma.step()
    ma.apply()
    for name, v in _weights(net).items():
        np.testing.assert_allclose(v, w[name], rtol=1e-6)
    ma.restore()


def test_softmax_mask_fuse_matches_reference(lazy_flag):
    rs = np.random.RandomState(7)
    x = rs.randn(2, 3, 8, 8).astype(np.float32) * 3
    mask = np.where(rs.rand(2, 1, 8, 8) < 0.3, -1e4, 0.0).astype(np.float32)
    want = np.asarray(ref.incubate.softmax_mask_fuse(
        ref.to_tensor(x), ref.to_tensor(mask)).numpy())
    got = paddle.incubate.softmax_mask_fuse(paddle.to_tensor(x),
                                            paddle.to_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    want = np.asarray(ref.incubate.softmax_mask_fuse_upper_triangle(
        ref.to_tensor(x)).numpy())
    got = paddle.incubate.softmax_mask_fuse_upper_triangle(
        paddle.to_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(np.triu(got[0, 0], 1) == 0)
    # the reference's oracle, and -1e9 rather than -inf: a row whose
    # scores are all -inf but the first stays finite
    z = paddle.incubate.softmax_mask_fuse_upper_triangle(
        paddle.to_tensor(np.zeros((1, 1, 4, 4), np.float32))).numpy()
    np.testing.assert_allclose(z[0, 0, 0], [1, 0, 0, 0], atol=1e-6)
    inf = np.full((1, 1, 3, 3), -np.inf, np.float32)
    inf[..., 0] = 0.0
    out = paddle.incubate.softmax_mask_fuse_upper_triangle(
        paddle.to_tensor(inf)).numpy()
    assert np.isfinite(out).all()
