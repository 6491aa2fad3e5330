"""Static fluid programs in the port against the JAX reference, on the
CPU at small width: a fluid-1.x ResNet-style image classifier
(``conv2d`` without bias, ``batch_norm(act="relu")``, a bottleneck with
its projection, global ``pool2d``, ``fc``; ``softmax_with_cross_entropy``
+ ``mean``; top-1 ``accuracy``; Momentum 0.9 with ``L2Decay(1e-4)``) and
a ``StaticRNN`` language model (an LSTM cell written in fluid ops, SGD
with ``ClipGradByGlobalNorm``). Each is built by the same fluid code in
both packages; the reference's parameters are carried into the port's
program through ``fluid.convert``; 3 ``Executor.run`` steps give the
reference's losses, and after them the same parameters and batch-norm
moving statistics (the port's against the same fluid code run eagerly:
the reference's static batch norm freezes its moving statistics at the
first run's, a ROADMAP divergence). The reference's
``fluid.io.save_persistables`` file,
loaded by the port's ``fluid.io.load_persistables`` into a fresh
program (other parameter names), gives the reference's next loss.

Tolerances (f32): losses rtol 1e-5; parameters and moving statistics
after 3 steps rtol 1e-4, atol 1e-6.
"""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.fluid import convert

B, C, HW, CLASSES = 4, 3, 8, 5
V, H, T = 30, 16, 5


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    P.set_device("cpu")
    yield
    device_mod._current_place = None


def _resnet_net(pkg, L, img, label):
    """The classifier's fluid code; every parameter-making call named,
    so an eager run of it reuses the program's layers."""
    def conv_bn(x, ch, k, stride=1, act="relu", name=None):
        y = L.conv2d(x, ch, k, stride=stride, padding=(k - 1) // 2,
                     bias_attr=False, name=name)
        return L.batch_norm(y, act=act, name="bn_" + name)

    x = conv_bn(img, 8, 3, name="c1")
    y = conv_bn(x, 4, 1, name="b2a")
    y = conv_bn(y, 4, 3, stride=2, name="b2b")
    y = conv_bn(y, 16, 1, act=None, name="b2c")
    short = conv_bn(x, 16, 1, stride=2, act=None, name="b1")
    x = L.relu(L.elementwise_add(short, y))
    x = L.pool2d(x, pool_type="avg", global_pooling=True)
    logits = L.fc(x, CLASSES, name="fc")
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    return loss, L.accuracy(L.softmax(logits), label, k=1)


def _resnet(pkg):
    L = pkg.fluid.layers
    main = pkg.static.Program()
    with pkg.static.program_guard(main):
        img = pkg.fluid.data("img", [B, C, HW, HW], "float32")
        label = pkg.fluid.data("label", [B, 1], "int64")
        loss, acc = _resnet_net(pkg, L, img, label)
        opt = pkg.optimizer.Momentum(
            0.1, momentum=0.9,
            weight_decay=pkg.regularizer.L2Decay(1e-4))
        opt.minimize(loss)
    rs = np.random.RandomState(0)
    feeds = [{"img": rs.randn(B, C, HW, HW).astype(np.float32),
              "label": rs.randint(0, CLASSES, (B, 1)).astype(np.int64)}
             for _ in range(4)]
    return main, feeds, [loss, acc]


def _lm(pkg):
    L = pkg.fluid.layers
    F = pkg.nn.functional
    main = pkg.static.Program()
    with pkg.static.program_guard(main):
        ids = pkg.fluid.data("ids", [T, B], "int64")
        labels = pkg.fluid.data("labels", [T * B, 1], "int64")
        emb = L.embedding(ids, [V, H])
        rnn = L.StaticRNN()
        with rnn.step():
            x = rnn.step_input(emb)
            h_prev = rnn.memory(shape=[B, H], batch_ref=x)
            c_prev = rnn.memory(shape=[B, H], batch_ref=x)
            gates = L.fc(L.concat([x, h_prev], axis=1), 4 * H)
            i, f, g, o = L.split(gates, 4, dim=1)
            c = F.sigmoid(f) * c_prev + F.sigmoid(i) * pkg.tanh(g)
            h = F.sigmoid(o) * pkg.tanh(c)
            rnn.update_memory(h_prev, h)
            rnn.update_memory(c_prev, c)
            rnn.step_output(h)
        out = L.reshape(rnn(), [T * B, H])
        logits = L.fc(out, V)
        loss = L.mean(L.softmax_with_cross_entropy(logits, labels))
        opt = pkg.optimizer.SGD(
            1.0, grad_clip=pkg.nn.ClipGradByGlobalNorm(5.0))
        opt.minimize(loss)
    rs = np.random.RandomState(1)
    feeds = []
    for _ in range(4):
        seq = rs.randint(0, V, (T + 1, B))
        feeds.append({"ids": seq[:-1].astype(np.int64),
                      "labels": seq[1:].reshape(-1, 1).astype(np.int64)})
    return main, feeds, [loss]


def _eager_resnet(state, feeds, n=3):
    """The ResNet-style fluid code run eagerly in the port from
    ``state`` (the same layers by call site): 3 Momentum steps; the cache
    state after them."""
    L = P.fluid.layers
    L.clear_layer_cache()
    _resnet_eager_loss(feeds[0])          # make the layers
    convert.load_layer_cache(state)
    params = [p for lay in L._layer_cache.values() for p in lay.parameters()]
    opt = P.optimizer.Momentum(0.1, momentum=0.9, parameters=params,
                               weight_decay=P.regularizer.L2Decay(1e-4))
    for f in feeds[:n]:
        loss = _resnet_eager_loss(f)
        loss.backward()
        opt.step()
        opt.clear_grad()
    return convert.layer_cache_state(L._layer_cache)


def _resnet_eager_loss(feed):
    L = P.fluid.layers
    return _resnet_net(P, L, P.to_tensor(feed["img"]),
                       P.to_tensor(feed["label"]))[0]


def _exe(pkg):
    return pkg.static.Executor(P.CPUPlace() if pkg is P else None)


def _build(pkg, make, state=None):
    pkg.fluid.layers.clear_layer_cache()
    pkg.enable_static()
    try:
        main, feeds, fetch = make(pkg)
    finally:
        pkg.disable_static()
    if state is not None:
        convert.load_layer_cache(state)
    return main, feeds, fetch


def _steps(pkg, main, feeds, fetch, n=3):
    exe = _exe(pkg)
    return [exe.run(main, feed=f, fetch_list=fetch) for f in feeds[:n]]


@pytest.mark.parametrize("make", [_resnet, _lm], ids=["resnet", "lm"])
def test_three_steps_match_reference(make):
    R.seed(0)
    main_r, feeds, fetch_r = _build(R, make)
    state = convert.layer_cache_state(R.fluid.layers._layer_cache)
    main_p, _, fetch_p = _build(P, make, state)
    want = _steps(R, main_r, feeds, fetch_r)
    got = _steps(P, main_p, feeds, fetch_p)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=1e-5, atol=1e-7)
    ws = convert.layer_cache_state(R.fluid.layers._layer_cache)
    gs = convert.layer_cache_state(P.fluid.layers._layer_cache)
    assert list(ws) == list(gs)
    for key, arrays in ws.items():
        for name, arr in arrays.items():
            if name in ("_mean", "_variance"):
                continue
            np.testing.assert_allclose(gs[key][name], arr, rtol=1e-4,
                                       atol=1e-6, err_msg=f"{key} {name}")
    if make is _resnet:
        # the moving statistics: the reference's static program records
        # ``running * momentum`` as a value taken at build, so its
        # statistics stay at their first run's; the port records the
        # update as one op over the buffer and matches the same fluid
        # code run eagerly for 3 steps from the same weights
        eager = _eager_resnet(state, feeds)
        seen = 0
        for key, arrays in gs.items():
            for name in ("_mean", "_variance"):
                if name in arrays:
                    seen += 1
                    np.testing.assert_allclose(
                        arrays[name], eager[key][name], rtol=1e-4,
                        atol=1e-6, err_msg=f"{key} {name}")
        assert seen == 10      # 5 batch norms


def test_reference_persistables_load_into_the_port(tmp_path):
    R.seed(0)
    main_r, feeds, fetch_r = _build(R, _resnet)
    _steps(R, main_r, feeds, fetch_r, n=2)
    R.fluid.io.save_persistables(None, str(tmp_path), main_r)
    want = _exe(R).run(main_r, feed=feeds[2], fetch_list=fetch_r)
    P.seed(5)
    main_p, _, fetch_p = _build(P, _resnet)
    assert set(main_r.persist) - set(main_p.persist)   # other names
    P.fluid.io.load_persistables(None, str(tmp_path), main_p)
    got = _exe(P).run(main_p, feed=feeds[2], fetch_list=fetch_p)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=1e-5)
    # and the port's own file round trip, bit for bit
    P.fluid.io.save_persistables(None, str(tmp_path / "p"), main_p)
    again = _build(P, _resnet)[0]
    P.fluid.io.load_persistables(None, str(tmp_path / "p"), again)
    a = _exe(P).run(main_p, feed=feeds[3], fetch_list=fetch_p)
    b = _exe(P).run(again, feed=feeds[3], fetch_list=[
        again.vars[f.name] if f.name in again.vars else f for f in fetch_p])
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
