"""paddle_tpu_torch's ``Model`` static branch (after ``enable_static()``
the train, eval and predict steps run through ``jit.to_static``) against
the JAX package's static branch on the CPU: LeNet on carried weights
over ``FakeData``; ``fit`` step by step, ``evaluate``, ``predict``, the
accumulation window (``accumulate_grad_batches``, one step a window),
``train_batch(update=False)`` then an update, and ``prepare`` dropping
the compiled steps. Every static result is also held to the port's own
dygraph run.

Losses, evaluations and weights within rtol 1e-5 (atol 1e-6) of the
reference's (after the SGD steps of unnormalised FakeData, within
1e-5 of the largest weight), predictions within 1e-4 of the largest
logit; the port's static run gives its dygraph run's bits (on the CPU
both run eagerly).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _nets():
    ref.seed(0)
    rnet = ref.vision.models.LeNet()
    tnet = paddle.vision.models.LeNet()
    assert tnet.set_state_dict({k: np.asarray(v.numpy()) for k, v in
                                rnet.state_dict().items()}) == []
    return rnet, tnet


def _run(P, net, static, accumulate=1, samples=40):
    if static:
        P.enable_static()
    try:
        model = P.Model(net)
        model.prepare(P.optimizer.Adam(1e-3, parameters=net.parameters()),
                      P.nn.CrossEntropyLoss(), P.metric.Accuracy())
        data = P.vision.datasets.FakeData(num_samples=samples)
        seen = []

        class Rec(P.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                seen.append((step, logs["loss"], logs["acc"]))
        model.fit(data, batch_size=8, epochs=1, verbose=0, shuffle=False,
                  callbacks=[Rec()], accumulate_grad_batches=accumulate)
        ev = model.evaluate(data, batch_size=8, verbose=0)
        pred = model.predict(data, batch_size=8, stack_outputs=True,
                             verbose=0)[0]
        weights = {k: np.asarray(v.numpy())
                   for k, v in net.state_dict().items()}
        steps = dict(getattr(model, "_static_steps", {}))
    finally:
        P.disable_static()
    return seen, ev, pred, weights, steps


def _same(a, b, exact=False):
    (sa, ea, pa, wa, _), (sb, eb, pb, wb, _) = a, b
    assert [s for s, _, _ in sa] == [s for s, _, _ in sb]
    if exact:
        assert sa == sb and ea == eb
        np.testing.assert_array_equal(pa, pb)
        for k in wa:
            np.testing.assert_array_equal(wa[k], wb[k], err_msg=k)
        return
    np.testing.assert_allclose([v for _, v, _ in sa], [v for _, v, _ in sb],
                               rtol=RTOL, atol=1e-6)
    assert [m for _, _, m in sa] == [m for _, _, m in sb]
    assert ea["acc"] == eb["acc"]
    np.testing.assert_allclose(ea["loss"], eb["loss"], rtol=RTOL)
    np.testing.assert_allclose(pa, pb, rtol=0,
                               atol=1e-4 * np.abs(pb).max())
    for k in wb:
        np.testing.assert_allclose(wa[k], wb[k], rtol=RTOL, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("accumulate", [1, 2, 3])
def test_static_fit_evaluate_predict(accumulate):
    """fit (one step a batch, or one a window of 2 or 3 batches with a
    short tail window), evaluate and predict in static mode: the
    reference's static branch, and the port's own dygraph run."""
    rnet, tnet = _nets()
    want = _run(ref, rnet, True, accumulate)
    got = _run(paddle, tnet, True, accumulate)
    _same(got, want)
    modes = {"train": accumulate == 1, "train_window": accumulate > 1,
             "eval": True, "predict": True}
    assert sorted(got[4]) == sorted(m for m, on in modes.items() if on)
    assert all(s.entries for s in got[4].values())
    _, tnet2 = _nets()
    _same(got, _run(paddle, tnet2, False, accumulate), exact=True)


def test_static_train_batch_without_update_then_update():
    """train_batch(update=False) accumulates grads in a step of its own
    (the update flag is a constant of the signature); the next update
    applies them: the reference's static branch's numbers."""
    rnet, tnet = _nets()
    rs = np.random.RandomState(3)
    batches = [(rs.randn(4, 1, 28, 28).astype("float32"),
                rs.randint(0, 10, (4, 1)).astype("int64"))
               for _ in range(6)]
    runs = []
    for P, net in ((ref, rnet), (paddle, tnet)):
        P.enable_static()
        try:
            model = P.Model(net)
            model.prepare(P.optimizer.SGD(0.1, parameters=net.parameters()),
                          P.nn.CrossEntropyLoss())
            losses = [model.train_batch([x], [y], update=(i % 2 == 1))[0]
                      for i, (x, y) in enumerate(batches)]
        finally:
            P.disable_static()
        runs.append((losses, np.asarray(net.state_dict()["fc.2.weight"]
                                        .numpy())))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=RTOL)
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=0,
                               atol=RTOL * np.abs(runs[0][1]).max())


def test_prepare_drops_the_compiled_steps():
    _, net = _nets()
    paddle.enable_static()
    try:
        model = paddle.Model(net)
        model.prepare(paddle.optimizer.SGD(0.1, parameters=net.parameters()),
                      paddle.nn.CrossEntropyLoss())
        x = np.ones((2, 1, 28, 28), "float32")
        y = np.zeros((2, 1), "int64")
        for _ in range(3):
            model.train_batch([x], [y])
        first = model._static_steps["train"]
        model.prepare(paddle.optimizer.SGD(0.2, parameters=net.parameters()),
                      paddle.nn.CrossEntropyLoss())
        assert model._static_steps == {}
        model.train_batch([x], [y])
        assert model._static_steps["train"] is not first
    finally:
        paddle.disable_static()
