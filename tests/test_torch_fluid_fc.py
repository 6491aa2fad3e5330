"""``fluid.layers.fc``'s parameter reuse in the port
(``tests/test_fluid_fc.py``'s four cases) against the reference: any
registered ``act=``; parameters stable across ``jit.to_static``'s
phases (eager, record, then the compiled calls) while distinct call
sites get distinct parameters; a name-shared fc trained under
``to_static`` from the reference's weights (carried by
``fluid.convert``) gives the reference's losses; keying on the
``nn.Layer`` instance. Plus the lazy executor: an fc made inside a lazy
segment (``FLAGS_lazy_eager``, on by default) keys on the user's frames
only, so a training loop's later flushes reuse it.

Tolerance: the losses rtol 1e-5 (f32, SGD on a 4 x 8 batch).
"""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.core import lazy
from paddle_tpu_torch.fluid import convert

PACKAGES = (R, P)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    P.set_device("cpu")
    yield
    device_mod._current_place = None


@pytest.mark.parametrize("pkg", PACKAGES, ids=["ref", "port"])
def test_fluid_fc_any_registered_act(pkg):
    x = pkg.to_tensor(np.ones((2, 4), "float32"))
    out = pkg.fluid.layers.fc(x, size=3, act="sigmoid")
    assert ((out.numpy() > 0) & (out.numpy() < 1)).all()
    with pytest.raises(ValueError):
        pkg.fluid.layers.fc(x, size=3, act="not_an_act")


@pytest.mark.parametrize("pkg", PACKAGES, ids=["ref", "port"])
def test_fluid_fc_stable_across_to_static_phases(pkg):
    fluid = pkg.fluid
    fluid.layers.clear_layer_cache()
    x = pkg.to_tensor(np.random.RandomState(0).randn(4, 8).astype("float32"))

    @pkg.jit.to_static
    def f(inp):
        return fluid.layers.fc(inp, size=6)

    r1, r2, r3 = f(x).numpy(), f(x).numpy(), f(x).numpy()
    np.testing.assert_allclose(r1, r2)
    np.testing.assert_allclose(r2, r3)
    assert len(fluid.layers._layer_cache) == 1

    @pkg.jit.to_static
    def two(inp):
        a = fluid.layers.fc(inp, size=6)
        b = fluid.layers.fc(inp, size=6)
        return a, b

    a, b = two(x)
    assert not np.allclose(a.numpy(), b.numpy())


def _train(pkg, state=None):
    fluid = pkg.fluid
    fluid.layers.clear_layer_cache()
    x = pkg.to_tensor(np.random.RandomState(1).randn(4, 8).astype("float32"))
    lbl = pkg.to_tensor(np.zeros((4, 6), "float32"))
    fluid.layers.fc(x, size=6, name="ts_fc_m")
    if state is not None:
        convert.load_layer_cache(state)
    made = convert.layer_cache_state(fluid.layers._layer_cache)
    layer = [v for k, v in fluid.layers._layer_cache.items()
             if k[:2] == ("name", "ts_fc_m")][0]
    opt = pkg.optimizer.SGD(0.5, parameters=list(layer.parameters()))

    @pkg.jit.to_static
    def train(inp):
        out = fluid.layers.fc(inp, size=6, name="ts_fc_m")
        loss = ((out - lbl) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    losses = [float(train(x).numpy()) for _ in range(6)]
    assert len(fluid.layers._layer_cache) == 1
    return made, losses


def test_fluid_fc_trains_under_to_static():
    state, want = _train(R)
    _, got = _train(P, state)
    assert got[-1] < got[0], got
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("pkg", PACKAGES, ids=["ref", "port"])
def test_fluid_fc_instance_keying(pkg):
    fluid = pkg.fluid
    x = pkg.to_tensor(np.random.RandomState(2).randn(4, 8).astype("float32"))

    class Block(pkg.nn.Layer):
        def forward(self, inp):
            return fluid.layers.fc(inp, size=6)

    a, b = Block(), Block()
    ra, rb = a(x).numpy(), b(x).numpy()  # one line: instances differ
    assert not np.allclose(ra, rb)
    ra2 = a(x).numpy()                   # new line: instance reuses
    np.testing.assert_allclose(ra, ra2)


def test_fluid_fc_in_lazy_segments_reuses_its_parameters():
    """An fc made inside a lazy segment: every step's flush (at
    clear_grad) runs the nodes the step deferred, and the layer's key
    holds no frame of core/lazy.py or jit/, so the three steps train one
    layer."""
    fluid = P.fluid
    assert P.get_flags("FLAGS_lazy_eager")["FLAGS_lazy_eager"]
    fluid.layers.clear_layer_cache()
    x = P.to_tensor(np.random.RandomState(1).randn(4, 8).astype("float32"))
    lbl = P.to_tensor(np.zeros((4, 6), "float32"))
    opt, losses = None, []
    before = lazy.flushes[0]
    for _ in range(3):
        out = fluid.layers.fc(x, size=6)
        loss = ((out - lbl) ** 2).mean()
        loss.backward()
        if opt is None:
            layer, = fluid.layers._layer_cache.values()
            opt = P.optimizer.SGD(0.5, parameters=layer.parameters())
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    assert len(fluid.layers._layer_cache) == 1
    assert losses[2] < losses[1] < losses[0], losses
    assert "cpu" in lazy.forms_since(before)
