"""paddle_tpu_torch's ``jit.to_static`` against the JAX package's on the
CPU (``tests/test_to_static.py``'s cases on the same seeded inputs and
carried weights), where the port records the step and then calls it
eagerly (a CUDA graph is captured only on the card,
``tests/test_torch_to_static_cuda.py``):

* forward parity, the eager-vs-compiled train step, the per-shape
  signature cache, scalar keys, nested structures, the batch norm's
  statistics moving, an LR schedule stepped between compiled calls (the
  trajectory and the weights against the reference's), ``not_to_static``
  and ``ProgramTranslator``, and model scale (a GPT and resnet18, a GPT
  trained through the compiled step);
* the port's own rules: record's refusal of a rebinding, a nested
  ``to_static`` inlining, ``warmup=0``, the learning rate held as a 0-d
  f32 tensor on the parameters' device, and the state a capture refuses
  to bake (``set_lr``, a scheduler's step, an optimizer's first state, a
  ``GradScaler``); ``jit``'s and ``static``'s surface.

Losses and outputs within rtol 1e-5 (atol 1e-6 where they cross zero);
the model-scale forwards within the reference's own tolerances of its
eager output (rtol 2e-4 GPT, 2e-3 resnet18); weights after the schedule
within 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from _torch_port import jax_gpt, torch_twin
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.core import trace as trace_mod
from paddle_tpu_torch.jit import ToStaticError

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _carry(r, t):
    assert t.set_state_dict({k: np.asarray(v.numpy())
                             for k, v in r.state_dict().items()}) == []


def _mlp_pair(act="Tanh"):
    ref.seed(3)
    nets = [P.nn.Sequential(P.nn.Linear(4, 8), getattr(P.nn, act)(),
                            P.nn.Linear(8, 2)) for P in (ref, paddle)]
    _carry(*nets)
    return nets


def _np(t):
    return np.asarray(t.numpy())


def test_forward_parity():
    x_np = np.random.RandomState(0).randn(3, 4).astype("float32")
    outs = []
    for P, net in zip((ref, paddle), _mlp_pair()):
        x = P.to_tensor(x_np)

        def fwd(x, net=net):
            return net(x)
        fwd = P.jit.to_static(fwd)
        for _ in range(3):
            out = fwd(x)
        outs.append(_np(out))
        assert any(e["record"] is not None if P is paddle else e["compiled"]
                   for e in fwd.entries.values())
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=1e-6)


def _train_losses(P, net, x_np, y_np, compiled, steps=6):
    opt = P.optimizer.Adam(1e-2, parameters=net.parameters())
    loss_fn = P.nn.CrossEntropyLoss()

    def step(x, y):
        loss = loss_fn(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    fn = P.jit.to_static(step) if compiled else step
    return [float(_np(fn(P.to_tensor(x_np), P.to_tensor(y_np))))
            for _ in range(steps)]


@pytest.mark.parametrize("compiled", [False, True])
def test_train_step_parity_eager_vs_compiled(compiled):
    """The port's step, eager and through to_static, against the
    reference's compiled step on the same weights and batch."""
    rs = np.random.RandomState(1)
    x_np = rs.randn(8, 4).astype("float32")
    y_np = rs.randint(0, 2, (8,)).astype("int64")
    rnet, tnet = _mlp_pair("ReLU")
    want = _train_losses(ref, rnet, x_np, y_np, True)
    got = _train_losses(paddle, tnet, x_np, y_np, compiled)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[-1] < got[0]


def test_signature_cache_per_shape():
    outs = []
    for P in (ref, paddle):
        def f(x):
            return x * 2
        f = P.jit.to_static(f)
        a = f(P.ones([2]))
        b = f(P.ones([3]))
        assert a.shape == [2] and b.shape == [3]
        assert len(f.entries) == 2
        outs.append((_np(a), _np(b)))
    for (a, b), (c, d) in zip([outs[0]], [outs[1]]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_new_shape_of_a_recorded_structure_skips_eager_and_record():
    """As the reference's ``_same_struct_compiled``: once a structure is
    recorded, a new shape reuses the record (no eager or record call of
    its own); a new device or grad mode does not."""
    def f(x):
        return x * 2
    f = paddle.jit.to_static(f)
    for _ in range(2):
        f(paddle.ones([2]))
    out = f(paddle.ones([3]))
    np.testing.assert_array_equal(_np(out), [2, 2, 2])
    entries = list(f.entries.values())
    assert [e["calls"] for e in entries] == [2, 0]
    assert entries[1]["record"] is entries[0]["record"]
    with paddle.no_grad():
        f(paddle.ones([3]))
    assert list(f.entries.values())[2]["record"] is None


def test_scalar_args_are_cache_keys():
    for P in (ref, paddle):
        def f(x, k):
            return x * k
        f = P.jit.to_static(f)
        assert float(_np(f(P.ones([1]), 2.0))) == 2.0
        assert float(_np(f(P.ones([1]), 3.0))) == 3.0
        assert len(f.entries) == 2


def test_nested_structures():
    outs = []
    for P in (ref, paddle):
        def f(d):
            return {"out": d["a"] + d["b"][0], "pair": (d["a"] * 3, 7)}
        f = P.jit.to_static(f)
        for _ in range(3):
            out = f({"a": P.ones([2]), "b": [P.ones([2])]})
        assert out["pair"][1] == 7
        outs.append((_np(out["out"]), _np(out["pair"][0])))
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(outs[1][0], [2, 2])


def test_rng_state_threads_through_compiled_step():
    """Dropout inside the compiled step draws a new mask on every call in
    both packages (the reference threads its RNG state through the
    compiled program; the port's generator advances), each keeping about
    half."""
    for P in (ref, paddle):
        P.seed(11)

        def f(x):
            return P.nn.functional.dropout(x, p=0.5, training=True)
        f = P.jit.to_static(f)
        x = P.ones([256])
        outs = [_np(f(x)) for _ in range(5)]
        for i in range(5):
            assert 0.3 < (outs[i] != 0).mean() < 0.7
            for j in range(i):
                assert not np.array_equal(outs[i], outs[j])


def test_batchnorm_stats_update_in_compiled_step():
    x_np = np.random.RandomState(2).randn(4, 2, 3, 3).astype("float32") + 5
    means = []
    for P in (ref, paddle):
        bn = P.nn.BatchNorm2D(2)
        bn.train()

        def f(x, bn=bn):
            return bn(x)
        f = P.jit.to_static(f)
        seen = []
        for _ in range(5):
            f(P.to_tensor(x_np))
            seen.append(_np(bn._mean).copy())
        assert not np.allclose(seen[3], seen[4])   # still moving
        assert seen[4].mean() > seen[0].mean()     # toward ~5
        means.append(np.stack(seen))
    np.testing.assert_allclose(means[1], means[0], rtol=RTOL)


def test_lr_schedule_across_compiled_calls():
    """A StepDecay stepped outside the compiled step: the port's losses,
    rates and weights follow the reference's trajectory, with one
    entry."""
    x_np = np.random.RandomState(4).randn(2, 2).astype("float32")
    runs = []
    ref.seed(5)
    nets = [P.nn.Linear(2, 2) for P in (ref, paddle)]
    _carry(*nets)
    for P, net in zip((ref, paddle), nets):
        sched = P.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
        opt = P.optimizer.SGD(sched, parameters=net.parameters())
        loss_fn = P.nn.MSELoss()

        def step(x, y):
            loss = loss_fn(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        step = P.jit.to_static(step)
        losses, lrs = [], []
        for _ in range(5):
            losses.append(float(_np(step(P.to_tensor(x_np),
                                         P.zeros([2, 2])))))
            sched.step()
            lrs.append(opt.get_lr())
        assert len(step.entries) == 1
        assert opt.get_lr() == pytest.approx(0.1 * 0.5 ** 5)
        runs.append((losses, lrs, _np(net.weight), _np(net.bias)))
    (rl, rlr, rw, rb), (tl, tlr, tw, tb) = runs
    np.testing.assert_allclose(tl, rl, rtol=RTOL)
    np.testing.assert_allclose(tlr, rlr, rtol=1e-7)
    np.testing.assert_allclose(tw, rw, atol=1e-6)
    np.testing.assert_allclose(tb, rb, atol=1e-6)


def test_not_to_static_and_program_translator():
    for P in (ref, paddle):
        assert P.jit.not_to_static(abs) is abs
        pt = P.jit.ProgramTranslator.get_instance()
        pt.enable(False)
        try:
            def f(x):
                return x + 1
            f = P.jit.to_static(f)
            for _ in range(3):
                out = f(P.ones([2]))
            if P is paddle:     # the port's switch runs everything eagerly
                assert len(f.entries) == 0
            np.testing.assert_array_equal(_np(out), [2, 2])
        finally:
            pt.enable(True)
        assert pt.enable_to_static
        assert P.jit.set_code_level(100) is None
        assert P.jit.set_verbosity(0) is None


def test_model_scale_parity_gpt_and_resnet():
    """A GPT's and resnet18's compiled forwards against the reference's
    on carried weights."""
    jm = jax_gpt()
    tm = torch_twin(jm)
    ids_np = np.random.RandomState(0).randint(0, 97, (2, 16)).astype(
        "int64")
    def rfwd(ids):
        return jm(ids)

    def tfwd(ids):
        return tm(ids)
    rfwd, tfwd = ref.jit.to_static(rfwd), paddle.jit.to_static(tfwd)
    for _ in range(3):
        want = _np(rfwd(ref.to_tensor(ids_np)))
        got = tfwd(torch.from_numpy(ids_np)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)

    ref.seed(0)
    rnet = ref.vision.models.resnet18(num_classes=10)
    tnet = paddle.vision.models.resnet18(num_classes=10)
    _carry(rnet, tnet)
    rnet.eval()
    tnet.eval()
    x_np = np.random.RandomState(1).randn(2, 3, 32, 32).astype("float32")
    def rfwd(x):
        return rnet(x)

    def tfwd(x):
        return tnet(x)
    rfwd, tfwd = ref.jit.to_static(rfwd), paddle.jit.to_static(tfwd)
    for _ in range(3):
        want = _np(rfwd(ref.to_tensor(x_np)))
        got = _np(tfwd(paddle.to_tensor(x_np)))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_gpt_train_parity_eager_vs_compiled():
    """The tiny GPT trained 6 AdamW steps through the compiled step in
    both packages from carried weights: the losses agree through the
    eager -> record -> compiled transitions, and fall."""
    jm = jax_gpt(seed=42)
    tm = torch_twin(jm).train()
    jm.train()
    ids_np = np.random.RandomState(7).randint(0, 97, (4, 16)).astype(
        "int64")
    runs = []
    for P, model, params, wrap in (
            (ref, jm, jm.parameters(), ref.to_tensor),
            (paddle, tm, tm.named_parameters(), torch.from_numpy)):
        opt = P.optimizer.AdamW(1e-3, parameters=params)

        def step(ids, labels, model=model, opt=opt):
            loss = model(ids, labels=labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        fn = P.jit.to_static(step)
        runs.append([float(np.asarray(
            fn(wrap(ids_np), wrap(ids_np)).numpy() if P is ref
            else fn(wrap(ids_np), wrap(ids_np)).detach()))
            for _ in range(6)])
    np.testing.assert_allclose(runs[1], runs[0], rtol=RTOL)
    assert runs[1][-1] < runs[1][0]


@pytest.mark.parametrize("where", ["stop_gradient", "reshape_"])
def test_record_refuses_a_rebinding(where):
    """A step that replaces a pre-existing Tensor's storage (not a write
    into it) is refused at record, naming the Tensor; the same rebinding
    of a Tensor the step makes itself is fine."""
    w = paddle.ones([4])
    w.stop_gradient = False
    h = w * 2
    h.name = "held"
    v = paddle.ones([2, 2])
    v.name = "held"

    def bad(x):
        if where == "stop_gradient":
            h.stop_gradient = True
        else:
            paddle.reshape_(v, [4])
        return x + 1

    def fine(x):
        y = x * w
        y.stop_gradient = True
        z = paddle.ones([2, 2])
        paddle.reshape_(z, [4])
        return y + z
    f = paddle.jit.to_static(bad, warmup=0)
    with pytest.raises(ToStaticError, match="rebinds.*'held'"):
        f(paddle.ones([4]))                 # call 1: record
    g = paddle.jit.to_static(fine)
    for _ in range(3):
        out = g(paddle.ones([4]))
    np.testing.assert_array_equal(_np(out), [2, 2, 2, 2])


def test_nested_to_static_inlines_and_warmup_zero():
    inner = paddle.jit.to_static(lambda x: x * 3)
    outer = paddle.jit.to_static(lambda x: inner(x) + 1, warmup=0)
    out = outer(paddle.ones([2]))
    np.testing.assert_array_equal(_np(out), [4, 4])
    # warmup=0: call 1 recorded; the inner function ran inlined
    assert [e["record"] is not None for e in outer.entries.values()] == \
        [True]
    assert len(inner.entries) == 0


def test_learning_rate_is_a_device_tensor():
    net = paddle.nn.Linear(2, 2)
    sched = paddle.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    opt = paddle.optimizer.SGD(sched, parameters=net.parameters())
    t = opt._lr_of(net.weight.value)
    assert t.shape == () and t.dtype == torch.float32
    assert t.device == net.weight.value.device
    sched.step()
    assert opt._lr_of(net.weight.value) is t        # filled in place
    assert float(t) == opt.get_lr() == np.float32(0.05)


def test_capture_refuses_host_state():
    """Under a capture, state the port keeps on the host would change
    once and never on a replay: set_lr, a scheduler's step, an
    optimizer's first state and an enabled GradScaler raise."""
    net = paddle.nn.Linear(2, 2)
    sched = paddle.optimizer.lr.StepDecay(0.1, step_size=1)
    opt = paddle.optimizer.Adam(sched, parameters=net.parameters())
    scaler = paddle.amp.GradScaler()
    loss = net(paddle.ones([1, 2])).sum()
    loss.backward()
    cases = {"set_lr": lambda: opt.set_lr(0.5),
             "LRScheduler": sched.step,
             "'moment1' state": opt.step,
             "GradScaler": lambda: scaler.scale(loss)}
    for word, call in cases.items():
        with trace_mod.trace_guard(trace_mod.TraceContext("capture")):
            with pytest.raises(ToStaticError, match=word):
                call()
    opt.step()      # outside a capture: the state comes into being
    with trace_mod.trace_guard(trace_mod.TraceContext("capture")):
        opt.step()  # and a later step makes none


def test_jit_and_static_surface():
    spec = paddle.static.InputSpec([None, 4], "float32", "x")
    assert spec.shape == (None, 4) and spec.name == "x"
    assert paddle.static.InputSpec.from_tensor(paddle.ones([2, 3])).shape \
        == (2, 3)
    assert spec.batch(8).shape == (8, None, 4)
    assert spec.unbatch().shape == (None, 4)
    assert paddle.in_dynamic_mode()
    paddle.enable_static()
    try:
        assert not paddle.in_dynamic_mode()
    finally:
        paddle.disable_static()
    assert paddle.in_dynamic_mode()
    net = paddle.nn.Linear(3, 2)
    out, traced = paddle.jit.TracedLayer.trace(net, [paddle.ones([1, 3])])
    np.testing.assert_allclose(_np(traced(paddle.ones([1, 3]))), _np(out))
    with pytest.raises(NotImplementedError, match="jit.save"):
        traced.save_inference_model("/nonexistent")
    layer = paddle.jit.to_static(paddle.nn.Linear(3, 2))
    for _ in range(3):
        layer(paddle.ones([1, 3]))
    assert isinstance(layer.forward, paddle.jit.TracedFunction)
