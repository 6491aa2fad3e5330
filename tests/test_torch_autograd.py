"""paddle_tpu_torch's autograd (torch's own, behind the reference's
semantics) against the JAX package's on the CPU: the scenarios of
tests/test_autograd.py whose ops the core ports — grads of the unary
ops and matmul, accumulation, stop_gradient and detach cuts, the
backward-twice error, multi-output ops, ``paddle.grad``, hooks,
``PyLayer``, ``no_grad``, double and triple grads, the gradient penalty,
the analytic double-grad sweep, hooks under create_graph — and a double
grad through the attention op. ``relu`` among the unary grads, the
softmax cross-entropy's grad, ``topk``'s multi-output grad, the dense
embedding's scatter grad and the gradient penalty through ``nn.Linear``
run on the ops of the ``nn`` slice. Each runs on the same inputs in both
packages; grads are held with f32 ``allclose`` (rtol 1e-5: the same
products, the libraries' own rounding), f64 ones at rtol 1e-10.

Waiting for a later slice (its op is not ported): ``conv2d``'s grad.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu.ops import attention as ref_attention
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.ops import attention as attention

RTOL = 1e-5
F64_RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _both(fn):
    return fn(ref), fn(paddle)


def _close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("fn_name", [
    "exp", "tanh", "sigmoid", "sqrt", "square", "log", "reciprocal", "relu",
])
def test_unary_grads(fn_name):
    """test_autograd.py::test_unary_grads: the grad of each op's sum in
    f64, against the reference's (the reference checks it against
    finite differences)."""
    x = np.random.RandomState(0).uniform(0.5, 2.0, (3, 4))

    def run(pkg):
        t = pkg.to_tensor(x.astype("float64"), stop_gradient=False)
        fn = getattr(pkg, fn_name, None) or getattr(pkg.nn.functional,
                                                    fn_name)
        fn(t).sum().backward()
        return t.grad.numpy()
    want, got = _both(run)
    _close(got, want, rtol=F64_RTOL)


def test_matmul_grad():
    rs = np.random.RandomState(1)
    a_np, b_np = rs.randn(3, 4), rs.randn(4, 5)

    def run(pkg):
        a = pkg.to_tensor(a_np, stop_gradient=False)
        b = pkg.to_tensor(b_np, stop_gradient=False)
        out = pkg.matmul(a, b)
        out.backward(pkg.to_tensor(np.ones((3, 5))))
        return a.grad.numpy(), b.grad.numpy()
    (wa, wb), (ga, gb) = _both(run)
    _close(ga, np.ones((3, 5)) @ b_np.T, rtol=1e-6)
    _close(gb, a_np.T @ np.ones((3, 5)), rtol=1e-6)
    _close(ga, wa, rtol=F64_RTOL)
    _close(gb, wb, rtol=F64_RTOL)


def test_grad_accumulation():
    def run(pkg):
        x = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
        (x * 2).sum().backward()
        (x * 3).sum().backward()
        g = x.grad.numpy().tolist()
        x.clear_grad()
        return g, x.grad
    assert _both(run) == (([5.0, 5.0], None), ([5.0, 5.0], None))


def test_stop_gradient_cut():
    def run(pkg):
        x = pkg.to_tensor([1.0], stop_gradient=False)
        y = pkg.to_tensor([2.0], stop_gradient=True)
        (x * y).sum().backward()
        return x.grad.numpy().tolist(), y.grad
    assert _both(run) == (([2.0], None), ([2.0], None))


def test_stop_gradient_set_on_an_output_cuts_there():
    def run(pkg):
        x = pkg.to_tensor([3.0], stop_gradient=False)
        y = x * x
        y.stop_gradient = True
        (y * x).sum().backward()
        return x.grad.numpy().tolist()
    assert _both(run) == ([9.0], [9.0])


def test_detach_cuts_graph():
    def run(pkg):
        x = pkg.to_tensor([3.0], stop_gradient=False)
        y = (x * x).detach()
        (y * x).backward()
        return x.grad.numpy().tolist()
    assert _both(run) == ([9.0], [9.0])


def test_backward_twice_raises_without_retain():
    for pkg in (ref, paddle):
        x = pkg.to_tensor([1.0], stop_gradient=False)
        y = x * x * x
        y.backward(retain_graph=True)
        y.backward()                  # retain allowed it once more
        with pytest.raises(RuntimeError, match="released graph"):
            y.backward()
        # torch alone would let a graph that saved nothing go again
        z = x * 2.0
        z.backward()
        with pytest.raises(RuntimeError, match="released graph"):
            z.backward()
        assert x.grad.numpy().tolist() == [8.0]


def test_backward_without_a_graph_raises():
    for pkg in (ref, paddle):
        with pytest.raises(RuntimeError, match="no grad graph"):
            pkg.to_tensor([1.0]).backward()
        with pytest.raises(RuntimeError, match="no grad graph"):
            pkg.to_tensor([1.0], stop_gradient=False).backward()


def test_softmax_cross_entropy_grad():
    """test_autograd.py::test_softmax_cross_entropy_grad: the grad of
    F.cross_entropy's mean over f64 logits, against the reference's."""
    rs = np.random.RandomState(3)
    logits = rs.randn(4, 10)
    labels = rs.randint(0, 10, (4,))

    def run(pkg):
        x = pkg.to_tensor(logits, stop_gradient=False)
        pkg.nn.functional.cross_entropy(
            x, pkg.to_tensor(labels)).backward()
        return x.grad.numpy()
    want, got = _both(run)
    _close(got, want, rtol=F64_RTOL)


def test_topk_multi_output_grad():
    """test_autograd.py::test_multi_output_op_grad: topk's values carry
    the grad back to the chosen elements only."""
    xs = np.random.RandomState(4).randn(5)

    def run(pkg):
        x = pkg.to_tensor(xs, stop_gradient=False)
        vals, idx = pkg.topk(x, k=2)
        assert idx.dtype.name == "int64" and idx.stop_gradient
        vals.sum().backward()
        return x.grad.numpy()
    want, got = _both(run)
    expected = np.zeros(5)
    expected[np.argsort(-xs)[:2]] = 1
    _close(got, want, rtol=F64_RTOL)
    _close(got, expected, rtol=F64_RTOL)


def test_embedding_grad_scatter():
    """test_autograd.py::test_embedding_grad_scatter: the dense grad of
    the table adds a row for every lookup."""
    w_np = np.random.RandomState(5).randn(10, 4)

    def run(pkg):
        w = pkg.to_tensor(w_np, stop_gradient=False)
        out = pkg.nn.functional.embedding(pkg.to_tensor(np.array([1, 1, 3])),
                                          w)
        out.sum().backward()
        return w.grad.numpy()
    want, got = _both(run)
    _close(got, want, rtol=F64_RTOL)
    assert got[1].sum() == pytest.approx(8.0)
    assert got[3].sum() == pytest.approx(4.0)
    assert got[0].sum() == 0


def test_gradient_penalty_through_nn_linear():
    """test_autograd.py::test_double_grad_vector_and_gradient_penalty as
    written there, through nn.Linear (the reference layer's weights
    carried into the port's): gp = ||dout/dx||^2 = 8 ||w||^2, so
    d gp / d w = 16 w."""
    rnet = ref.nn.Linear(4, 1)
    pnet = paddle.nn.Linear(4, 1)
    pnet.set_state_dict({k: v.numpy() for k, v in rnet.state_dict().items()})
    x_np = np.random.RandomState(11).randn(8, 4).astype("float32")

    def run(pkg, net):
        x = pkg.to_tensor(x_np, stop_gradient=False)
        (gx,) = pkg.grad(net(x).sum(), x, create_graph=True)
        (gx * gx).sum().backward()
        return net.weight.grad.numpy(), gx.numpy()
    (ww, wgx), (gw, ggx) = run(ref, rnet), run(paddle, pnet)
    _close(gw, ww)
    _close(ggx, wgx)
    _close(gw, 16.0 * pnet.weight.numpy(), rtol=1e-4, atol=1e-5)


def test_multi_output_op_grad():
    """A registered op of two outputs: only the output used carries a
    grad back (topk's case is test_topk_multi_output_grad)."""
    from paddle_tpu.core.dispatch import register_op as ref_register
    from paddle_tpu_torch.core.dispatch import register_op

    ref_op = ref_register("test_torch_autograd_pair")(
        lambda x: (x * 2.0, x * x))
    port_op = register_op("test_torch_autograd_pair")(
        lambda x: (x * 2.0, x * x))
    xs = np.random.RandomState(2).randn(5)

    def run(pkg, op):
        x = pkg.to_tensor(xs, stop_gradient=False)
        a, b = op(x)
        b.sum().backward()
        g1 = x.grad.numpy()
        x.clear_grad()
        a, b = op(x)
        (a.sum() + b.sum()).backward()
        return g1, x.grad.numpy()
    want, got = run(ref, ref_op), run(paddle, port_op)
    for g, w in zip(got, want):
        _close(g, w, rtol=F64_RTOL)
    _close(got[0], 2 * xs, rtol=F64_RTOL)


def test_paddle_grad_api():
    def run(pkg):
        x = pkg.to_tensor([2.0], stop_gradient=False)
        (g,) = pkg.grad(x * x, x)
        return g.numpy().tolist(), x.grad, g.stop_gradient
    assert _both(run) == (([4.0], None, True), ([4.0], None, True))


def test_paddle_grad_unused_inputs():
    for pkg in (ref, paddle):
        x = pkg.to_tensor([2.0], stop_gradient=False)
        z = pkg.to_tensor([5.0], stop_gradient=False)
        with pytest.raises(RuntimeError, match="unused"):
            pkg.grad(x * 3.0, [x, z], retain_graph=True)
        gx, gz = pkg.grad(x * 3.0, [x, z], allow_unused=True)
        assert gx.numpy().tolist() == [3.0] and gz is None


def test_tensor_hook():
    def run(pkg):
        x = pkg.to_tensor([1.0, 1.0], stop_gradient=False)
        h = x.register_hook(lambda g: g * 2)
        (x * 3).sum().backward()
        g = x.grad.numpy().tolist()
        h.remove()
        x.clear_grad()
        (x * 3).sum().backward()
        # a hook on a non-leaf scales what flows past it
        y = x * 1.0
        y.register_hook(lambda g: g * 10)
        x.clear_grad()
        (y * 3).sum().backward()
        return g, x.grad.numpy().tolist()
    assert _both(run) == (([6.0, 6.0], [30.0, 30.0]),
                          ([6.0, 6.0], [30.0, 30.0]))


def test_pylayer():
    def run(pkg):
        class Double(pkg.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * 2

            @staticmethod
            def backward(ctx, g):
                (x,) = ctx.saved_tensor
                return g * 2 + x * 0

        x = pkg.to_tensor([1.5], stop_gradient=False)
        y = Double.apply(x)
        out = y.numpy().tolist()
        y.backward()
        return out, x.grad.numpy().tolist(), y.stop_gradient
    assert _both(run) == (([3.0], [2.0], False), ([3.0], [2.0], False))


def test_pylayer_two_outputs_and_a_plain_argument():
    def run(pkg):
        class Split(pkg.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, k):
                ctx.k = k
                return x * k, x + 1

            @staticmethod
            def backward(ctx, ga, gb):
                return ga * ctx.k + gb

        x = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
        a, b = Split.apply(x, 3.0)
        (a.sum() * 2 + b.sum()).backward()
        return a.numpy().tolist(), x.grad.numpy().tolist()
    assert _both(run) == (([3.0, 6.0], [7.0, 7.0]), ([3.0, 6.0], [7.0, 7.0]))


def test_no_grad_context():
    def run(pkg):
        x = pkg.to_tensor([1.0], stop_gradient=False)
        with pkg.no_grad():
            y = x * 2
            inner = pkg.is_grad_enabled()
            with pkg.enable_grad():
                z = x * 2

        @pkg.no_grad()
        def f(t):
            return t * 3
        return (y.stop_gradient, y.is_leaf, inner, z.stop_gradient,
                f(x).stop_gradient, pkg.is_grad_enabled())
    assert _both(run) == ((True, True, False, False, True, True),) * 2


def test_double_grad_scalar():
    def run(pkg):
        x = pkg.to_tensor(np.float32(2.0))
        x.stop_gradient = False
        y = x * x * x
        (g,) = pkg.grad(y, x, create_graph=True)
        (g2,) = pkg.grad(g, x)
        return float(g.numpy()), g.stop_gradient, float(g2.numpy())
    assert _both(run) == ((12.0, False, 12.0),) * 2


def test_double_grad_vector_and_gradient_penalty():
    """||dout/dx||^2 backpropagated into the weights through matmul + add
    over the same seeded weights (through nn.Linear:
    test_gradient_penalty_through_nn_linear)."""
    rs = np.random.RandomState(11)
    w_np = rs.randn(4, 1).astype("float32")
    b_np = rs.randn(1).astype("float32")
    x_np = rs.randn(8, 4).astype("float32")

    def run(pkg):
        w = pkg.Parameter(w_np)
        b = pkg.Parameter(b_np)
        x = pkg.to_tensor(x_np, stop_gradient=False)
        out = (pkg.matmul(x, w) + b).sum()
        (gx,) = pkg.grad(out, x, create_graph=True)
        gp = (gx * gx).sum()
        gp.backward()
        return w.grad.numpy(), b.grad, gx.numpy()
    (ww, wb, wgx), (gw, gb, ggx) = _both(run)
    _close(gw, 16.0 * w_np, rtol=1e-4, atol=1e-5)   # gp = 8 ||w||^2
    _close(gw, ww)
    _close(ggx, wgx)
    # gp does not depend on b: the reference materializes a zero grad,
    # torch leaves it None (ROADMAP queue 3)
    assert gb is None and not wb.numpy().any()


def test_triple_grad():
    def run(pkg):
        x = pkg.to_tensor(np.float32(3.0))
        x.stop_gradient = False
        y = x ** 4
        (g1,) = pkg.grad(y, x, create_graph=True)
        (g2,) = pkg.grad(g1, x, create_graph=True)
        (g3,) = pkg.grad(g2, x)
        return [float(g.numpy()) for g in (g1, g2, g3)]
    assert _both(run) == ([108.0, 108.0, 72.0],) * 2


def test_pylayer_under_create_graph_cuts_cleanly():
    def run(pkg):
        class Double(pkg.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                return x * 2

            @staticmethod
            def backward(ctx, g):
                return g * 2

        x = pkg.to_tensor(np.float32(3.0))
        x.stop_gradient = False
        y = Double.apply(x) * x
        (g,) = pkg.grad(y, x, create_graph=True)
        return float(g.numpy())
    assert _both(run) == (12.0, 12.0)


def test_double_grad_distinct_attrs():
    def run(pkg):
        x = pkg.to_tensor(np.arange(9, dtype="float32").reshape(3, 3))
        x.stop_gradient = False
        v = pkg.to_tensor(np.array([1.0, 2.0, 3.0], "float32"))
        (g0,) = pkg.grad((x.sum(axis=0) * v).sum(), x, create_graph=True)
        (g1,) = pkg.grad((x.sum(axis=1) * v).sum(), x, create_graph=True)
        return g0.numpy().tolist(), g1.numpy().tolist()
    want, got = _both(run)
    assert got == want
    assert got[0] == np.tile([[1, 2, 3]], (3, 1)).tolist()


def test_hooks_with_create_graph_raise():
    for pkg in (ref, paddle):
        x = pkg.to_tensor(np.float32(2.0))
        x.stop_gradient = False
        y = x * x
        y.register_hook(lambda g: g)
        z = y * x
        with pytest.raises(NotImplementedError, match="create_graph"):
            pkg.grad(z, x, create_graph=True)
        # without create_graph the same hook runs
        (g,) = pkg.grad(y * x, x)
        assert float(g.numpy()) == 12.0


def test_set_flags_round_trip():
    """test_autograd.py's flag scenario reapplies XLA's compilation
    cache; the port keeps the flag (read by nothing) and its set/get."""
    old = paddle.get_flags("FLAGS_compilation_cache_dir")
    try:
        paddle.set_flags({"FLAGS_compilation_cache_dir": ""})
        assert paddle.get_flags(["FLAGS_compilation_cache_dir"]) == {
            "FLAGS_compilation_cache_dir": ""}
    finally:
        paddle.set_flags(old)


def test_grad_failure_restores_accumulated_grads():
    for pkg in (ref, paddle):
        x = pkg.to_tensor(np.float32(2.0))
        x.stop_gradient = False
        x.grad = pkg.to_tensor(np.float32(5.0))      # pre-accumulated
        y = x * x
        y.register_hook(lambda g: g)
        with pytest.raises(NotImplementedError):
            pkg.grad(y * x, x, create_graph=True)
        assert float(x.grad.numpy()) == 5.0


def test_value_written_after_the_forward():
    """Divergence (ROADMAP queue 3): the reference's double grad sees the
    value the forward saw after ``w.value`` is reassigned; the port
    writes the value in place, as torch's optimizers do, and torch's
    autograd then refuses the backward through the saved value."""
    w = ref.to_tensor(np.float32(3.0))
    w.stop_gradient = False
    y = w * w
    w.value = np.float32(100.0)
    (g,) = ref.grad(y, w, create_graph=True)
    assert float(g.numpy()) == 6.0
    w = paddle.to_tensor(np.float32(3.0))
    w.stop_gradient = False
    y = w * w
    w.value = np.float32(100.0)
    with pytest.raises(RuntimeError, match="inplace"):
        paddle.grad(y, w, create_graph=True)
    # a graph recorded after the write sees the new value
    (g,) = paddle.grad(w * w, w)
    assert float(g.numpy()) == 200.0


def test_double_grad_analytic_sweep():
    v = np.array([0.3, -0.7, 1.1], np.float32)
    cases = [
        (lambda t: t.tanh(),
         lambda x: -2 * np.tanh(x) * (1 - np.tanh(x) ** 2)),
        (lambda t: t.sigmoid(),
         lambda x: (s := 1 / (1 + np.exp(-x))) * (1 - s) * (1 - 2 * s)),
        (lambda t: t.exp(), np.exp),
        (lambda t: (t * t * t), lambda x: 6 * x),
        (lambda t: t.square().log(), lambda x: -2 / x ** 2),
        (lambda t: t.sin(), lambda x: -np.sin(x)),
        (lambda t: t ** 3, lambda x: 6 * x),
    ]
    for fn, d2 in cases:
        def run(pkg):
            x = pkg.to_tensor(v.copy())
            x.stop_gradient = False
            (g1,) = pkg.grad(fn(x).sum(), x, create_graph=True)
            (g2,) = pkg.grad(g1.sum(), x)
            return g2.numpy()
        want, got = _both(run)
        _close(got, d2(v), rtol=2e-4, atol=1e-5)
        _close(got, want, rtol=RTOL)


def test_double_grad_matmul_mixed():
    rs = np.random.RandomState(0)
    A = rs.randn(3, 4).astype(np.float32)
    B = rs.randn(4, 2).astype(np.float32)
    C = rs.randn(3, 2).astype(np.float32)

    def run(pkg):
        a = pkg.to_tensor(A.copy())
        a.stop_gradient = False
        bt = pkg.to_tensor(B.copy())
        bt.stop_gradient = False
        c = pkg.to_tensor(C.copy())
        (gb,) = pkg.grad((a.matmul(bt) * c).sum(), bt, create_graph=True)
        (ga,) = pkg.grad((gb * gb).sum(), a)
        return ga.numpy()
    want, got = _both(run)
    _close(got, 2 * C @ (A.T @ C).T, rtol=1e-4, atol=1e-5)
    _close(got, want, rtol=RTOL)


# ---------------------------------------- the attention op, double grad

def _attention_penalty(pkg, sdpa, q_np, k_np, v_np, quadratic):
    """A Paddle-style loss around the attention op and its double grad:
    the loss, dL/dq, and the grads of ||dL/dq||^2 with respect to q, k
    and v. ``quadratic``: the loss is quadratic in the output (so dO
    depends on the forward), else its plain sum (dO is constant)."""
    q, k, v = (pkg.to_tensor(a, stop_gradient=False)
               for a in (q_np, k_np, v_np))
    out = sdpa(q, k, v, is_causal=True)
    loss = (out * out).sum() * 0.5 + out.mean() if quadratic else out.sum()
    gq, = pkg.grad(loss, q, create_graph=True)
    pen = (gq * gq).sum()
    grads = pkg.grad(pen, [q, k, v])
    return [loss.numpy(), gq.numpy()] + [g.numpy() for g in grads]


def _qkv(seq, seed=7):
    rs = np.random.RandomState(seed)
    return [rs.randn(1, 2, seq, 64).astype("float32") * 0.5
            for _ in range(3)]


def _held(got, want):
    """f32, within 2e-4 of each array's largest value: scores summed in
    another order, then differentiated twice."""
    for g, w in zip(got, want):
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(np.asarray(g) / scale,
                                   np.asarray(w) / scale, rtol=0, atol=2e-4)


@pytest.mark.parametrize("seq,quadratic", [(16, True), (128, True),
                                           (128, False)])
def test_double_grad_through_the_attention_op(seq, quadratic):
    """A double grad through the reference's flash-attention op on its
    CPU path gives a value (JAX differentiates the custom_vjp's
    backward, there the XLA composition's); the port's gives the same
    value through K2/K3's first order and the plain composition's
    second."""
    arrs = _qkv(seq)
    want = _attention_penalty(
        ref, ref_attention.scaled_dot_product_attention, *arrs, quadratic)
    got = _attention_penalty(paddle, attention.scaled_dot_product_attention,
                             *arrs, quadratic)
    _held(got, want)


def _jax_penalty_grads(arrs, quadratic):
    """The same penalty's grads straight through the reference's
    custom_vjp with JAX's autodiff (no dispatcher cache in between)."""
    import jax
    import jax.numpy as jnp
    scale = 1.0 / np.sqrt(arrs[0].shape[-1])

    def loss(q, k, v):
        out = ref_attention._flash_attention_core(q, k, v, scale, True)
        return (jnp.sum(out * out) * 0.5 + jnp.mean(out)) if quadratic \
            else jnp.sum(out)

    def pen(q, k, v):
        gq = jax.grad(loss)(q, k, v)
        return jnp.sum(gq * gq)
    return jax.grad(pen, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))


@pytest.mark.parametrize("quadratic", [True, False])
def test_double_grad_through_the_pallas_kernels(quadratic):
    """On the reference's kernel path (its Pallas kernels, here in
    interpret mode) the double grad needs the JVP of a ``pallas_call``,
    and JAX fails inside it with an AssertionError of its own, an
    internal failure rather than an error the reference raises on
    purpose (ROADMAP queue 3). The port computes the value, which is
    the reference's on its composition's path."""
    arrs = _qkv(128)
    ref_attention._FORCE_INTERPRET[0] = True
    try:
        with pytest.raises(AssertionError):
            _jax_penalty_grads(arrs, quadratic)
    finally:
        ref_attention._FORCE_INTERPRET[0] = False
    want = _jax_penalty_grads(arrs, quadratic)
    got = _attention_penalty(paddle, attention.scaled_dot_product_attention,
                             *arrs, quadratic)
    _held(got[2:], want)


def test_attention_op_grads_match_plain_torch():
    """The core's attention op and plain torch through the same
    autograd function: the same loss and grads, bit for bit."""
    rs = np.random.RandomState(8)
    arrs = [rs.randn(2, 2, 32, 64).astype("float32") for _ in range(3)]
    q, k, v = (paddle.to_tensor(a, stop_gradient=False) for a in arrs)
    out = attention.scaled_dot_product_attention(q, k, v, is_causal=True)
    (out * out).sum().backward()
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in arrs)
    tout = attention.scaled_dot_product_attention(tq, tk, tv, is_causal=True)
    (tout * tout).sum().backward()
    assert torch.equal(out.value, tout)
    for t, tt in ((q, tq), (k, tk), (v, tv)):
        assert torch.equal(t.grad.value, tt.grad)
