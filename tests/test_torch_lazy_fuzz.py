"""The reference's differential fuzz of its lazy executor
(``tests/test_lazy_fuzz.py``: its ``_UNARY``/``_BINARY`` tables, its
random pipelines over two [4, 4] inputs and its seeds) through both
packages: the port's lazy eager run against the reference's lazy run
(the value within 1e-5 and each grad within 1e-4 of its largest), and
against the port's immediate run bit for bit (the same torch calls in
the same order, on the CPU). Seeds 20-31, the reference's ``to_static``
leg, add the port's ``to_static`` of the same pipeline: three calls
(eager, record, run) each the immediate value, the grads accumulated
three times."""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.core import lazy

VALUE_TOL = 1e-5
GRAD_TOL = 1e-4


def _tables(F):
    """The reference's tables, over package ``F``'s functional."""
    unary = [
        ("tanh", lambda t: t.tanh()),
        ("exp", lambda t: (t * 0.3).exp()),
        ("relu", lambda t: F.relu(t)),
        ("gelu", lambda t: F.gelu(t)),
        ("softmax", lambda t: F.softmax(t, axis=-1)),
        ("square", lambda t: t.square()),
        ("sigmoid", lambda t: F.sigmoid(t)),
        ("norm", lambda t: F.normalize(t, axis=-1)),
        ("cumsum", lambda t: t.cumsum(axis=-1)),
        ("transpose", lambda t: t.transpose((1, 0)).transpose((1, 0))),
    ]
    binary = [
        ("add", lambda a, b: a + b),
        ("mul", lambda a, b: a * b),
        ("sub", lambda a, b: a - b),
        ("max", lambda a, b: a.maximum(b)),
        ("matmul_sq", lambda a, b: a.matmul(b.transpose((1, 0)))),
    ]
    return unary, binary


def _ops(rs, depth, n_unary, n_binary):
    """The reference's draw of a pipeline (``_random_program``)."""
    ops = []
    for _ in range(depth):
        if rs.rand() < 0.6:
            ops.append(("u", rs.randint(n_unary), rs.randint(2)))
        else:
            ops.append(("b", rs.randint(n_binary)))
    return ops


def _program(ops, P):
    unary, binary = _tables(P.nn.functional)

    def run(x, y):
        a, b = x, y
        for op in ops:
            if op[0] == "u":
                fn = unary[op[1]][1]
                if op[2] == 0:
                    a = fn(a)
                else:
                    b = fn(b)
            else:
                a = binary[op[1]][1](a, b)
        return (a * b).mean()
    return run


def _draw(seed):
    rs = np.random.RandomState(seed)
    ops = _ops(rs, rs.randint(3, 9), 10, 5)
    x_np = rs.randn(4, 4).astype("float32") * 0.5
    y_np = rs.randn(4, 4).astype("float32") * 0.5
    return ops, x_np, y_np


@pytest.fixture(autouse=True)
def _on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    lazy.flush()
    for P in (ref, paddle):
        P.set_flags({"FLAGS_lazy_eager": True})
    device_mod._current_place = None
    torch.set_num_threads(before)


def _run(P, ops, x_np, y_np, flag):
    P.set_flags({"FLAGS_lazy_eager": flag})
    try:
        x = P.to_tensor(x_np)
        y = P.to_tensor(y_np)
        x.stop_gradient = False
        y.stop_gradient = False
        out = _program(ops, P)(x, y)
        out.backward()
        return (np.asarray(out.numpy()), np.asarray(x.grad.numpy()),
                np.asarray(y.grad.numpy()))
    finally:
        P.set_flags({"FLAGS_lazy_eager": True})


def _close_to_largest(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, (
        what, got, want)


@pytest.mark.parametrize("seed", range(32))
def test_lazy_against_reference_and_immediate(seed):
    ops, x_np, y_np = _draw(seed)
    lazy_run = _run(paddle, ops, x_np, y_np, True)
    imm_run = _run(paddle, ops, x_np, y_np, False)
    ref_run = _run(ref, ops, x_np, y_np, True)
    for got, want in zip(lazy_run, imm_run):
        np.testing.assert_array_equal(got, want)
    _close_to_largest(lazy_run[0], ref_run[0], VALUE_TOL, "value")
    _close_to_largest(lazy_run[1], ref_run[1], GRAD_TOL, "x grad")
    _close_to_largest(lazy_run[2], ref_run[2], GRAD_TOL, "y grad")


@pytest.mark.parametrize("seed", range(20, 32))
def test_to_static_leg(seed):
    """The reference's third leg on the port: the pipeline's forward and
    backward under ``to_static``, three calls, each value immediate's,
    the grads three times immediate's."""
    ops, x_np, y_np = _draw(seed)
    val, gx, gy = _run(paddle, ops, x_np, y_np, False)
    prog = _program(ops, paddle)
    x = paddle.to_tensor(x_np)
    y = paddle.to_tensor(y_np)
    x.stop_gradient = False
    y.stop_gradient = False

    @paddle.jit.to_static
    def step():
        out = prog(x, y)
        out.backward()
        return out

    vals = [np.asarray(step().numpy()) for _ in range(3)]
    for v in vals:
        np.testing.assert_array_equal(v, val)
    np.testing.assert_allclose(x.grad.numpy(), 3 * gx, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(y.grad.numpy(), 3 * gy, rtol=1e-6,
                               atol=1e-7)
