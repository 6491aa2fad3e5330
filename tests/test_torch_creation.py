"""paddle_tpu_torch's creation ops against the JAX package's on the CPU:
the deterministic creators' values and dtypes (``arange`` int64 when
every bound is an int, ``full``/``zeros`` float32 by default), the
scenarios of tests/test_ops.py's ``TestCreation``, and the random
creators.

The random creators draw from ``torch.Generator``s (the port's default
generator for the device, or one the caller passes), the reference's
from ``jax.random`` keys, so the same seed gives different numbers: a
documented divergence. Each is held to its distribution (mean and std
within five standard errors of the draw, bounds exact), its shape and
dtype (the reference's), and determinism under ``paddle_tpu_torch.seed``;
none touches torch's global generator.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod

RTOL = ATOL = 1e-6
N = 20000   # draws for a distribution check


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


_rs = np.random.RandomState(0)
A = _rs.randn(4, 4).astype(np.float32)
V = np.array([1.0, 2.0, 3.0], np.float32)

CASES = {
    "zeros": lambda P: P.zeros([2, 3]),
    "zeros_int": lambda P: P.zeros([2], dtype="int32"),
    "ones": lambda P: P.ones([2, 3]),
    "ones_tensor_shape": lambda P: P.ones(P.to_tensor(np.array([3, 1]))),
    "full_int_value": lambda P: P.full([2], 7),
    "full_dtype": lambda P: P.full([2, 2], 1.5, dtype="float64"),
    "empty": lambda P: P.empty([3]),
    "zeros_like": lambda P: P.zeros_like(P.to_tensor(A)),
    "ones_like_int": lambda P: P.ones_like(P.to_tensor(A), dtype="int64"),
    "full_like": lambda P: P.full_like(P.to_tensor(A), 3),
    "full_like_int": lambda P: P.full_like(P.to_tensor(np.arange(3)), 2.5),
    "empty_like": lambda P: P.empty_like(P.to_tensor(A)),
    "arange_int": lambda P: P.arange(5),
    "arange_start_step": lambda P: P.arange(1, 10, 3),
    "arange_float": lambda P: P.arange(0.0, 2.0, 0.25),
    "arange_mixed": lambda P: P.arange(1, 4.5),
    "arange_dtype": lambda P: P.arange(0, 6, 2, dtype="float32"),
    "linspace": lambda P: P.linspace(0, 1, 5),
    "linspace_range": lambda P: P.linspace(-3.5, 7.25, 13),
    "logspace": lambda P: P.logspace(0, 3, 4),
    "logspace_base2": lambda P: P.logspace(1, 5, 5, base=2.0),
    "eye": lambda P: P.eye(3),
    "eye_rect": lambda P: P.eye(2, 4, dtype="int32"),
    "tril": lambda P: P.tril(P.to_tensor(A)),
    "triu_offset": lambda P: P.triu(P.to_tensor(A), 1),
    "tril_neg": lambda P: P.to_tensor(A).tril(-1),
    "diag_vector": lambda P: P.diag(P.to_tensor(V)),
    "diag_offset_padding": lambda P: P.diag(P.to_tensor(V), offset=1,
                                            padding_value=-2.0),
    "diag_matrix": lambda P: P.diag(P.to_tensor(A), offset=-1),
    "diagflat": lambda P: P.diagflat(P.to_tensor(A[:2, :2])),
    "assign": lambda P: P.assign(P.to_tensor(A)),
    "assign_numpy": lambda P: P.assign(A),
    "clone": lambda P: P.clone(P.to_tensor(A)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_creator_matches_the_reference(name):
    want, got = CASES[name](ref), CASES[name](paddle)
    assert got.dtype.name == want.dtype.name
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert got.stop_gradient == want.stop_gradient
    assert got.place == paddle.CPUPlace()


def test_test_ops_creation_scenarios():
    """tests/test_ops.py::TestCreation (test_basic, test_like,
    test_tril_triu_diag) in both packages."""
    a = np.random.RandomState(3).randn(4, 4)
    v = np.array([1.0, 2.0, 3.0])
    for P in (ref, paddle):
        assert P.zeros([2, 3]).numpy().sum() == 0
        assert P.ones([2, 3]).numpy().sum() == 6
        np.testing.assert_array_equal(P.full([2], 7).numpy(), [7, 7])
        np.testing.assert_array_equal(P.arange(5).numpy(), np.arange(5))
        np.testing.assert_array_equal(P.arange(1, 10, 3).numpy(),
                                      np.arange(1, 10, 3))
        np.testing.assert_allclose(P.linspace(0, 1, 5).numpy(),
                                   np.linspace(0, 1, 5))
        np.testing.assert_array_equal(P.eye(3).numpy(), np.eye(3))
        x = P.ones([2, 2])
        assert P.zeros_like(x).numpy().sum() == 0
        assert P.full_like(x, 3).numpy().sum() == 12
        np.testing.assert_allclose(P.tril(P.to_tensor(a)).numpy(),
                                   np.tril(a))
        np.testing.assert_allclose(P.triu(P.to_tensor(a), 1).numpy(),
                                   np.triu(a, 1))
        np.testing.assert_allclose(P.diag(P.to_tensor(v)).numpy(),
                                   np.diag(v))


def test_tril_triu_grads_match():
    def run(P):
        t = P.to_tensor(A, stop_gradient=False)
        (P.tril(t, 1) * P.to_tensor(A) + P.triu(t) * 2.0).sum().backward()
        return t.grad.numpy()
    np.testing.assert_allclose(run(paddle), run(ref), rtol=1e-5)


def test_assign_into_an_output():
    for P in (ref, paddle):
        out = P.zeros([4, 4])
        got = P.assign(P.to_tensor(A), output=out)
        assert got is out
        np.testing.assert_array_equal(out.numpy(), A)


# ---------------------------------------------------------------- random

RANDOM = {
    # name -> (call(P, shape), dtype, (mean, std) or None, (lo, hi) or None)
    "uniform": (lambda P, s: P.uniform(s, min=-2.0, max=3.0), "float32",
                (0.5, 5.0 / np.sqrt(12.0)), (-2.0, 3.0)),
    "uniform_f64": (lambda P, s: P.uniform(s, dtype="float64"), "float64",
                    (0.0, 2.0 / np.sqrt(12.0)), (-1.0, 1.0)),
    "rand": (lambda P, s: P.rand(s), "float32",
             (0.5, 1.0 / np.sqrt(12.0)), (0.0, 1.0)),
    "normal": (lambda P, s: P.normal(1.5, 2.0, s), "float32", (1.5, 2.0),
               None),
    "randn": (lambda P, s: P.randn(s), "float32", (0.0, 1.0), None),
    "standard_normal": (lambda P, s: P.standard_normal(s), "float32",
                        (0.0, 1.0), None),
    "randint": (lambda P, s: P.randint(-3, 5, s), "int64",
                (0.5, np.sqrt((8 ** 2 - 1) / 12.0)), (-3, 4)),
    "randint_int32": (lambda P, s: P.randint(7, shape=s, dtype="int32"),
                      "int32", (3.0, np.sqrt((7 ** 2 - 1) / 12.0)), (0, 6)),
    "rand_like": (lambda P, s: P.tensor.creation.rand_like(
        P.zeros(s, dtype="float64")),
                  "float64", (0.5, 1.0 / np.sqrt(12.0)), (0.0, 1.0)),
    "bernoulli": (lambda P, s: P.bernoulli(P.full(s, 0.3)), "float32",
                  (0.3, np.sqrt(0.21)), (0.0, 1.0)),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_creator(name):
    call, dtype, moments, bounds = RANDOM[name]
    want = call(ref, [4, 5])
    small = call(paddle, [4, 5])
    assert small.shape == want.shape == [4, 5]
    assert small.dtype.name == want.dtype.name == dtype
    paddle.seed(11)
    a = call(paddle, [N]).numpy().astype(np.float64)
    b = call(paddle, [N]).numpy()
    paddle.seed(11)
    np.testing.assert_array_equal(call(paddle, [N]).numpy(), a)
    assert not np.array_equal(a, b)           # the generator moved on
    if moments is not None:
        mean, std = moments
        assert abs(a.mean() - mean) < 5 * std / np.sqrt(N)
        assert abs(a.std() - std) < 0.03 * std
    if bounds is not None:
        assert a.min() >= bounds[0] and a.max() <= bounds[1]


def test_randperm_and_multinomial():
    paddle.seed(4)
    p = paddle.randperm(10)
    assert p.dtype.name == ref.randperm(10).dtype.name == "int64"
    assert sorted(p.numpy().tolist()) == list(range(10))
    w = paddle.to_tensor(np.array([[0.0, 1.0, 3.0], [5.0, 0.0, 0.0]],
                                  np.float32))
    draws = paddle.multinomial(w, num_samples=4000, replacement=True)
    assert draws.dtype.name == "int64" and draws.shape == [2, 4000]
    row = draws.numpy()[0]
    assert set(row.tolist()) <= {1, 2}
    assert abs((row == 2).mean() - 0.75) < 5 * np.sqrt(0.75 * 0.25 / 4000)
    assert set(draws.numpy()[1].tolist()) == {0}
    two = paddle.multinomial(w[:1], num_samples=2).numpy()[0]
    assert sorted(two.tolist()) == [1, 2]      # without replacement


def test_an_explicit_generator_is_used_and_the_global_one_is_not():
    state = torch.random.get_rng_state()
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = paddle.randn([8], generator=g1).numpy()
    b = paddle.randn([8], generator=g2).numpy()
    np.testing.assert_array_equal(a, b)
    paddle.rand([3])
    paddle.randint(0, 3, [3])
    paddle.bernoulli(paddle.full([3], 0.5))
    assert torch.equal(torch.random.get_rng_state(), state)


def test_create_parameter():
    """tests/test_ops.py::test_misc_shims' create_parameter: the default
    XavierUniform for a weight within its bound, zeros for a bias."""
    for P in (ref, paddle):
        p = P.create_parameter([30, 40], "float32")
        assert p.shape == [30, 40] and not p.stop_gradient
        limit = np.sqrt(6.0 / 70.0)
        assert np.abs(p.numpy()).max() <= limit
        assert p.numpy().std() > 0.5 * limit / np.sqrt(3.0)
        b = P.create_parameter([5], "float32", is_bias=True)
        assert not b.numpy().any()
    assert isinstance(paddle.create_parameter([2], "float32"),
                      paddle.Parameter)


def test_tensor_namespace_forwards():
    """``paddle.tensor`` (module 14): the op modules under the reference's
    submodule names, every tensor function forwarded at its top level,
    the in-place methods as free functions, the random names through
    ``tensor.random``; sibling namespaces are not mirrored."""
    for P in (ref, paddle):
        assert P.tensor.add is P.add and P.tensor.reshape is P.reshape
        assert P.tensor.math.add is P.add
        assert P.tensor.creation.zeros is P.zeros
        assert P.tensor.manipulation.concat is P.concat
        assert P.tensor.search.topk is P.topk
        assert P.tensor.stat.mean is P.mean
        assert P.tensor.random.randn is P.randn
        assert P.tensor.attribute.shape is P.shape
        t = P.to_tensor(np.ones(3, np.float32))
        assert P.tensor.add_(t, P.to_tensor(np.ones(3, np.float32))) is t
        np.testing.assert_array_equal(t.numpy(), 2.0)
        with pytest.raises(AttributeError):
            P.tensor.nn
    for name in ("create_array", "array_read", "array_write",
                 "array_length"):
        assert getattr(paddle.tensor.array, name) \
            is getattr(paddle.fluid.layers, name)
        assert getattr(paddle.tensor, name) \
            is getattr(paddle.fluid.layers, name)
