"""paddle_tpu_torch's ``distribution`` against the JAX package's on the
CPU: ``Normal``, ``Uniform``, ``Categorical`` and
``MultivariateNormalDiag`` (``tests/test_api_round2.py``'s case and
more): log-probabilities, probabilities, entropies and KL divergences on
the same seeded parameters and values, a log-probability's grad against
the closed form, and ``sampling_id``. Samples come from the port's own
generators, so they are held to their law (mean and standard deviation
within 6 standard errors, a categorical's frequencies by chi-square)
and to their seed (the same seed the same draws), not to the
reference's bits.

Values within rtol 1e-5 (atol 1e-6) of the reference's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None


def _np(t):
    return np.asarray(t.numpy())


def _both(build):
    """``build(P, T)`` in each package, ``T`` making its Tensors."""
    return [_np(build(P, P.to_tensor)) for P in (paddle, ref)]


def _close(build):
    got, want = _both(build)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


RS = np.random.RandomState(0)
LOC = RS.randn(3, 4).astype("float32")
SCALE = (RS.rand(3, 4) + 0.5).astype("float32")
LOC2 = RS.randn(3, 4).astype("float32")
SCALE2 = (RS.rand(3, 4) + 0.5).astype("float32")
VALUE = RS.randn(3, 4).astype("float32")
LOW = RS.randn(3, 4).astype("float32")
HIGH = LOW + (RS.rand(3, 4) + 0.1).astype("float32")
LOGITS = RS.randn(5, 7).astype("float32")
IDX = RS.randint(0, 7, (5,)).astype("int64")


@pytest.mark.parametrize("what", ["log_prob", "probs", "entropy", "kl"])
def test_normal_matches_reference(what):
    def build(P, T):
        d = P.distribution.Normal(T(LOC), T(SCALE))
        if what == "kl":
            return P.distribution.kl_divergence(
                d, P.distribution.Normal(T(LOC2), T(SCALE2)))
        if what == "entropy":
            return d.entropy()
        return getattr(d, what)(T(VALUE))
    _close(build)


@pytest.mark.parametrize("what", ["log_prob", "probs", "entropy"])
def test_uniform_matches_reference(what):
    value = np.where(RS.rand(3, 4) < 0.7, (LOW + HIGH) / 2,
                     HIGH + 1).astype("float32")

    def build(P, T):
        d = P.distribution.Uniform(T(LOW), T(HIGH))
        if what == "entropy":
            return d.entropy()
        return getattr(d, what)(T(value))
    got, want = _both(build)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("what", ["log_prob", "log_prob_1d", "entropy"])
def test_categorical_matches_reference(what):
    def build(P, T):
        if what == "log_prob_1d":
            return P.distribution.Categorical(T(LOGITS[0])).log_prob(
                T(IDX[:3]))
        d = P.distribution.Categorical(T(LOGITS))
        if what == "entropy":
            return d.entropy()
        return d.log_prob(T(IDX))
    _close(build)


@pytest.mark.parametrize("what", ["log_prob", "entropy", "kl"])
def test_multivariate_normal_diag_matches_reference(what):
    cov = np.diag((RS.rand(4) + 0.5).astype("float32"))
    cov2 = np.diag((RS.rand(4) + 0.5).astype("float32"))

    def build(P, T):
        d = P.distribution.MultivariateNormalDiag(T(LOC), T(cov))
        if what == "kl":
            return d.kl_divergence(
                P.distribution.MultivariateNormalDiag(T(LOC2), T(cov2)))
        if what == "entropy":
            return d.entropy()
        return d.log_prob(T(VALUE))
    _close(build)


def test_log_prob_grad_is_the_closed_form():
    loc = paddle.to_tensor(LOC)
    loc.stop_gradient = False
    lp = paddle.distribution.Normal(loc, paddle.to_tensor(SCALE)).log_prob(
        paddle.to_tensor(VALUE))
    lp.sum().backward()
    np.testing.assert_allclose(_np(loc.grad), (VALUE - LOC) / SCALE ** 2,
                               rtol=RTOL, atol=ATOL)


def _moments_ok(x, mean, std):
    n = x.size
    assert abs(x.mean() - mean) < 6 * std / np.sqrt(n)
    assert abs(x.std() - std) < 6 * std / np.sqrt(2 * n)


def test_samples_hold_their_law_and_seed():
    paddle.seed(3)
    n = 200_000
    x = _np(paddle.distribution.Normal(1.5, 2.0).sample([n]))
    assert x.shape == (n,)
    _moments_ok(x, 1.5, 2.0)
    u = _np(paddle.distribution.Uniform(-1.0, 3.0).sample([n]))
    assert u.min() >= -1.0 and u.max() < 3.0
    _moments_ok(u, 1.0, 4.0 / np.sqrt(12.0))
    d = paddle.distribution.MultivariateNormalDiag(
        np.zeros(3, "float32"), np.diag([1.0, 4.0, 9.0]).astype("float32"))
    m = _np(d.sample((n,)))
    assert m.shape == (n, 3)
    for j, s in enumerate((1.0, 2.0, 3.0)):
        _moments_ok(m[:, j], 0.0, s)
    assert d.sample((2,)).shape == [2, 3]
    assert np.isfinite(float(d.entropy().numpy()))
    shapes = paddle.distribution.Normal(paddle.to_tensor(LOC),
                                        paddle.to_tensor(SCALE)).sample([2])
    assert shapes.shape == [2, 3, 4]
    draws = []
    for _ in range(2):
        paddle.seed(17)
        draws.append(_np(paddle.distribution.Normal(0.0, 1.0).sample([8])))
    np.testing.assert_array_equal(draws[0], draws[1])


def test_categorical_and_sampling_id_frequencies():
    paddle.seed(5)
    probs = np.array([0.1, 0.2, 0.3, 0.4], "float32")
    n = 40_000
    c = _np(paddle.distribution.Categorical(np.log(probs)).sample([n]))
    assert c.shape == (n,) and c.dtype == np.int64
    s = _np(paddle.distribution.sampling_id(
        np.tile(probs, (n, 1)))).reshape(-1)
    assert s.shape == (n,) and s.dtype == np.int64
    for draws in (c, s):
        counts = np.bincount(draws, minlength=4)
        chi2 = float(((counts - n * probs) ** 2 / (n * probs)).sum())
        assert chi2 < 16.27   # chi-square, 3 degrees of freedom, p = 0.001
    two = paddle.distribution.Categorical(
        paddle.to_tensor(LOGITS)).sample([3])
    assert two.shape == [3, 5]


def test_on_the_device_of_the_parameters():
    d = paddle.distribution.Normal(paddle.to_tensor(LOC),
                                   paddle.to_tensor(SCALE))
    assert d.sample([2]).value.device == torch.device("cpu")
