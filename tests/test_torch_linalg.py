"""paddle_tpu_torch's ``linalg`` against the JAX package's on the CPU.

Every op of ``paddle_tpu/ops/linalg.py`` on the same seeded inputs in
both packages, in f32 and f64 (f64 in gives f64 out in both). Ops with
a unique answer are held to the reference's values: rtol/atol 1e-4 in
f32 (LAPACK and XLA reduce in other orders), 1e-10 in f64. The
decompositions are unique only up to signs and order, so they are held
to invariants: each reconstructs its input, its factors are orthonormal
or triangular where they should be, sorted eigenvalues and singular
values equal the reference's, and ``|U|``, ``|R|`` and ``|V|`` equal the
reference's (the inputs' singular values and eigenvalues are distinct).
The differentiable ops' grads are held to the reference's at the same
tolerance. Then ``tests/test_ops_round2.py:19-65`` (``lu``,
``lu_get_infos``, ``cholesky_solve``, ``eig``, ``corrcoef``/``cov``) as
it is, on the port.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod

TOL = {"float32": 1e-4, "float64": 1e-10}


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _np(x):
    return np.asarray(x.numpy())


def _spd(rs, n, dtype, batch=()):
    m = rs.randn(*batch, n, n)
    return (m @ np.swapaxes(m, -1, -2) + n * np.eye(n)).astype(dtype)


def _inputs(dtype):
    rs = np.random.RandomState(0)
    return {
        "sq": (rs.randn(2, 4, 4) + 4 * np.eye(4)).astype(dtype),
        "spd": _spd(rs, 4, dtype, (2,)),
        "tall": rs.randn(6, 3).astype(dtype),
        "rhs": rs.randn(2, 4, 2).astype(dtype),
        "b6": rs.randn(6, 2).astype(dtype),
        "obs": rs.randn(3, 40).astype(dtype),
    }


# (name, call(P, arrays as P tensors), input keys)
VALUE_CASES = [
    ("cholesky", lambda P, a: P.linalg.cholesky(a["spd"]), ()),
    ("cholesky_upper", lambda P, a: P.linalg.cholesky(a["spd"], upper=True),
     ()),
    ("inv", lambda P, a: P.linalg.inv(a["sq"]), ()),
    ("inverse_top", lambda P, a: P.inverse(a["sq"]), ()),
    ("matrix_power_3", lambda P, a: P.linalg.matrix_power(a["sq"], 3), ()),
    ("matrix_power_-2", lambda P, a: P.linalg.matrix_power(a["sq"], -2), ()),
    ("matrix_power_0", lambda P, a: P.linalg.matrix_power(a["sq"], 0), ()),
    ("det", lambda P, a: P.linalg.det(a["sq"]), ()),
    ("slogdet", lambda P, a: P.linalg.slogdet(a["sq"]), ()),
    ("solve", lambda P, a: P.linalg.solve(a["sq"], a["rhs"]), ()),
    ("triangular_solve", lambda P, a: P.linalg.triangular_solve(
        a["sq"], a["rhs"]), ()),
    ("triangular_solve_lower_t_unit", lambda P, a: P.linalg.triangular_solve(
        a["sq"], a["rhs"], upper=False, transpose=True,
        unitriangular=True), ()),
    ("triangular_solve_upper_t", lambda P, a: P.linalg.triangular_solve(
        a["sq"], a["rhs"], upper=True, transpose=True), ()),
    ("pinv", lambda P, a: P.linalg.pinv(a["tall"]), ()),
    ("matrix_rank", lambda P, a: P.linalg.matrix_rank(a["tall"]), ()),
    ("matrix_rank_tol", lambda P, a: P.linalg.matrix_rank(a["sq"], tol=0.5),
     ()),
    ("lstsq_tall", lambda P, a: P.linalg.lstsq(a["tall"], a["b6"]), ()),
    ("lstsq_wide", lambda P, a: P.linalg.lstsq(
        P.transpose(a["b6"], [1, 0]), a["obs"][:2, :2]), ()),
    ("multi_dot", lambda P, a: P.linalg.multi_dot(
        [a["tall"], P.transpose(a["tall"], [1, 0]), a["b6"]]), ()),
    ("cond", lambda P, a: P.linalg.cond(a["sq"]), ()),
    ("cond_fro", lambda P, a: P.linalg.cond(a["sq"], p="fro"), ()),
    ("cholesky_solve", lambda P, a: P.linalg.cholesky_solve(
        a["rhs"], P.linalg.cholesky(a["spd"])), ()),
    ("cholesky_solve_upper", lambda P, a: P.linalg.cholesky_solve(
        a["rhs"], P.linalg.cholesky(a["spd"], upper=True), upper=True), ()),
    ("corrcoef", lambda P, a: P.linalg.corrcoef(a["obs"]), ()),
    ("corrcoef_cols", lambda P, a: P.linalg.corrcoef(
        a["tall"], rowvar=False), ()),
    ("cov", lambda P, a: P.linalg.cov(a["obs"]), ()),
    ("cov_biased_cols", lambda P, a: P.linalg.cov(
        a["tall"], rowvar=False, ddof=False), ()),
    ("cov_weights", lambda P, a: P.linalg.cov(
        a["obs"][:, :6], fweights=P.to_tensor(np.arange(1, 7)),
        aweights=P.to_tensor(np.linspace(0.5, 2.0, 6).astype(
            a["obs"].numpy().dtype))), ()),
    ("eigvalsh", lambda P, a: P.linalg.eigvalsh(a["spd"]), ()),
    ("eigvalsh_U", lambda P, a: P.linalg.eigvalsh(a["spd"], UPLO="U"), ()),
    ("lu", lambda P, a: P.linalg.lu(a["sq"]), ()),
    ("householder_product", lambda P, a: P.linalg.householder_product(
        a["tall"], a["obs"][0, :3]), ()),
    ("svd_values", lambda P, a: P.linalg.svd(a["tall"])[1], ()),
]


def _run(P, dtype, fn):
    arrays = {k: P.to_tensor(v) for k, v in _inputs(dtype).items()}
    out = fn(P, arrays)
    return out if isinstance(out, (tuple, list)) else (out,)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,fn,_", VALUE_CASES,
                         ids=[c[0] for c in VALUE_CASES])
def test_values_match_reference(name, fn, _, dtype):
    want = _run(ref, dtype, fn)
    got = _run(paddle, dtype, fn)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gn, wn = _np(g), _np(w)
        assert gn.shape == wn.shape, name
        if wn.dtype.kind == "f":
            assert gn.dtype == np.dtype(dtype), (name, gn.dtype)
        else:
            assert gn.dtype == wn.dtype, (name, gn.dtype, wn.dtype)
        np.testing.assert_allclose(gn, wn, rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_svd_invariants(dtype):
    tol = TOL[dtype]
    a = _inputs(dtype)["tall"]
    for full in (False, True):
        u, s, vh = (_np(t) for t in paddle.linalg.svd(paddle.to_tensor(a),
                                                      full_matrices=full))
        ru, rs_, rvh = (_np(t) for t in ref.linalg.svd(ref.to_tensor(a),
                                                       full_matrices=full))
        assert u.dtype == np.dtype(dtype) and u.shape == ru.shape
        k = s.shape[-1]
        np.testing.assert_allclose(u[:, :k] * s @ vh[:k], a, atol=tol * 10)
        np.testing.assert_allclose(s, rs_, rtol=tol, atol=tol)
        np.testing.assert_allclose(np.abs(u[:, :k]), np.abs(ru[:, :k]),
                                   atol=tol * 10)
        np.testing.assert_allclose(np.abs(vh), np.abs(rvh), atol=tol * 10)
        np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]),
                                   atol=tol * 10)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
def test_qr_invariants(dtype, mode):
    tol = TOL[dtype]
    a = _inputs(dtype)["tall"]
    got = paddle.linalg.qr(paddle.to_tensor(a), mode=mode)
    want = ref.linalg.qr(ref.to_tensor(a), mode=mode)
    if mode == "r":
        np.testing.assert_allclose(np.abs(_np(got)), np.abs(_np(want)),
                                   atol=tol * 10)
        return
    q, r = _np(got[0]), _np(got[1])
    assert q.shape == _np(want[0]).shape and r.shape == _np(want[1]).shape
    assert q.dtype == np.dtype(dtype)
    np.testing.assert_allclose(q @ r, a, atol=tol * 10)
    np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), atol=tol * 10)
    np.testing.assert_allclose(r, np.triu(r), atol=0)
    np.testing.assert_allclose(np.abs(r), np.abs(_np(want[1])),
                               atol=tol * 10)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_eigh_invariants(dtype):
    tol = TOL[dtype]
    a = _inputs(dtype)["spd"]
    w, v = (_np(t) for t in paddle.linalg.eigh(paddle.to_tensor(a)))
    rw, rv = (_np(t) for t in ref.linalg.eigh(ref.to_tensor(a)))
    assert w.dtype == np.dtype(dtype)
    np.testing.assert_allclose(w, rw, rtol=tol, atol=tol)
    np.testing.assert_allclose(v @ (w[..., None] * np.swapaxes(v, -1, -2)),
                               a, rtol=tol, atol=tol * 100)
    np.testing.assert_allclose(np.abs(v), np.abs(rv), atol=tol * 10)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_eig_invariants(dtype):
    tol = TOL[dtype]
    a = _inputs(dtype)["sq"][0]
    w, v = (_np(t) for t in paddle.linalg.eig(paddle.to_tensor(a)))
    rw, _ = (_np(t) for t in ref.linalg.eig(ref.to_tensor(a)))
    assert w.dtype == (np.complex64 if dtype == "float32" else np.complex128)
    key = lambda z: (np.round(z.real, 4), np.round(z.imag, 4))  # noqa: E731
    np.testing.assert_allclose(sorted(w, key=key), sorted(rw, key=key),
                               rtol=tol * 10, atol=tol * 10)
    np.testing.assert_allclose(a @ v, v * w, atol=tol * 100)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lu_reconstructs_with_reference_pivots(dtype):
    tol = TOL[dtype]
    a = _inputs(dtype)["sq"]
    lu_, piv, info = (_np(t) for t in paddle.linalg.lu(paddle.to_tensor(a),
                                                       get_infos=True))
    _, rpiv, rinfo = (_np(t) for t in ref.linalg.lu(ref.to_tensor(a),
                                                    get_infos=True))
    np.testing.assert_array_equal(piv, rpiv)
    np.testing.assert_array_equal(info, rinfo)
    assert piv.dtype == np.int32 and info.dtype == np.int32
    for i in range(a.shape[0]):
        L = np.tril(lu_[i], -1) + np.eye(4)
        U = np.triu(lu_[i])
        P = np.eye(4)
        for j, p in enumerate(piv[i]):
            P[[j, p - 1]] = P[[p - 1, j]]
        np.testing.assert_allclose(P @ a[i], L @ U, atol=tol * 10)


GRAD_CASES = [
    ("cholesky", lambda P, a: P.linalg.cholesky(a["spd"]), "spd"),
    ("inv", lambda P, a: P.linalg.inv(a["sq"]), "sq"),
    ("matrix_power", lambda P, a: P.linalg.matrix_power(a["sq"], 3), "sq"),
    ("det", lambda P, a: P.linalg.det(a["sq"]), "sq"),
    ("slogdet", lambda P, a: P.linalg.slogdet(a["sq"])[1], "sq"),
    ("solve", lambda P, a: P.linalg.solve(a["sq"], a["rhs"]), "sq"),
    ("triangular_solve", lambda P, a: P.linalg.triangular_solve(
        a["sq"], a["rhs"], upper=False), "sq"),
    ("multi_dot", lambda P, a: P.linalg.multi_dot(
        [a["tall"], P.transpose(a["tall"], [1, 0])]), "tall"),
    ("cholesky_solve", lambda P, a: P.linalg.cholesky_solve(
        a["rhs"], P.linalg.cholesky(a["spd"])), "rhs"),
]


@pytest.mark.parametrize("name,fn,leaf", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_grads_match_reference(name, fn, leaf):
    grads = []
    for P in (ref, paddle):
        arrays = {k: P.to_tensor(v) for k, v in _inputs("float32").items()}
        arrays[leaf].stop_gradient = False
        out = fn(P, arrays)
        w = P.to_tensor(np.linspace(-1, 1, int(np.prod(out.shape)))
                        .reshape(out.shape).astype("float32"))
        P.sum(out * w).backward()
        grads.append(_np(arrays[leaf].grad))
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-4, atol=1e-4,
                               err_msg=name)


# ------------------------------ tests/test_ops_round2.py:19-65 on the port

def T(a, dtype=None):
    return paddle.to_tensor(np.asarray(a, dtype=dtype))


def test_lu_reconstructs():
    rs = np.random.RandomState(0)
    a = rs.randn(4, 4).astype("float32")
    lu, piv = paddle.lu(T(a))
    lu_np, piv_np = np.asarray(lu.numpy()), np.asarray(piv.numpy())
    L = np.tril(lu_np, -1) + np.eye(4, dtype="float32")
    U = np.triu(lu_np)
    P = np.eye(4, dtype="float32")
    for i, p in enumerate(piv_np):
        P[[i, p - 1]] = P[[p - 1, i]]
    np.testing.assert_allclose(P @ a, L @ U, rtol=1e-4, atol=1e-5)


def test_lu_get_infos():
    a = np.eye(3, dtype="float32")
    lu, piv, info = paddle.lu(T(a), get_infos=True)
    assert np.asarray(info.numpy()).sum() == 0


def test_cholesky_solve():
    rs = np.random.RandomState(1)
    m = rs.randn(3, 3).astype("float32")
    a = m @ m.T + 3 * np.eye(3, dtype="float32")
    b = rs.randn(3, 2).astype("float32")
    L = np.linalg.cholesky(a).astype("float32")
    out = paddle.cholesky_solve(T(b), T(L), upper=False)
    np.testing.assert_allclose(np.asarray(out.numpy()),
                               np.linalg.solve(a, b), rtol=1e-3, atol=1e-4)


def test_eig_eigenvalues():
    a = np.diag([1.0, 2.0, 3.0]).astype("float32")
    w, v = paddle.eig(T(a))
    np.testing.assert_allclose(sorted(np.asarray(w.numpy()).real),
                               [1, 2, 3], rtol=1e-5)


def test_corrcoef_cov():
    rs = np.random.RandomState(2)
    x = rs.randn(3, 50).astype("float32")
    np.testing.assert_allclose(np.asarray(paddle.corrcoef(T(x)).numpy()),
                               np.corrcoef(x), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(paddle.cov(T(x)).numpy()),
                               np.cov(x), rtol=1e-4, atol=1e-5)


def test_linalg_names_bound_as_the_reference_binds_them():
    names = ["cholesky", "det", "slogdet", "matrix_power", "pinv", "lstsq",
             "solve", "triangular_solve", "cholesky_solve", "matrix_rank",
             "multi_dot", "svd", "qr", "eig", "eigh", "eigvalsh", "lu",
             "householder_product", "corrcoef", "cov", "inverse"]
    for n in names:
        assert hasattr(ref, n) and getattr(paddle, n) is getattr(
            paddle.linalg, n), n
    assert paddle.tensor.linalg is paddle.linalg
    for n in ("inv", "cond", "norm", "matmul", "dist"):
        assert hasattr(ref.linalg, n) and hasattr(paddle.linalg, n), n
