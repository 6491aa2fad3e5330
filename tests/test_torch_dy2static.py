"""paddle_tpu_torch's dy2static (``jit/dy2static.py``) against the JAX
package's on the CPU: the scenarios of ``tests/test_dy2static.py``,
``test_dy2static_loops.py``, ``test_dy2static_returns.py``, three seeds
of each generator of ``test_dy2static_loop_fuzz.py`` (the three legs:
plain Python, converted eagerly, converted under ``to_static``) and
``test_to_static.py``'s ``static.nn`` control flow, each run through both
packages on the same seeded inputs. The reference compiles its step
(``lax.cond``/``while_loop`` inside one XLA program); the port, on the
CPU, records the step and then calls it eagerly, running the branch the
predicate picks.

Values equal, or within rtol 1e-6 where f32 arithmetic is involved; the
same warnings and errors (the fall-backs' ``UserWarning``, the
``UnboundLocalError`` naming the variable, the static-shapes
``TypeError``); the converted AST of one function of each kind equal to
the reference's (``ast.dump`` of both rewrites); and the reference's
"a cond's outputs carry no grad", in both packages.
"""
import ast
import importlib.util
import itertools
import sys
import tempfile
import textwrap
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu.jit import dy2static as ref_d2s
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.jit import dy2static as d2s

RTOL = 1e-6
PACKAGES = (ref, paddle)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _np(t):
    return np.asarray(t.numpy())


def _same(scenario):
    """Run ``scenario(P)`` on both packages; its outputs (nested lists of
    arrays and scalars) must agree."""
    got = [scenario(P) for P in PACKAGES]
    for a, b in zip(*got):
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64), rtol=RTOL,
                                   atol=1e-7)
    return got


# -- tests/test_dy2static.py ------------------------------------------------

def test_tensor_if_both_directions_after_compile():
    def s(P):
        @P.jit.to_static
        def f(x):
            if x.sum() > 0:
                y = x * 2.0
            else:
                y = x - 1.0
            return y

        xp = np.ones((4,), np.float32)
        outs = [_np(f(P.to_tensor(xp))) for _ in range(3)]
        outs.append(_np(f(P.to_tensor(-xp))))
        return outs
    got = _same(s)
    np.testing.assert_allclose(got[1][-1], -np.ones(4) - 1)


def test_python_if_keeps_python_semantics():
    def s(P):
        @P.jit.to_static
        def f(x, flag):
            if flag:
                y = x + 1
            else:
                y = x - 1
            return y

        x = P.to_tensor(np.zeros(2, np.float32))
        return [_np(f(x, True)), _np(f(x, False))]
    _same(s)


def test_branch_reading_pre_if_value():
    def s(P):
        @P.jit.to_static
        def f(x):
            y = x + 1.0
            if x.sum() > 0:
                y = y * 10.0
            else:
                y = y * -1.0
            return y

        xp = np.ones((2,), np.float32)
        outs = [_np(f(P.to_tensor(xp))) for _ in range(3)]
        return outs + [_np(f(P.to_tensor(-xp)))]
    _same(s)


def test_tensor_while_loop():
    def s(P):
        @P.jit.to_static
        def f(x):
            s = x * 0.0
            i = P.to_tensor(np.float32(0.0))
            while i < 5.0:
                s = s + x
                i = i + 1.0
            return s

        xp = np.full((3,), 2.0, np.float32)
        return [_np(f(P.to_tensor(xp))) for _ in range(3)]
    got = _same(s)
    np.testing.assert_allclose(got[1][-1], np.full(3, 10.0))


def test_python_while_unrolls():
    def s(P):
        @P.jit.to_static
        def f(x):
            s = x * 0.0
            i = 0
            while i < 3:
                s = s + x
                i = i + 1
            return s

        return [_np(f(P.to_tensor(np.ones((2,), np.float32))))]
    _same(s)


def test_short_circuit_preserved_for_python_values():
    def s(P):
        conv = (ref_d2s if P is ref else d2s).convert_to_static

        def f(x, obj):
            if obj is not None and obj["key"] > 0:
                y = x + 1.0
            else:
                y = x - 1.0
            return y

        g = conv(f)
        x = P.to_tensor(np.zeros(2, np.float32))
        return [_np(g(x, None)), _np(g(x, {"key": 5}))]
    _same(s)


def test_tensor_logical_ops():
    def s(P):
        m = ref_d2s if P is ref else d2s
        a = P.to_tensor(np.array([True, False]))
        b = P.to_tensor(np.array([True, True]))
        return [_np(m.convert_logical_and(a, lambda: b)),
                _np(m.convert_logical_or(a, lambda: b)),
                _np(m.convert_logical_not(a))]
    got = _same(s)
    np.testing.assert_array_equal(got[1][0], [True, False])


@pytest.mark.parametrize("m", [ref_d2s, d2s], ids=["reference", "port"])
def test_unconvertible_function_falls_back(m):
    fn = eval("lambda x: x + 1")  # no retrievable source
    with pytest.warns(UserWarning, match="dy2static"):
        out = m.convert_to_static(fn)
    assert out is fn


# -- tests/test_dy2static_loops.py ------------------------------------------

def _entries(fn):
    return len(fn.entries)


def test_for_range_tensor_bound_single_program():
    def s(P):
        @P.jit.to_static
        def f(x, n):
            s = x * 0.0
            for i in range(n):
                s = s + x
            return s

        xp = np.full((3,), 2.0, np.float32)
        outs = [_np(f(P.to_tensor(xp), P.to_tensor(np.int64(5))))
                for _ in range(3)]
        n = _entries(f)
        outs.append(_np(f(P.to_tensor(xp), P.to_tensor(np.int64(9)))))
        assert _entries(f) == n   # a new trip count is not a new entry
        return outs
    got = _same(s)
    np.testing.assert_allclose(got[1][-1], np.full(3, 18.0))


def test_for_range_python_bounds_keep_python_semantics():
    def s(P):
        @P.jit.to_static
        def f(x):
            s = x * 0.0
            for i in range(4):
                s = s + x * float(i)
            return s

        return [_np(f(P.to_tensor(np.ones((2,), np.float32))))
                for _ in range(3)]
    _same(s)


def test_for_range_start_stop_step_tensor():
    def s(P):
        @P.jit.to_static
        def f(x, start, stop):
            s = x * 0.0
            for i in range(start, stop, 2):
                s = s + x
            return s

        xp = np.ones((2,), np.float32)
        return [_np(f(P.to_tensor(xp), P.to_tensor(np.int64(1)),
                      P.to_tensor(np.int64(8)))) for _ in range(3)]
    got = _same(s)
    np.testing.assert_allclose(got[1][-1], [4.0, 4.0])


def test_break_with_tensor_predicate_in_tensor_loop():
    def s(P):
        @P.jit.to_static
        def f(x, n, cap):
            s = x * 0.0
            for i in range(n):
                if s.sum() >= cap:
                    break
                s = s + x
            return s

        xp = np.ones((2,), np.float32)
        outs = [_np(f(P.to_tensor(xp), P.to_tensor(np.int64(100)),
                      P.to_tensor(np.float32(6.0)))) for _ in range(3)]
        outs.append(_np(f(P.to_tensor(xp), P.to_tensor(np.int64(100)),
                          P.to_tensor(np.float32(10.0)))))
        return outs
    got = _same(s)
    np.testing.assert_allclose(got[1][-1], [5.0, 5.0])


def test_continue_with_tensor_predicate():
    def s(P):
        @P.jit.to_static
        def f(x, n):
            s = x * 0.0
            t = P.to_tensor(np.float32(0.0))
            for i in range(n):
                t = t + 1.0
                if P.sum(t % 2.0) > 0.5:
                    continue
                s = s + x
            return s

        xp = np.ones((2,), np.float32)
        return [_np(f(P.to_tensor(xp), P.to_tensor(np.int64(10))))
                for _ in range(3)]
    got = _same(s)
    np.testing.assert_allclose(got[1][-1], [5.0, 5.0])


def test_break_continue_python_loop_python_preds():
    def s(P):
        @P.jit.to_static
        def f(x, n):
            s = x * 0.0
            for i in range(n):
                if i == 2:
                    continue
                if i >= 5:
                    break
                s = s + x * float(i)
            return s

        return [_np(f(P.to_tensor(np.ones((2,), np.float32)), 100))]
    got = _same(s)
    np.testing.assert_allclose(got[1][0], [8.0, 8.0])


def test_break_tensor_pred_in_python_bounded_loop():
    def s(P):
        @P.jit.to_static
        def f(x, cap):
            s = x * 0.0
            for i in range(10):
                if s.sum() >= cap:
                    break
                s = s + x
            return s

        xp = np.ones((2,), np.float32)
        outs = [_np(f(P.to_tensor(xp), P.to_tensor(np.float32(4.0))))
                for _ in range(3)]
        outs.append(_np(f(P.to_tensor(xp), P.to_tensor(np.float32(12.0)))))
        return outs
    _same(s)


def test_while_with_break_flags():
    def s(P):
        @P.jit.to_static
        def f(x, cap):
            s = x * 0.0
            i = P.to_tensor(np.float32(0.0))
            while i < 100.0:
                if s.sum() >= cap:
                    break
                s = s + x
                i = i + 1.0
            return s

        xp = np.ones((2,), np.float32)
        return [_np(f(P.to_tensor(xp), P.to_tensor(np.float32(6.0))))
                for _ in range(3)]
    _same(s)


def test_for_iter_over_tensor_rows():
    def s(P):
        @P.jit.to_static
        def f(m):
            s = m[0] * 0.0
            for row in m:
                s = s + row * 2.0
            return s

        mp = np.arange(12, dtype=np.float32).reshape(4, 3)
        return [_np(f(P.to_tensor(mp))) for _ in range(3)]
    got = _same(s)
    np.testing.assert_allclose(got[1][-1], np.arange(12).reshape(4, 3)
                               .sum(0) * 2.0)


def test_for_iter_python_list_unchanged():
    def s(P):
        @P.jit.to_static
        def f(x, ks):
            s = x * 0.0
            for k in ks:
                s = s + x * float(k)
            return s

        return [_np(f(P.to_tensor(np.ones((2,), np.float32)), [1, 2, 3]))]
    _same(s)


def test_list_append_in_python_loop():
    def s(P):
        @P.jit.to_static
        def f(x):
            outs = []
            for i in range(3):
                outs.append(x * float(i + 1))
            return P.stack(outs).sum(0)

        return [_np(f(P.to_tensor(np.ones((2,), np.float32))))
                for _ in range(3)]
    _same(s)


@pytest.mark.parametrize("P", PACKAGES, ids=["reference", "port"])
def test_list_append_under_tensor_trip_count_raises(P):
    m = ref_d2s if P is ref else d2s

    def f(x, n):
        outs = []
        for i in range(n):
            outs.append(x)
        return outs

    g = m.convert_to_static(f)
    with pytest.raises(TypeError, match="static shapes"):
        g(P.to_tensor(np.ones(2, np.float32)), P.to_tensor(np.int64(3)))


def test_nested_loops_inner_break_stays_inner():
    def s(P):
        @P.jit.to_static
        def f(x):
            s = x * 0.0
            for i in range(3):
                for j in range(5):
                    if j >= 2:
                        break
                    s = s + x
            return s

        return [_np(f(P.to_tensor(np.ones((2,), np.float32))))]
    got = _same(s)
    np.testing.assert_allclose(got[1][0], [6.0, 6.0])


def test_loop_eager_matches_compiled():
    def s(P):
        m = ref_d2s if P is ref else d2s

        def f(x, n, cap):
            s = x * 0.0
            for i in range(n):
                if s.sum() >= cap:
                    break
                s = s + x
            return s

        g = m.convert_to_static(f)
        return [_np(g(P.to_tensor(np.ones((2,), np.float32)),
                      P.to_tensor(np.int64(50)),
                      P.to_tensor(np.float32(7.0))))]
    got = _same(s)
    np.testing.assert_allclose(got[1][0], [4.0, 4.0])


def test_break_tensor_pred_accumulate_before_check():
    def s(P):
        @P.jit.to_static
        def f(x, cap):
            s = x * 0.0
            for i in range(10):
                s = s + x
                if s.sum() >= cap:
                    break
            return s

        xp = np.ones((2,), np.float32)
        outs = [_np(f(P.to_tensor(xp), P.to_tensor(np.float32(4.0))))
                for _ in range(3)]
        outs.append(_np(f(P.to_tensor(xp), P.to_tensor(np.float32(100.0)))))
        return outs
    _same(s)


@pytest.mark.parametrize("P", PACKAGES, ids=["reference", "port"])
def test_while_tensor_cond_append_raises_friendly(P):
    m = ref_d2s if P is ref else d2s

    def f(x, n):
        lst = []
        i = P.to_tensor(np.float32(0.0))
        while i < n:
            lst.append(x)
            i = i + 1.0
        return lst

    g = m.convert_to_static(f)
    with pytest.raises(TypeError, match="static shapes"):
        g(P.to_tensor(np.ones(2, np.float32)),
          P.to_tensor(np.float32(3.0)))


@pytest.mark.parametrize("P", PACKAGES, ids=["reference", "port"])
def test_cross_iteration_undefined_carry_names_variable(P):
    m = ref_d2s if P is ref else d2s

    def f(x, n):
        s = x * 0.0
        i = P.to_tensor(np.float32(0.0))
        while i < n:
            if i > 0.5:
                s = s + prev  # noqa: F821
            prev = s + x
            i = i + 1.0
        return s

    g = m.convert_to_static(f)
    with pytest.raises(UnboundLocalError, match="prev"):
        g(P.to_tensor(np.ones(2, np.float32)), P.to_tensor(np.float32(3.0)))


def test_python_break_does_not_leak_loop_variable():
    def s(P):
        m = ref_d2s if P is ref else d2s

        def f(x):
            last = -1
            for i in range(10):
                if i >= 5:
                    break
                last = i
            return x + float(i), last

        out, last = m.convert_to_static(f)(P.to_tensor(
            np.zeros(1, np.float32)))

        def h(x, it):
            for v in it:
                if v >= 3:
                    break
            return x

        it = iter([1, 2, 3, 4, 5])
        m.convert_to_static(h)(P.to_tensor(np.zeros(1, np.float32)), it)
        return [_np(out), last, list(it)]
    got = _same(s)
    assert got[1][1] == 4 and got[1][2] == [4, 5]


# -- tests/test_dy2static_returns.py ----------------------------------------

def test_guard_clause_tensor_pred_single_program():
    def s(P):
        @P.jit.to_static
        def f(x):
            if x.sum() > 0:
                return x * 2.0
            return x - 1.0

        pos = np.ones((3,), np.float32)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            outs = [_np(f(P.to_tensor(pos))) for _ in range(3)]
        n = _entries(f)
        outs.append(_np(f(P.to_tensor(-pos))))
        assert _entries(f) == n
        return outs
    _same(s)


def test_if_else_both_return():
    def s(P):
        @P.jit.to_static
        def f(x):
            if x.mean() > 1.0:
                return x / 2.0
            else:
                return x + 3.0

        big = np.full((4,), 4.0, np.float32)
        outs = [_np(f(P.to_tensor(big))) for _ in range(3)]
        return outs + [_np(f(P.to_tensor(np.zeros((4,), np.float32))))]
    _same(s)


def test_elif_chain_returns():
    def s(P):
        @P.jit.to_static
        def f(x):
            s = x.sum()
            if s > 10.0:
                return x * 10.0
            elif s > 0.0:
                return x * 1.0
            else:
                return x * -1.0

        outs = []
        for arr in (np.full((3,), 5.0, np.float32),
                    np.full((3,), 0.5, np.float32),
                    np.full((3,), -2.0, np.float32)):
            outs += [_np(f(P.to_tensor(arr))) for _ in range(3)]
        return outs
    _same(s)


def test_early_return_then_trailing_code():
    def s(P):
        @P.jit.to_static
        def f(x, y):
            if x.max() > 100.0:
                return x
            z = x + y
            if z.sum() > 0:
                z = z * 2.0
            return z

        x = np.ones((2,), np.float32)
        outs = [_np(f(P.to_tensor(x), P.to_tensor(x))) for _ in range(3)]
        big = np.full((2,), 200.0, np.float32)
        return outs + [_np(f(P.to_tensor(big), P.to_tensor(x)))]
    _same(s)


def test_nested_all_paths_return():
    def s(P):
        @P.jit.to_static
        def f(x):
            if x.sum() > 0:
                if x.max() > 2.0:
                    return x * 4.0
                return x * 2.0
            return x * -1.0

        outs = []
        for arr in (np.full((3,), 3.0, np.float32),
                    np.full((3,), 0.5, np.float32),
                    np.full((3,), -1.0, np.float32)):
            outs += [_np(f(P.to_tensor(arr))) for _ in range(3)]
        return outs
    _same(s)


def test_python_pred_early_return_keeps_python_semantics():
    def s(P):
        @P.jit.to_static
        def f(x, flag):
            if flag:
                return x * 2.0
            return x + 1.0

        xp = np.ones((2,), np.float32)
        outs = [_np(f(P.to_tensor(xp), True)) for _ in range(3)]
        return outs + [_np(f(P.to_tensor(xp), False))]
    _same(s)


@pytest.mark.parametrize("m", [ref_d2s, d2s], ids=["reference", "port"])
def test_fallthrough_returns_none_python_pred(m):
    def f(x):
        if x > 3:
            return x * 2
        x + 1

    g = m.convert_to_static(f)
    assert getattr(g, "__wrapped_dy2static__", False)
    assert g(5) == 10
    assert g(1) is None


def test_return_inside_loop_falls_back_with_warning():
    def s(P):
        m = ref_d2s if P is ref else d2s

        def f(x, n):
            for i in range(n):
                if i == 2:
                    return x * float(i)
                x = x + 1.0
            return x

        with pytest.warns(UserWarning, match="early-return conversion"):
            g = m.convert_to_static(f)
        return [_np(g(P.to_tensor(np.ones((2,), np.float32)), 5))]
    _same(s)


def test_returns_compose_with_converted_loops():
    def s(P):
        @P.jit.to_static
        def f(x, n):
            if x.min() > 50.0:
                return x
            s = x * 0.0
            for i in range(n):
                s = s + x
            return s

        xp = np.full((3,), 2.0, np.float32)
        outs = [_np(f(P.to_tensor(xp), P.to_tensor(np.int64(4))))
                for _ in range(3)]
        n = _entries(f)
        outs.append(_np(f(P.to_tensor(xp), P.to_tensor(np.int64(7)))))
        assert _entries(f) == n
        return outs
    _same(s)


def test_return_differential_vs_eager():
    def s(P):
        def body(x, y):
            if x.sum() > 4.0:
                return x - y
            if y.sum() > 4.0:
                return x + y
            z = x * y
            if z.mean() > 0:
                return z * 3.0
            return z

        conv = P.jit.to_static(body)
        rs = np.random.RandomState(0)
        outs = []
        for _ in range(8):
            xp = rs.randn(3).astype(np.float32) * 3
            yp = rs.randn(3).astype(np.float32) * 3
            want = _np(body(P.to_tensor(xp), P.to_tensor(yp)))
            got = _np(conv(P.to_tensor(xp), P.to_tensor(yp)))
            np.testing.assert_allclose(got, want, rtol=RTOL)
            outs.append(got)
        return outs
    _same(s)


def test_return_inside_tensor_bound_loop():
    def s(P):
        @P.jit.to_static
        def f(n, x):
            for _i in range(n):
                x = x + 1.0
                if x.sum() > 6.0:
                    return x
            return x * 10.0

        outs = []
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            for n0, x0 in ((5, np.ones((3,), np.float32)),
                           (1, np.zeros((3,), np.float32))):
                outs.append(_np(f(P.to_tensor(n0), P.to_tensor(x0))))
        return outs
    got = _same(s)
    np.testing.assert_allclose(got[1][1], np.full(3, 10.0))


def test_return_inside_while_loop_tensor_pred():
    def s(P):
        @P.jit.to_static
        def f(x):
            while x.sum() < 100.0:
                x = x * 2.0
                if x.max() > 40.0:
                    return x
            return x + 0.5

        return [_np(f(P.to_tensor(np.full((3,), v, np.float32))))
                for v in (1.0, 30.0, 200.0)]
    _same(s)


def test_return_inside_nested_loops_cascades():
    def s(P):
        @P.jit.to_static
        def f(n, x):
            for _i in range(n):
                for _j in range(n):
                    x = x + 1.0
                    if x.sum() > 9.0:
                        return x
            return x - 100.0

        return [_np(f(P.to_tensor(n0), P.to_tensor(x0)))
                for n0, x0 in ((3, np.ones((2,), np.float32)),
                               (1, np.zeros((2,), np.float32)))]
    _same(s)


def test_return_expr_in_loop_falls_back_with_warning():
    def s(P):
        def g(n, x):
            for _i in range(n):
                x = x + 1.0
                if x.sum() > 2.0:
                    return x * 7.0
            return x

        with pytest.warns(UserWarning, match="early-return conversion"):
            f = P.jit.to_static(g)
            out = f(4, P.to_tensor(np.ones((2,), np.float32)))
        return [_np(out)]
    got = _same(s)
    np.testing.assert_allclose(got[1][0], [14.0, 14.0])


def test_return_loop_local_name_falls_back():
    def s(P):
        def g(x):
            while x.sum() < 100.0:
                t = x * 3.0
                if t.max() > 40.0:
                    return t
                x = x + 5.0
            return x + 0.5

        with pytest.warns(UserWarning, match="early-return conversion"):
            f = P.jit.to_static(g)
            out = f(P.to_tensor(np.full((3,), 1.0, np.float32)))
        return [_np(out)]
    got = _same(s)
    np.testing.assert_allclose(got[1][0], np.full(3, 48.0))


def test_return_and_break_in_same_loop():
    def s(P):
        @P.jit.to_static
        def f(n, x):
            for _i in range(n):
                x = x + 1.0
                if x.mean() > 10.0:
                    break
                if x.sum() > 12.0:
                    return x
            return x * 100.0

        return [_np(f(P.to_tensor(n0), P.to_tensor(x0)))
                for n0, x0 in ((20, np.full((4,), 0.0, np.float32)),
                               (20, np.full((2,), 5.0, np.float32)),
                               (2, np.zeros((3,), np.float32)))]
    _same(s)


def test_return_in_loop_with_continue():
    def s(P):
        @P.jit.to_static
        def f(n, x):
            for i in range(n):
                if i % 2 == 0:
                    continue
                x = x + 2.0
                if x.sum() > 10.0:
                    return x
            return x - 0.5

        return [_np(f(n0, P.to_tensor(np.ones((2,), np.float32))))
                for n0 in (9, 2)]
    _same(s)


# -- tests/test_dy2static_loop_fuzz.py: the three legs ----------------------

_COUNTER = itertools.count()


def _make_fn(src, name, package):
    src = src.replace("import paddle_tpu as paddle",
                      f"import {package} as paddle")
    mod_name = f"_torch_loopfuzz_{next(_COUNTER)}"
    f = tempfile.NamedTemporaryFile("w", suffix=".py", delete=False)
    f.write(textwrap.dedent(src))
    f.close()
    spec = importlib.util.spec_from_file_location(mod_name, f.name)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return getattr(mod, name)


def _fuzz():
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    import test_dy2static_loop_fuzz as fuzz
    return fuzz


def _legs(P, conv, f, truth, args_t, args_truth):
    want = _np(truth(*args_truth(P)))
    got_eager = _np(conv(f)(*args_t(P)))
    h = P.jit.to_static(f)
    for _ in range(3):
        got_c = h(*args_t(P))
    return [want, got_eager, _np(got_c)]


@pytest.mark.parametrize("seed", range(3))
def test_loop_program_three_leg_parity(seed):
    fuzz = _fuzz()
    rs = np.random.RandomState(1000 + seed)
    src, bound, tensor_bound = fuzz._gen_program(rs)
    xp = rs.rand(3).astype(np.float32) + 0.2
    out = []
    for P, pkg, m in ((ref, "paddle_tpu", ref_d2s),
                      (paddle, "paddle_tpu_torch", d2s)):
        f = _make_fn(src, "f", pkg)
        truth = _make_fn(src.replace("range(n)", "range(int(n))"), "f",
                         pkg)

        def args_t(P):
            n = P.to_tensor(np.int64(bound)) if tensor_bound else bound
            return P.to_tensor(xp), n
        legs = _legs(P, m.convert_to_static, f, truth, args_t,
                     lambda P: (P.to_tensor(xp), bound))
        for leg in legs[1:]:
            np.testing.assert_allclose(leg, legs[0], rtol=RTOL,
                                       err_msg=src)
        out.append(legs)
    np.testing.assert_allclose(out[1], out[0], rtol=RTOL, err_msg=src)


@pytest.mark.parametrize("seed", range(3))
def test_return_program_three_leg_parity(seed):
    fuzz = _fuzz()
    rs = np.random.RandomState(7000 + seed)
    src = fuzz._gen_return_program(rs)
    xp = rs.randn(3).astype(np.float32)
    yp = rs.randn(3).astype(np.float32)
    out = []
    for P, pkg, m in ((ref, "paddle_tpu", ref_d2s),
                      (paddle, "paddle_tpu_torch", d2s)):
        f = _make_fn(src, "f", pkg)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            legs = _legs(P, m.convert_to_static, f, f,
                         lambda P: (P.to_tensor(xp), P.to_tensor(yp)),
                         lambda P: (P.to_tensor(xp), P.to_tensor(yp)))
        for leg in legs[1:]:
            np.testing.assert_allclose(leg, legs[0], rtol=RTOL,
                                       err_msg=src)
        out.append(legs)
    np.testing.assert_allclose(out[1], out[0], rtol=RTOL, err_msg=src)


@pytest.mark.parametrize("seed", range(3))
def test_loop_return_program_three_leg_parity(seed):
    fuzz = _fuzz()
    rs = np.random.RandomState(8000 + seed)
    src, bound = fuzz._gen_loop_return_program(rs)
    xp = np.abs(rs.randn(3)).astype(np.float32)
    out = []
    for P, pkg, m in ((ref, "paddle_tpu", ref_d2s),
                      (paddle, "paddle_tpu_torch", d2s)):
        f = _make_fn(src, "f", pkg)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            legs = _legs(P, m.convert_to_static, f, f,
                         lambda P: (P.to_tensor(xp),
                                    P.to_tensor(np.int64(bound))),
                         lambda P: (P.to_tensor(xp), bound))
            legs.append(_np(m.convert_to_static(f)(P.to_tensor(xp),
                                                   bound)))
        for leg in legs[1:]:
            np.testing.assert_allclose(leg, legs[0], rtol=RTOL,
                                       err_msg=src)
        out.append(legs)
    np.testing.assert_allclose(out[1], out[0], rtol=RTOL, err_msg=src)


# -- tests/test_to_static.py's static.nn control flow -----------------------

def test_control_flow_cond_while_switch():
    def s(P):
        snn = P.static.nn
        a = P.to_tensor(np.float32(2.0))
        b = P.to_tensor(np.float32(5.0))
        out = [_np(snn.cond(a < b, lambda: a + b, lambda: a - b))]
        i = P.to_tensor(np.int32(0))
        acc = P.to_tensor(np.float32(0.0))
        i_f, s_f = snn.while_loop(
            lambda i, s: i < 10,
            lambda i, s: (i + 1, s + P.cast(i, "float32")), [i, acc])
        out += [_np(i_f), _np(s_f)]
        out.append(_np(snn.switch_case(P.to_tensor(np.int32(1)),
                                       [lambda: a * 1, lambda: a * 10,
                                        lambda: a * 100])))
        out.append(_np(snn.switch_case(P.to_tensor(np.int32(99)),
                                       {1: lambda: a * 10,
                                        3: lambda: a * 100})))
        out.append(_np(snn.case([(a > b, lambda: a), (b > a, lambda: b)])))
        return out
    got = _same(s)
    assert [float(v) for v in got[1]] == [7.0, 10.0, 45.0, 20.0, 200.0, 5.0]


def test_cond_inside_to_static():
    def s(P):
        snn = P.static.nn

        @P.jit.to_static
        def f(x):
            return snn.cond(x.sum() > 0, lambda: x * 2, lambda: x - 1)

        xp = np.ones((4,), np.float32)
        outs = [_np(f(P.to_tensor(xp))) for _ in range(3)]
        return outs + [_np(f(P.to_tensor(-xp)))]
    _same(s)


# -- the converted source against the reference's --------------------------

def _k_if(x):
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = x - 1.0
    return y


def _k_while(x, n):
    s = x * 0.0
    i = 0
    while i < n:
        s = s + x
        i = i + 1
    return s


def _k_for_range(x, n):
    s = x * 0.0
    for i in range(n):
        if s.sum() >= 6.0:
            break
        s = s + x
    return s


def _k_for_iter(m):
    s = m[0] * 0.0
    for row in m:
        if row.sum() > 3.0:
            continue
        s = s + row
    return s


def _k_append(x):
    outs = []
    for i in range(3):
        outs.append(x * float(i + 1))
    return outs


def _k_returns(x, y):
    if x.max() > 100.0:
        return x
    z = x + y
    if z.sum() > 0 and not y.sum() > 5.0:
        return z * 2.0
    return z


def _k_loop_return(n, x):
    for _i in range(n):
        x = x + 1.0
        if x.sum() > 6.0:
            return x
    return x * 10.0


@pytest.mark.parametrize("fn", [_k_if, _k_while, _k_for_range, _k_for_iter,
                                _k_append, _k_returns, _k_loop_return],
                         ids=lambda f: f.__name__)
def test_converted_ast_matches_reference(fn):
    """The three passes give the reference's tree: ``ast.dump`` of the
    port's rewrite equals the reference's (the reference inlines the
    passes in ``convert_to_static``; they are replayed here)."""
    import inspect
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    fdef = tree.body[0]
    fdef.decorator_list = []
    ref_d2s._rewrite_early_returns(fdef)
    tree = ref_d2s._LoopRewriter().visit(tree)
    want = ref_d2s._ControlFlowTransformer().visit(tree)
    got = d2s.converted_ast(fn)
    assert got is not None
    assert ast.dump(got) == ast.dump(want)
    # and both compile to functions that agree
    xp = np.arange(3, dtype=np.float32)
    args = {"_k_if": (xp,), "_k_while": (xp, 3), "_k_for_range": (xp, 5),
            "_k_for_iter": (np.arange(12, dtype=np.float32).reshape(4, 3)
                            / 4.0,),
            "_k_append": (xp,),
            "_k_returns": (xp, xp), "_k_loop_return": (4, xp)}[fn.__name__]
    outs = []
    for P, m in ((ref, ref_d2s), (paddle, d2s)):
        g = m.convert_to_static(fn)
        a = [P.to_tensor(v) if isinstance(v, np.ndarray) else v
             for v in args]
        r = g(*a)
        leaves = r if isinstance(r, tuple) else (r,)
        flat = []
        for v in leaves:
            flat += [_np(t) for t in v] if isinstance(v, list) else [_np(v)]
        outs.append(flat)
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=RTOL)


# -- the reference's caveat: a cond's outputs carry no grad -----------------

@pytest.mark.parametrize("P", PACKAGES, ids=["reference", "port"])
def test_cond_outputs_carry_no_grad(P):
    w = P.to_tensor(np.full((3,), 2.0, np.float32), stop_gradient=False)
    x = P.to_tensor(np.ones((3,), np.float32))
    out = P.static.nn.cond(x.sum() > 0, lambda: x * w, lambda: x - w)
    assert out.stop_gradient
    np.testing.assert_allclose(_np(out), [2.0, 2.0, 2.0])


def test_loss_scale_guard_grads_match():
    """The pattern this slice runs at full width: a Tensor ``if`` on a
    detached loss picks the scale; ``(loss * scale).backward()`` gives the
    same grads in both packages, and the branch follows the data."""
    def s(P):
        w = P.to_tensor(np.array([0.5, -1.0, 2.0], np.float32),
                        stop_gradient=False)

        def step(x, spike):
            loss = (x * w).sum()
            if loss.detach() > spike:
                scale = 0.5
            else:
                scale = 1.0
            (loss * scale).backward()
            return loss

        f = P.jit.to_static(step)
        outs = []
        for spike in (0.0, 100.0, 0.0, 100.0):
            loss = f(P.to_tensor(np.ones(3, np.float32)),
                     P.to_tensor(np.float32(spike)))
            outs += [_np(loss), _np(w.grad)]
            w.clear_grad()
        return outs
    got = _same(s)
    np.testing.assert_allclose(got[1][1], [0.5, 0.5, 0.5])
    np.testing.assert_allclose(got[1][3], [1.0, 1.0, 1.0])


def test_set_code_level_prints_the_converted_source(capsys):
    paddle.jit.set_code_level(100)
    try:
        g = d2s.convert_to_static(_k_if)
    finally:
        paddle.jit.set_code_level(0)
    out = capsys.readouterr().out
    assert "_k_if converted" in out and "__jst_convert_ifelse" in out
    x = paddle.to_tensor(np.ones(2, np.float32))
    np.testing.assert_allclose(_np(g(x)), [2.0, 2.0])
    d2s.convert_to_static(_k_while)
    assert capsys.readouterr().out == ""


def test_enable_ast_false_keeps_the_function():
    def f(x):
        if x.sum() > 0:
            return x * 2.0
        return x

    assert paddle.jit.to_static(f, enable_ast=False)._fn is f
    assert paddle.jit.to_static(f)._fn is not f
    assert getattr(paddle.jit.to_static(f)._fn, "__wrapped_dy2static__")
