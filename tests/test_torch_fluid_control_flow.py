"""fluid-1.x program-construct control flow in the port against the JAX
reference: ``tests/test_fluid_control_flow.py``'s eight cases (While
counter loop and data-dependent bound, StaticRNN prefix sum, training
through the scan, initial memory, the descoped constructs, both records'
serialization round trips) and ``tests/test_advice_round5.py``'s
assign-copies-in-a-While case. Each program is built by the same fluid
code in both packages and run by each package's ``Executor`` on the CPU
on the same seeded feeds; the port's fetches equal the reference's.

Tolerance: rtol 1e-6 (f32 sums of a few terms); integer fetches equal.
"""
import pickle

import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as device_mod

RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    P.set_device("cpu")
    yield
    device_mod._current_place = None


def _static(pkg, build):
    pkg.enable_static()
    try:
        return build(pkg, pkg.fluid.layers)
    finally:
        pkg.disable_static()


def _exe(pkg):
    return pkg.static.Executor(P.CPUPlace() if pkg is P else None)


def _counter(pkg, L):
    main = pkg.static.Program()
    with pkg.static.program_guard(main):
        x = pkg.static.data("x", [2], "float32")
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 5)
        acc = L.fill_constant([2], "float32", 0.0)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            acc2 = acc + x
            L.assign(acc2, output=acc)
            i = L.increment(i, in_place=True)
            L.less_than(i, n, cond=cond)
        out = acc * 1.0
    xp = np.array([1.5, 2.0], np.float32)
    return _exe(pkg).run(main, feed={"x": xp}, fetch_list=[out])


def _bound(pkg, L):
    main = pkg.static.Program()
    with pkg.static.program_guard(main):
        n = pkg.static.data("n", [1], "int64")
        i = L.fill_constant([1], "int64", 0)
        s = L.fill_constant([1], "float32", 0.0)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.assign(s + 2.0, output=s)
            i = L.increment(i, in_place=True)
            L.less_than(i, n, cond=cond)
    exe = _exe(pkg)
    return [exe.run(main, feed={"n": np.array([b], np.int64)},
                    fetch_list=[s])[0] for b in (3, 7)]


def _prefix(pkg, L):
    main = pkg.static.Program()
    with pkg.static.program_guard(main):
        x = pkg.static.data("x", [4, 2, 3], "float32")
        rnn = L.StaticRNN()
        with rnn.step():
            word = rnn.step_input(x)
            prev = rnn.memory(shape=[-1, 3], batch_ref=word)
            hidden = prev + word
            rnn.update_memory(prev, hidden)
            rnn.step_output(hidden)
        out = rnn()
    xp = np.random.RandomState(0).randn(4, 2, 3).astype("float32")
    return _exe(pkg).run(main, feed={"x": xp}, fetch_list=[out])


def _trains(pkg, L):
    main = pkg.static.Program()
    with pkg.static.program_guard(main):
        x = pkg.static.data("x", [3, 2, 1], "float32")
        w = pkg.to_tensor(np.array([2.0], np.float32), stop_gradient=False)
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            prev = rnn.memory(shape=[-1, 1], batch_ref=xt)
            h = prev + xt * w
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        out = rnn()
        loss = pkg.sum(out)
        grads = pkg.static.append_backward(loss)
    xp = np.arange(6, dtype=np.float32).reshape(3, 2, 1)
    return _exe(pkg).run(main, feed={"x": xp},
                         fetch_list=[loss, grads[0][1]])


def _init_mem(pkg, L):
    main = pkg.static.Program()
    with pkg.static.program_guard(main):
        x = pkg.static.data("x", [3, 2, 2], "float32")
        boot = pkg.static.data("boot", [2, 2], "float32")
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            prev = rnn.memory(init=boot)
            h = prev * 0.5 + xt
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        out = rnn()
    xp = np.ones((3, 2, 2), np.float32)
    bp = np.full((2, 2), 4.0, np.float32)
    return _exe(pkg).run(main, feed={"x": xp, "boot": bp},
                         fetch_list=[out])


def _round_trip(kind):
    def case(pkg, L):
        program = __import__(f"{pkg.__name__}.static.program",
                             fromlist=["_serialize_program"])
        main = pkg.static.Program()
        with pkg.static.program_guard(main):
            if kind == "while":
                x = pkg.static.data("x", [2], "float32")
                i = L.fill_constant([1], "int64", 0)
                n = L.fill_constant([1], "int64", 4)
                acc = L.fill_constant([2], "float32", 0.0)
                cond = L.less_than(i, n)
                w = L.While(cond)
                with w.block():
                    L.assign(acc + x, output=acc)
                    i = L.increment(i, in_place=True)
                    L.less_than(i, n, cond=cond)
                out = acc * 2.0
                xp = np.array([1.0, 3.0], np.float32)
            else:
                x = pkg.static.data("x", [3, 2, 2], "float32")
                rnn = L.StaticRNN()
                with rnn.step():
                    xt = rnn.step_input(x)
                    prev = rnn.memory(shape=[-1, 2], batch_ref=xt)
                    h = prev + xt
                    rnn.update_memory(prev, h)
                    rnn.step_output(h)
                out = rnn()
                xp = np.random.RandomState(0).randn(3, 2, 2).astype(
                    "float32")
        exe = _exe(pkg)
        want, = exe.run(main, feed={"x": xp}, fetch_list=[out])
        blob = pickle.dumps(program._serialize_program(main))
        prog2 = program._deserialize_program(pickle.loads(blob))
        got, = exe.run(prog2, feed={"x": xp}, fetch_list=[out.name])
        return want, got, blob
    return case


def _assign_copy(pkg, L):
    main = pkg.static.Program()
    with pkg.static.program_guard(main):
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        snap = L.fill_constant([1], "int64", -1)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            copy = L.assign(i)       # snapshot BEFORE increment
            L.assign(copy, output=snap)
            i2 = L.increment(i, in_place=True)
            L.less_than(i2, n, cond=cond)
    return _exe(pkg).run(main, feed={}, fetch_list=[snap])


CASES = {"while_counter_loop": _counter,
         "while_data_dependent_bound": _bound,
         "static_rnn_prefix_sum": _prefix,
         "static_rnn_trains_through_scan": _trains,
         "static_rnn_with_initial_memory": _init_mem,
         "while_program_serialization_roundtrip": _round_trip("while"),
         "static_rnn_serialization_roundtrip": _round_trip("rnn"),
         "assign_copies_in_static_while": _assign_copy}


def _vals(out):
    return [np.asarray(o) for o in out
            if not isinstance(o, (bytes, bytearray))]


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(name):
    want = _static(R, CASES[name])
    got = _static(P, CASES[name])
    for w, g in zip(_vals(want), _vals(got)):
        assert w.shape == g.shape
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL)
        else:
            np.testing.assert_array_equal(g, w)


def test_assign_snapshot_is_the_pre_increment_value():
    got, = _static(P, _assign_copy)
    np.testing.assert_array_equal(np.asarray(got), [2])


def test_serialized_programs_cross_between_packages():
    """The While and StaticRNN programs the reference serialized run in
    the port, and the port's in the reference (one format)."""
    from paddle_tpu.static import program as rprog
    from paddle_tpu_torch.static import program as pprog
    for kind in ("while", "rnn"):
        case = _round_trip(kind)
        want, _, rblob = _static(R, case)
        _, _, pblob = _static(P, case)
        xp = (np.array([1.0, 3.0], np.float32) if kind == "while" else
              np.random.RandomState(0).randn(3, 2, 2).astype("float32"))
        for prog_mod, blob, pkg in ((pprog, rblob, P), (rprog, pblob, R)):
            prog = prog_mod._deserialize_program(pickle.loads(blob))
            got, = _exe(pkg).run(prog, feed={"x": xp},
                                 fetch_list=[_last_output(prog)])
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=RTOL)


def _last_output(prog):
    """The name the program's last top-level record writes."""
    rec = prog.ops[-1]
    outs = getattr(rec, "out_names", None)
    if outs:
        return outs[0]
    return rec.out_pairs[-1][1]


def test_descoped_constructs_raise():
    from paddle_tpu_torch.core.errors import UnimplementedError
    L = P.fluid.layers
    for ctor in (L.Switch, L.IfElse, L.DynamicRNN,
                 L.reorder_lod_tensor_by_rank):
        with pytest.raises(UnimplementedError, match="PARITY.md"):
            ctor()


def test_while_needs_static_mode():
    with pytest.raises(TypeError, match="static mode"):
        P.fluid.layers.While(P.to_tensor(np.asarray([True])))
