"""paddle_tpu_torch's leak detector (``analysis/birth.py``) on the CPU:
the birth scenarios of ``tests/test_analysis.py`` (``:53`` a forced
leak, ``:107`` a leak out of a converted ``to_static`` step, ``:159``
the hooks off by default, ``:173`` ``birth_of``), rewritten for the
port's target, a Tensor born inside a branch or loop body that escapes
its scope other than as an output; each also run through the reference
where its scenario carries over (the forced leak, the hooks, birth_of).
Plus the report-only ``check_trace``, a step that returns a leaked
Tensor, and a converted step that keeps its Tensors in scope running
clean under tracking with the reference's values.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu import analysis as ref_analysis
from paddle_tpu.core import trace as ref_trace
from paddle_tpu_torch import analysis
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.core import trace as trace_mod
from paddle_tpu_torch.core.tensor import Tensor

HERE = os.path.basename(__file__)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def test_forced_leak_raises_attributed_error():
    """A Tensor made inside a scope and read by an op after the scope
    closed raises a TracerLeakError naming its birth op, scope, birth
    site and escape site (the reference: a tracer captured by the outer
    trace)."""
    with analysis.birth_tracking():
        ctx = trace_mod.TraceContext("record")
        with trace_mod.trace_guard(ctx):
            holder = {}

            def body(x):
                with analysis.subtrace("while_cond"):
                    holder["leak"] = Tensor(x + 1.0)
                return x

            body(torch.zeros(()))
            with pytest.raises(analysis.TracerLeakError) as ei:
                holder["leak"] * 2.0
    (finding,) = ei.value.findings
    assert finding["birth_op"] == "body"
    assert finding["birth_trace"].startswith("while_cond#")
    assert HERE in finding["birth_site"] and HERE in finding["escape_site"]
    msg = str(ei.value)
    for key in ("born in", finding["birth_trace"], "escaped"):
        assert key in msg

    # the reference's own scenario gives the same finding's shape
    import jax
    import jax.numpy as jnp
    with ref_analysis.birth_tracking():
        rctx = ref_trace.TraceContext("record")
        with ref_trace.trace_guard(rctx):
            rholder = {}

            def body(x):  # noqa: F811 - the reference's twin
                with ref_analysis.subtrace("while_cond"):
                    rholder["leak"] = ref.Tensor(x + 1.0)
                return x

            jax.make_jaxpr(body)(jnp.float32(0.0))
            with pytest.raises(ref_analysis.TracerLeakError) as rei:
                rctx.read(rholder["leak"])
    (rfinding,) = rei.value.findings
    assert set(rfinding) == set(finding)
    assert rfinding["birth_op"] == finding["birth_op"]
    assert rfinding["birth_trace"].split("#")[0] == \
        finding["birth_trace"].split("#")[0]


def test_leak_out_of_a_converted_step_is_attributed():
    """A converted to_static step whose Tensor ``if`` stashes a Tensor in
    a dict and reads it after the branch: a TracerLeakError naming the
    op that made it and its cond_true scope (the reference's
    shape: a dy2static while/cond step whose branch value escapes)."""
    holder = {}

    @paddle.jit.to_static
    def sample(x, n):
        s = x * 0.0
        for _ in range(n):
            if s.sum() < 100.0:
                s = s + x
                holder["t"] = s * 2.0
        return s + holder["t"]

    xp = paddle.to_tensor(np.full((8,), 0.5, np.float32))
    with analysis.birth_tracking():
        with pytest.raises(analysis.TracerLeakError) as ei:
            for _ in range(3):
                sample(xp, paddle.to_tensor(np.int64(4)))
    findings = ei.value.findings
    assert findings
    (f,) = findings
    assert f["birth_trace"].startswith("cond_true#")
    assert f["birth_op"] == "elementwise_mul"
    assert HERE in f["birth_site"] and HERE in f["escape_site"]


def test_step_returning_a_leaked_tensor_raises():
    holder = {}

    @paddle.jit.to_static
    def step(x):
        paddle.static.nn.cond(x.sum() > 0,
                              lambda: holder.__setitem__("t", x * 3.0),
                              lambda: None)
        return holder["t"]

    with analysis.birth_tracking():
        with pytest.raises(analysis.TracerLeakError) as ei:
            for _ in range(2):
                step(paddle.to_tensor(np.ones(3, np.float32)))
    (f,) = ei.value.findings
    assert f["birth_trace"].startswith("cond_true#")
    assert f["escape_site"] == "<returned by the step>"


def test_check_trace_reports_without_raising():
    with analysis.birth_tracking():
        ctx = trace_mod.TraceContext("record")
        with trace_mod.trace_guard(ctx):
            with analysis.subtrace("cond_true"):
                leak = Tensor(torch.ones(2) * 2.0)
            analysis.birth._st().captures[id(leak)] = "here"
            findings = analysis.check_trace(ctx, raise_error=False)
    assert len(findings) == 1
    assert findings[0]["birth_trace"].startswith("cond_true#")
    assert set(findings[0]) == {"tensor", "birth_op", "birth_site",
                                "birth_trace", "escape_site"}


def test_converted_step_runs_clean_under_tracking():
    """The while/cond step of the reference's regression
    (test_analysis.py's test_while_cond_to_static_regression) keeps its
    Tensors in scope: clean under tracking, the reference's values."""
    def program(P):
        def f(x, n):
            s = x * 0.0
            i = 0
            for _ in range(n):
                if s.sum() < 6.0:
                    s = s + x * 1.0
                    i = i + 1
            return s
        traced = P.jit.to_static(f)
        xp = P.to_tensor(np.full((4,), 0.5, np.float32))
        for _ in range(3):
            got = traced(xp, P.to_tensor(np.int64(5)))
        return np.asarray(got.numpy())

    with analysis.birth_tracking():
        got = program(paddle)
    np.testing.assert_allclose(got, program(ref), rtol=1e-6)
    np.testing.assert_allclose(got, np.full(4, 1.5))


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_birth_tracking_disabled_leaves_hooks_clear(pkg):
    an, tm = (ref_analysis, ref_trace) if pkg == "reference" \
        else (analysis, trace_mod)
    assert tm._birth_hook is None and tm._capture_hook is None
    assert not an.enabled()
    with an.birth_tracking():
        assert an.enabled()
        assert tm._birth_hook is not None and tm._capture_hook is not None
    assert tm._birth_hook is None and tm._capture_hook is None
    assert not an.enabled()


def test_birth_of_records_op_and_subtrace():
    with analysis.birth_tracking():
        ctx = trace_mod.TraceContext("record")
        with trace_mod.trace_guard(ctx):
            with analysis.subtrace("while_body"):
                t = Tensor(torch.zeros(2))
                u = t + 1.0
            birth, ubirth = analysis.birth_of(t), analysis.birth_of(u)
    assert birth is not None and birth.subtrace.startswith("while_body#")
    assert HERE in birth.site and birth.op == \
        "test_birth_of_records_op_and_subtrace"
    assert ubirth.op == "elementwise_add" and ubirth.subtrace == \
        birth.subtrace
    # the reference records the same shape
    import jax.numpy as jnp
    with ref_analysis.birth_tracking():
        rctx = ref_trace.TraceContext("record")
        with ref_trace.trace_guard(rctx):
            with ref_analysis.subtrace("while_body"):
                rt = ref.Tensor(jnp.zeros((2,)))
            rbirth = ref_analysis.birth_of(rt)
    assert rbirth.subtrace.startswith("while_body#")
    assert rbirth.op == birth.op and HERE in rbirth.site
