"""The port's program lint (paddle_tpu_torch.analysis.lint): the
reference's four passes (``f64-upcast``, ``donation``,
``dynamic-shape-risk``, ``host-callback``) over the op list that a
recording keeps, with the reference's names, severities, finding schema
and metadata keys.

There is no working JAX oracle: the reference's own tests of these
passes (tests/test_analysis.py) fail under the installed JAX, whose
jaxpr internals they read. So the port's passes are held to their own
cases: each pass on a planted case, with the finding's site (this
file's line); a ``to_static`` GPT step and the port engine's decode
lint clean; one ``run_passes`` call feeds all seven passes and sorts
the findings by severity.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from _torch_port import TINY
from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis import lint
from paddle_tpu_torch.observability.watchdog import CompileWatchdog
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.text import models as tmodels

HERE = __file__


def _line_of(fn, text):
    src, start = inspect.getsourcelines(fn)
    return start + next(i for i, s in enumerate(src) if text in s)


def _upcast(x):
    y = x.double() * 2          # the planted upcast
    return (y.float() + 1).sum()


def test_f64_upcast_is_an_error_at_its_site():
    found = lint.lint_fn(_upcast, torch.ones(4))
    assert [f.pass_name for f in found] == ["f64-upcast"]
    f = found[0]
    assert f.severity == "error"
    assert f.site.startswith(f"{HERE}:{_line_of(_upcast, 'planted')} ")
    assert f.to_dict() == {"pass": "f64-upcast", "severity": "error",
                           "site": f.site, "detail": f.detail}
    assert "float32" in f.detail
    # f64 flowing through f64 ops is not flagged again; a fresh f64
    # constant is
    assert lint.lint_fn(lambda x: (x * 2).sum(),
                        torch.ones(4, dtype=torch.float64)) == []
    fresh = lint.lint_fn(lambda x: x + torch.zeros(
        4, dtype=torch.float64, device=x.device), torch.ones(4))
    assert {f.pass_name for f in fresh} == {"f64-upcast"}


def _host_read(x):
    s = x.sum()
    if float(s) > 0:            # the planted host read
        return x + 1
    return x


def test_host_read_inside_a_recording_is_flagged():
    """On meta tensors the read gives zeros and the walk goes on; the
    finding names the read and its line."""
    found = lint.lint_fn(_host_read, torch.ones(4))
    assert [(f.pass_name, f.severity) for f in found] \
        == [("host-callback", "warning")]
    assert found[0].site.startswith(
        f"{HERE}:{_line_of(_host_read, 'planted')} ")
    assert "float()" in found[0].detail
    for read in (lambda x: x.sum().item(), lambda x: x.tolist(),
                 lambda x: x.numpy()):
        got = lint.lint_fn(read, torch.ones(2))
        assert [f.pass_name for f in got] == ["host-callback"]


def test_host_read_in_a_to_static_step():
    """The record call keeps the op list; TracedFunction.lint() walks it
    without running anything."""
    w = torch.ones(3, requires_grad=True)

    @paddle.jit.to_static(lint=True)
    def step(x):
        loss = (x * w).sum()
        print_me = loss.item()  # the planted host read
        return loss * print_me

    for _ in range(3):
        step(torch.ones(3))
    found = step.lint()
    assert [f.pass_name for f in found] == ["host-callback"]
    assert f":{_line_of(step._fn, 'planted')} " in found[0].site


def test_a_step_keeps_no_op_list_unless_asked():
    """Without lint=True a record keeps no op list (no cost to a step
    that is never linted); lint() then refuses the program passes, and
    dynamic-shape-risk, which reads only the entries, still runs."""
    @paddle.jit.to_static
    def step(x):
        return (x * 2).sum()

    for _ in range(3):
        step(torch.ones(3))
    record = next(iter(step.entries.values()))["record"]
    assert getattr(record, "program", None) is None
    with pytest.raises(ValueError, match="lint=True"):
        step.lint()
    assert step.lint(passes=["dynamic-shape-risk"]) == []


def test_donation_flags_an_update_out_of_place():
    """A large input returned as a new buffer of its shape, on an
    aliasing backend: flagged; the same update written in place, or
    donated by argnums, or on a non-aliasing backend (the CPU default):
    clean."""
    big = torch.ones(1 << 19)                     # 2 MiB of f32
    found = lint.lint_fn(lambda x: x * 2, big, backend_aliases=True)
    assert [(f.pass_name, f.severity, f.site) for f in found] \
        == [("donation", "warning", "invar[0]")]
    assert "2097152 bytes" in found[0].detail

    def in_place(kc, v):
        kc[0] = v
        return kc.sum()
    assert lint.lint_fn(in_place, torch.ones(4, 1 << 18),
                        torch.ones(1 << 18), backend_aliases=True) == []
    args = (big, torch.ones(2))
    flags = lint.donated_invars_from_argnums(args, (0,))
    assert flags == (True, False)
    assert lint.lint_fn(lambda x, y: (x * 2, y), *args,
                        backend_aliases=True, donated_invars=flags) == []
    assert lint.lint_fn(lambda x: x * 2, big) == []          # CPU: off
    assert lint.lint_fn(lambda x: x * 2, big, backend_aliases=True,
                        min_donation_bytes=4 << 20) == []


def test_dynamic_shape_risk_from_a_watchdog_and_a_traced_function():
    wd = CompileWatchdog()
    wd.record("decode", signature="i32[8]", call_site="a.py:1")
    wd.record("decode", signature="i32[9]", call_site="a.py:2")
    wd.record("prefill", signature="i32[8]", call_site="a.py:3")
    found = lint.lint_program(None, watchdog=wd)
    assert [(f.pass_name, f.severity, f.site) for f in found] \
        == [("dynamic-shape-risk", "warning", "a.py:2")]

    @paddle.jit.to_static
    def double(x):
        return x * 2

    for n in (3, 4):            # two shapes under one structure
        for _ in range(3):
            double(torch.ones(n))
    found = double.lint(passes=["dynamic-shape-risk"])
    assert len(found) == 1 and "2 distinct shape signatures" \
        in found[0].detail
    assert double.signature_groups()
    assert lint.lint_program(None, traced=double)[0].pass_name \
        == "dynamic-shape-risk"


def test_run_passes_feeds_all_seven_sorted_by_severity():
    assert analysis.lint_passes() == [
        "cross-role-write", "donation", "dynamic-shape-risk", "f64-upcast",
        "host-callback", "lock-patrol", "snapshot-discipline"]

    def both(x):
        y = x.double()
        return y + float(y.sum())
    program = lint.record_program(both, torch.ones(4))
    wd = CompileWatchdog()
    wd.record("k", signature="a")
    wd.record("k", signature="b")
    found = lint.run_passes(program=program, watchdog=wd)
    sev = [f.severity for f in found]
    assert sev == sorted(sev, key=lint.SEVERITIES.index)
    assert found[0].pass_name == "f64-upcast"
    assert {f.pass_name for f in found} == {"f64-upcast", "host-callback",
                                            "dynamic-shape-risk"}
    assert lint.lint_jaxpr is lint.lint_program
    assert len(list(lint.iter_eqns(program))) >= 3
    assert all(lint.eqn_site(op) for op in program.ops)
    with pytest.raises(TypeError):
        lint.lint_program(object())


def test_a_to_static_gpt_step_lints_clean():
    """A whole AdamW training step of the tiny GPT (forward, backward
    through the fused CE's plain versions, optimizer) recorded by
    to_static: no f64, no host read, nothing to donate."""
    cfg = tmodels.TransformerLMConfig(**TINY)
    m = tmodels.GPTForCausalLM(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    opt = paddle.optimizer.AdamW(1e-3, parameters=m.parameters())

    @paddle.jit.to_static(lint=True)
    def step(ids, labels):
        loss = m(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 97, (2, 16)))
    for _ in range(3):
        step(ids, ids)
    program = step.entries[next(iter(step.entries))]["record"].program
    assert len(program.ops) > 100
    assert step.lint() == []
    assert step.lint(backend_aliases=True) == []


def test_the_engine_decode_lints_clean():
    """The paged engine's decode program recorded on meta copies of its
    arguments: the KV cache is written in place, so even on an aliasing
    backend nothing is flagged; its watchdog has one signature a key.
    The speculative verify program too."""
    cfg = tmodels.TransformerLMConfig(**TINY)
    m = tmodels.GPTForCausalLM(cfg, device="cpu")
    eng = ServingEngine(m, device="cpu")
    r = eng.add_request(np.arange(1, 9), max_new_tokens=2)
    eng.run()
    assert r.done
    kc = eng.pool.kc.clone()
    assert eng.lint() == []
    assert torch.equal(eng.pool.kc, kc)         # nothing ran
    prog = lint.record_program(eng._decode_fn, eng.params, eng._toks,
                               eng._pos, eng.pool.device_tables(),
                               eng.pool.kc, eng.pool.vc)
    n = len(prog.invars)
    assert prog.written() == {n - 2, n - 1}     # kc, vc: in place
    # at any size only the [S] token/position vectors come back as new
    # buffers (the reference donates pos); the caches never
    small = lint.lint_program(prog, backend_aliases=True,
                              min_donation_bytes=1)
    assert {f.site for f in small} == {f"invar[{n - 5}]", f"invar[{n - 4}]"}
    assert all("int32[8]" in f.detail for f in small)
    spec = ServingEngine(m, device="cpu", speculative=True)
    assert spec.lint(program="spec_verify") == []
    with pytest.raises(ValueError):
        eng.lint(program="chunk")
