"""paddle_tpu_torch's concurrency analysis against the JAX package's on
the CPU (tests/test_concurrency.py's scenarios, one for one): the lock
patrol (cycle and held-across-dispatch findings, the allowlist, package
scoping and restoration, refcounted nesting, a real drain on both pools
at a bounded cost), the static thread-role audit with its evidence-
asserted allowlist, and the snapshot lint with torch's sinks.

Each scenario runs through both packages and the findings must agree
field for field, except the sites (each names its own package's files).
The audit's clean-tree contract holds over the port's own sources.
"""
import ast
import fnmatch
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu import analysis as ref_analysis
from paddle_tpu.analysis import concurrency as ref_cc
from paddle_tpu.analysis import threads as ref_th
from paddle_tpu.analysis.lint import lint_jaxpr

from _torch_port import TINY
from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis import concurrency as cc
from paddle_tpu_torch.analysis import threads as th
from paddle_tpu_torch.analysis.lint import run_passes
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.text.models import GPTForCausalLM, TransformerLMConfig

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
_PORT = os.path.join(_REPO, "paddle_tpu_torch")

# the patrol's measured cost bound, as the reference's: the armed
# per-acquire cost times the drain's acquires a step, as a share of a step
_PATROL_OVERHEAD = 0.02


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run_order(first, second):
    """One worker thread acquiring first-then-second, joined."""
    def body():
        with first:
            with second:
                pass
    t = threading.Thread(target=body)
    t.start()
    t.join()


def _strip(d):
    """A finding's dict without what names a package's own files."""
    drop = ("site", "detail", "locks", "stacks", "lock_site", "blocked_at",
            "stack")
    return {k: v for k, v in d.items() if k not in drop}


# (the package's analysis module, its threads module); every patrol
# scenario runs on both and their findings are compared
_PKGS = ((ref_analysis, ref_th), (analysis, th))


def _both(scenario):
    out = [scenario(a, t) for a, t in _PKGS]
    assert out[0] == out[1], out
    return out[1]


# ---------------------------------------------------------------------
# lock patrol: runtime lockdep
# ---------------------------------------------------------------------


def test_patrol_planted_deadlock_exactly_one_cycle_finding():
    def scenario(an, _th):
        with an.lock_patrol(paths=(_HERE,)) as patrol:
            a = threading.Lock()
            b = threading.Lock()
            _run_order(a, b)
            _run_order(b, a)
            _run_order(a, b)      # the inversion again: still ONE cycle
            _run_order(b, a)
            findings = patrol.findings()
        assert len(findings) == 1
        d = findings[0].to_dict()
        assert len(d["locks"]) == 2
        assert all("test_torch_concurrency.py" in s for s in d["locks"])
        assert len(d["stacks"]) == 2
        assert all("while holding" in s for s in d["stacks"])
        return [_strip(d)]
    got = _both(scenario)
    assert got[0]["pass"] == "lock-order" and got[0]["severity"] == "error"


def test_patrol_consistent_order_no_finding():
    def scenario(an, _th):
        with an.lock_patrol(paths=(_HERE,)) as patrol:
            a = threading.Lock()
            b = threading.Lock()
            _run_order(a, b)
            _run_order(a, b)
            return patrol.findings(), patrol.report()["edges"]
    assert _both(scenario) == ([], 1)


def test_patrol_rlock_reentrancy_no_self_edge():
    def scenario(an, _th):
        with an.lock_patrol(paths=(_HERE,)) as patrol:
            r = threading.RLock()
            with r:
                with r:       # reentrant: no ordering information
                    pass
            return patrol.findings(), patrol.report()["edges"]
    assert _both(scenario) == ([], 0)


def test_patrol_condition_wait_releases_held_state():
    """A thread parked in Condition.wait holds nothing: a dispatch
    noted while it waits is not attributed to it."""
    def scenario(an, _th):
        with an.lock_patrol(paths=(_HERE,)) as patrol:
            cond = threading.Condition()
            parked = threading.Event()
            woke = []

            def waiter():
                with cond:
                    parked.set()
                    cond.wait(timeout=5)
                    woke.append(1)

            t = threading.Thread(target=waiter)
            t.start()
            assert parked.wait(5)
            with cond:        # the waiter is inside wait(): lock free
                cond.notify_all()
            t.join(5)
            return woke, patrol.findings()
    assert _both(scenario) == ([1], [])


def test_patrol_held_across_dispatch_finding_and_dedupe():
    def scenario(an, thm):
        with an.lock_patrol(paths=(_HERE,)) as patrol:
            lk = threading.Lock()
            with lk:
                for _ in range(2):   # one call site twice: one finding
                    thm.note_blocking("aot_dispatch", "decode[8]")
            findings = patrol.findings()
        assert len(findings) == 1
        d = findings[0].to_dict()
        assert "test_torch_concurrency.py" in d["lock_site"]
        assert d["blocked_at"] and d["stack"]
        return _strip(d)
    d = _both(scenario)
    assert d == {"pass": "lock-held-across-dispatch", "severity": "error",
                 "blocking_kind": "aot_dispatch",
                 "blocking_label": "decode[8]"}


def test_patrol_held_across_blocking_socket():
    def scenario(an, _th):
        with an.lock_patrol(paths=(_HERE,)) as patrol:
            lk = threading.Lock()
            sa, sb = socket.socketpair()
            try:
                with lk:
                    sa.sendall(b"x")
            finally:
                sa.close()
                sb.close()
            return [_strip(f.to_dict()) for f in patrol.findings()]
    got = _both(scenario)
    assert len(got) == 1 and got[0]["blocking_kind"] == "socket" \
        and got[0]["blocking_label"] == "sendall"


def test_patrol_allowlist_suppresses_held_across():
    allow = (("test_torch_concurrency.py", "aot_dispatch", "test fixture"),)

    def scenario(an, thm):
        with an.lock_patrol(paths=(_HERE,), allow=allow) as patrol:
            lk = threading.Lock()
            with lk:
                thm.note_blocking("aot_dispatch", "decode[8]")
            return patrol.findings()
    assert _both(scenario) == []
    # the port's one default rule names its own gateway's lock
    assert [(s, k) for s, k, _ in th.DEFAULT_PATROL_ALLOW] \
        == [(s, k) for s, k, _ in ref_th.DEFAULT_PATROL_ALLOW] \
        == [("transport.py", "aot_dispatch")]


def test_patrol_package_scoping_and_restoration():
    """Locks made outside the patrolled package (this file, torch) stay
    real; on exit the factories and the socket methods are restored and
    the disabled report keeps its shape."""
    real_lock_type = type(threading.Lock())
    with analysis.lock_patrol() as patrol:   # the port's package only
        here_lock = threading.Lock()
        assert isinstance(here_lock, real_lock_type)
        # a lock made inside the port's package is patrolled
        from paddle_tpu_torch.serving.router.journal import RequestJournal
        journal = RequestJournal()
        assert isinstance(journal._lock, th._PatrolProxy)
        assert "journal.py" in journal._lock.site
        assert patrol.report()["locks"] >= 1
        # torch's own machinery makes real locks
        torch.ones(3).sum()
    assert threading.Lock is th._REAL_LOCK
    assert threading.RLock is th._REAL_RLOCK
    assert threading.Condition is th._REAL_CONDITION
    assert not hasattr(socket.socket.sendall, "_patrol_wrapped")
    rep = analysis.patrol_report()
    assert rep == ref_analysis.patrol_report() == {
        "enabled": False, "locks": 0, "edges": 0, "acquires": 0,
        "findings": []}


def test_patrol_nested_enable_refcounts():
    p1 = analysis.enable_patrol(paths=(_HERE,))
    try:
        with analysis.lock_patrol(paths=(_HERE,)) as p2:
            lk = threading.Lock()
            with lk:
                pass
            assert p2.report()["enabled"]
        # the inner exit must not tear down the outer patrol
        assert p1.report()["enabled"]
        assert threading.Lock is th._patrol_lock
    finally:
        analysis.disable_patrol()
    assert threading.Lock is th._REAL_LOCK


def test_patrol_lint_pass_registered_and_inert():
    with analysis.lock_patrol(paths=(_HERE,)) as patrol:
        a = threading.Lock()
        b = threading.Lock()
        _run_order(a, b)
        _run_order(b, a)
        findings = run_passes(passes=["lock-patrol"], patrol=patrol)
    assert [f.pass_name for f in findings] == ["lock-order"]
    assert run_passes(passes=["lock-patrol"]) == []
    # the program passes share the runner, inert without a program
    assert run_passes(passes=["f64-upcast"]) == []
    with pytest.raises(KeyError):
        run_passes(passes=["no-such-pass"])


def _tiny_model():
    cfg = TransformerLMConfig(**TINY)
    return GPTForCausalLM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(7)).eval()


def _per_acquire(lock, n_iter=4000, repeats=5):
    """Seconds one ``with lock:`` takes: the least of a few timed loops
    (the host's other work only ever adds to a loop's time)."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n_iter):
            with lock:
                pass
        best = min(best, (time.perf_counter() - t0) / n_iter)
    return best


def test_patrol_real_drain_clean_and_overhead_bounded():
    """A real engine drain gives no patrol finding on either pool, and
    the armed per-acquire cost (probed inside the armed window) times
    the drain's own acquires a step (counted from its first step to its
    last) stays under 2% of a step."""
    m = _tiny_model()
    rs = np.random.RandomState(0)
    specs = [(5, 6), (9, 4), (12, 5)]
    for paged in (False, True):
        with analysis.lock_patrol() as patrol:
            eng = ServingEngine(m, device="cpu", num_slots=2, bucket_min=8,
                                paged=paged)
            for n, k in specs:
                eng.add_request(rs.randint(0, 97, (n,)).astype(np.int64),
                                max_new_tokens=k)
            acquires0 = patrol.report()["acquires"]
            t0 = time.perf_counter()
            steps = 0
            while eng.pending and steps < 500:
                eng.step()
                steps += 1
            drain_wall = time.perf_counter() - t0
            assert not eng.pending, "drain hung"
            findings = patrol.findings()
            rep = patrol.report()
            proxy = th._PatrolProxy(th._REAL_LOCK(), "probe:1", "Lock")
            raw = th._REAL_LOCK()
            raw_cost, proxy_cost = _per_acquire(raw), _per_acquire(proxy)
        assert findings == [], [f.to_dict() for f in findings]
        assert rep["locks"] > 0 and rep["acquires"] > 0
        per_acquire = max(0.0, proxy_cost - raw_cost)
        step_wall = drain_wall / max(1, steps)
        drain_acquires = rep["acquires"] - acquires0
        frac = per_acquire * drain_acquires / max(1, steps) / step_wall
        assert frac < _PATROL_OVERHEAD, (paged, frac, per_acquire,
                                         drain_acquires / max(1, steps),
                                         step_wall)


def test_patrol_flags_a_lock_held_across_the_engines_dispatch():
    """The engine's dispatch notes itself: a patrolled lock (not the
    gateway's) held across step() is a finding naming aot_dispatch and
    the program's key."""
    m = _tiny_model()
    with analysis.lock_patrol(paths=(_HERE, _PORT)) as patrol:
        eng = ServingEngine(m, device="cpu", num_slots=2, bucket_min=8)
        lk = threading.Lock()
        eng.add_request(np.arange(5, dtype=np.int64), max_new_tokens=2)
        with lk:
            eng.step()
        kinds = {(f.blocking_kind, "test_torch_concurrency.py" in f.lock_site)
                 for f in patrol.findings()}
    assert kinds == {("aot_dispatch", True)}
    assert not th._armed


# ---------------------------------------------------------------------
# thread-role shared-state auditor (static)
# ---------------------------------------------------------------------

_PLANTED_RACE = '''
class Engine:
    def step(self):
        self.counter += 1          # step-loop write, unlocked

    def handle_status(self):
        return self.counter        # http-handler read
'''

_PLANTED_LOCKED = '''
class Engine:
    def step(self):
        with self._lock:
            self.counter += 1

    def handle_status(self):
        with self._lock:
            return self.counter
'''

_ROLE_MAP = {
    "planted.py::Engine.step": "step-loop",
    "planted.py::Engine.handle_*": "http-handler",
}


def _audit(src, role_map=_ROLE_MAP, allow=None):
    """The planted source through both auditors; the port's findings,
    after checking the reference's agree field for field."""
    def cfg(mod):
        rules = () if allow is None else tuple(
            mod.AllowRule(r.pattern, r.justification, r.evidence)
            for r in allow)
        return {"sources": [("planted.py", src)], "role_map": role_map,
                "allow": rules, "root": _REPO}
    ref = lint_jaxpr(None, passes=["cross-role-write"],
                     thread_audit=cfg(ref_cc))
    got = run_passes(passes=["cross-role-write"], thread_audit=cfg(cc))
    assert [f.to_dict() for f in got] == [f.to_dict() for f in ref]
    return got


def test_auditor_planted_cross_role_unlocked_write():
    findings = [f for f in _audit(_PLANTED_RACE) if f.severity == "error"]
    assert len(findings) == 1
    d = findings[0].to_dict()
    assert d["pass"] == "cross-role-write"
    assert d["attr"] == "counter"
    assert set(d["roles"]) == {"step-loop", "http-handler"}
    assert d["key"] == "planted.py::Engine.step.counter"
    assert "planted.py:4" in d["site"]


def test_auditor_locked_write_negative():
    assert [f for f in _audit(_PLANTED_LOCKED)
            if f.severity == "error"] == []


def test_auditor_single_role_negative():
    one_role = {"planted.py::Engine.*": "step-loop"}
    assert [f for f in _audit(_PLANTED_RACE, role_map=one_role)
            if f.severity == "error"] == []


def test_auditor_callgraph_propagation():
    src = '''
class Engine:
    def step(self):
        self._bump()

    def _bump(self):
        self.counter += 1

    def handle_status(self):
        return self.counter
'''
    findings = [f for f in _audit(src) if f.severity == "error"]
    assert len(findings) == 1
    assert findings[0].key == "planted.py::Engine._bump.counter"


def test_auditor_caller_lock_propagation():
    src = '''
class Engine:
    def step(self):
        with self._lock:
            self._bump()

    def _bump(self):
        self.counter += 1

    def handle_status(self):
        with self._lock:
            return self.counter
'''
    assert [f for f in _audit(src) if f.severity == "error"] == []


def test_auditor_sync_attr_mutators_safe():
    src = '''
import threading

class Engine:
    def __init__(self):
        self._wake = threading.Event()

    def step(self):
        self._wake.clear()

    def handle_submit(self):
        self._wake.set()
'''
    assert [f for f in _audit(src) if f.severity == "error"] == []


def test_auditor_allowlist_suppression_and_accounting():
    allow = (cc.AllowRule(
        pattern="planted.py::Engine.step.counter",
        justification="test fixture: counter is a test-only scratch",
        evidence=(("README.md", r"paddle"),),
    ),)
    findings = _audit(_PLANTED_RACE, allow=allow)
    assert [f for f in findings if f.severity == "error"] == []
    infos = [f for f in findings if f.severity == "info"]
    assert len(infos) == 1 and "allowlisted 1 write" in infos[0].detail


def test_auditor_allowlist_rots_loudly():
    allow = (cc.AllowRule(
        pattern="planted.py::Engine.step.counter",
        justification="stale rule",
        evidence=(("README.md", r"zz-never-matches-zz"),),
    ),)
    errors = [f for f in _audit(_PLANTED_RACE, allow=allow)
              if f.severity == "error"]
    assert len(errors) == 2   # the rot + the write it no longer hides
    assert any("allowlist-rot" in f.detail for f in errors)


def test_auditor_unused_rule_warns():
    allow = (cc.AllowRule(
        pattern="planted.py::Engine.never.matches",
        justification="dead rule",
        evidence=(("README.md", r"paddle"),),
    ),)
    warns = [f for f in _audit(_PLANTED_LOCKED, allow=allow)
             if f.severity == "warning"]
    assert len(warns) == 1 and "unused allowlist rule" in warns[0].detail


def test_default_allowlist_rots_when_the_port_changes(tmp_path):
    """Every default rule's evidence holds on the port's text; on a copy
    of the port with the gateway's lock gone, the engine rule turns into
    an allowlist-rot error and the engine's writes surface."""
    for rule in cc.DEFAULT_AUDIT_ALLOW:
        assert cc._check_evidence(rule, _PORT) is None, rule.pattern
    root = tmp_path / "port"
    for rel in cc.DEFAULT_AUDIT_SOURCES:
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        text = open(os.path.join(_PORT, rel)).read()
        if rel.endswith("transport.py"):
            text = text.replace("self._lock = threading.RLock()",
                                "self._lock = threading.Lock()")
        dst.write_text(text)
    findings = run_passes(
        passes=["cross-role-write"],
        thread_audit={"sources": [str(root / r)
                                  for r in cc.DEFAULT_AUDIT_SOURCES],
                      "root": str(root)})
    errors = [f for f in findings if f.severity == "error"]
    assert any("allowlist-rot" in f.detail
               and f.key == "engine.py::ServingEngine.*" for f in errors)
    assert any(f.key.startswith("engine.py::ServingEngine.")
               and f.attr for f in errors)


def test_role_map_names_the_ports_methods():
    """Every key of DEFAULT_ROLE_MAP matches a method of a class in the
    port's audited sources."""
    methods = set()
    for rel in cc.DEFAULT_AUDIT_SOURCES:
        tree = ast.parse(open(os.path.join(_PORT, rel)).read())
        for cls in (n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)):
            for item in cls.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    methods.add("%s::%s.%s" % (os.path.basename(rel),
                                               cls.name, item.name))
    dead = [k for k in cc.DEFAULT_ROLE_MAP
            if not fnmatch.filter(methods, k)]
    assert dead == []


# ---------------------------------------------------------------------
# snapshot-discipline lint
# ---------------------------------------------------------------------


def _snap(src, mod=cc):
    if mod is cc:
        return run_passes(passes=["snapshot-discipline"],
                          snapshot_audit={"sources": [("planted.py", src)]})
    return lint_jaxpr(None, passes=["snapshot-discipline"],
                      snapshot_audit={"sources": [("planted.py", src)]})


def test_snapshot_planted_live_buffer_dispatch():
    """The reference's planted case (a table uploaded by asarray after
    an in-place write) gives both packages the same finding."""
    src = '''
class Pool:
    def allocate(self, slot, blocks):
        self.block_tables[slot] = blocks

    def device_tables(self):
        return jnp.asarray(self.block_tables)
'''
    got, ref = _snap(src), _snap(src, ref_cc)
    assert len(got) == len(ref) == 1
    d, r = got[0].to_dict(), ref[0].to_dict()
    assert {k: d[k] for k in ("pass", "severity", "site", "attr",
                              "mutated_at")} \
        == {k: r[k] for k in ("pass", "severity", "site", "attr",
                              "mutated_at")} \
        == {"pass": "snapshot-discipline", "severity": "error",
            "site": "planted.py:7", "attr": "block_tables",
            "mutated_at": [4]}


def test_snapshot_copy_launders_negative():
    src = '''
class Pool:
    def allocate(self, slot, blocks):
        self.block_tables[slot] = blocks

    def device_tables(self):
        return jnp.asarray(self.block_tables.copy())
'''
    assert _snap(src) == _snap(src, ref_cc) == []


def test_snapshot_unmutated_buffer_negative():
    src = '''
class Pool:
    def device_tables(self):
        return jnp.asarray(self.block_tables)
'''
    assert _snap(src) == _snap(src, ref_cc) == []


# torch's sinks: each call shares or reads the live buffer after it
# returns; the buffer is mutated in place elsewhere in the class
_TORCH_SINKS = {
    "from_numpy": "t = torch.from_numpy(self.buf)",
    "as_tensor": "t = torch.as_tensor(self.buf)",
    "asarray": "t = torch.asarray(self.buf)",
    "to": "t = self.buf.to(self.device, non_blocking=True)",
    "cuda": "t = self.buf.cuda(non_blocking=True)",
    "copy_": "self.dev.copy_(self.buf, non_blocking=True)",
    "_timed": "t = self._timed(('decode',), self._fn, self.buf)",
    "serialize_handoff": "t = serialize_handoff(self.buf, 1)",
    "dumps": "t = json.dumps(self.buf)",
}

_MUTATIONS = ("self.buf[slot] = 3", "self.buf.fill_(0)", "self.buf.fill(0)",
              "self.buf.zero_()", "self.buf.copy_(other)")


def _sink_src(mutation, sink):
    return f'''
class Pool:
    def write(self, slot, other):
        {mutation}

    def upload(self):
        {sink}
'''


@pytest.mark.parametrize("sink", sorted(_TORCH_SINKS))
def test_snapshot_torch_sinks_caught(sink):
    for mutation in _MUTATIONS:
        findings = _snap(_sink_src(mutation, _TORCH_SINKS[sink]))
        assert [(f.attr, f.severity, f.site) for f in findings] \
            == [("buf", "error", "planted.py:7")], (sink, mutation)
        assert f"handed to {sink}()" in findings[0].detail


def test_snapshot_from_numpy_buffer_mutated_after_upload():
    """What the lint guards against, shown: a tensor made by
    torch.from_numpy shares its array, so an in-place write after the
    upload changes the tensor; .clone() or np.array() keep the value."""
    buf = np.zeros(4, np.int64)
    shared = torch.from_numpy(buf)
    kept = torch.from_numpy(buf).clone()
    copied = torch.from_numpy(np.array(buf))
    buf[1] = 7
    assert shared.tolist() == [0, 7, 0, 0]
    assert kept.tolist() == copied.tolist() == [0, 0, 0, 0]
    src = '''
class Pool:
    def write(self, slot):
        self.buf[slot] = 7

    def upload(self):
        return torch.from_numpy(self.buf)
'''
    assert [f.attr for f in _snap(src)] == ["buf"]


@pytest.mark.parametrize("sink", [
    "t = torch.from_numpy(self.buf.copy())",
    "t = torch.from_numpy(np.array(self.buf))",
    "t = torch.tensor(self.buf)",
    "t = self.buf.clone().to(self.device, non_blocking=True)",
    "t = self.buf.to(self.device)",
    "self.dev.copy_(self.buf)",
    "t = torch.as_tensor(self.buf.tolist())",
])
def test_snapshot_laundered_or_blocking_negative(sink):
    assert _snap(_sink_src("self.buf[slot] = 3", sink)) == []


# ---------------------------------------------------------------------
# clean-tree contracts + wiring
# ---------------------------------------------------------------------


def test_real_tree_audit_clean():
    """audit_default() over the port's serving stack: no error finding,
    every default rule alive and used."""
    findings = cc.audit_default()
    errors = [f for f in findings if f.severity == "error"]
    assert errors == [], [f.to_dict() for f in errors]
    warns = [f for f in findings if f.severity == "warning"]
    assert warns == [], [f.to_dict() for f in warns]
    infos = {f.key for f in findings if f.severity == "info"}
    assert infos == {r.pattern for r in cc.DEFAULT_AUDIT_ALLOW}
    assert any("ServingEngine is single-threaded by contract"
               in f.detail for f in findings)
    assert [os.path.basename(p) for p in cc.DEFAULT_SNAPSHOT_SOURCES] \
        == [os.path.basename(p) for p in ref_cc.DEFAULT_SNAPSHOT_SOURCES]


def test_all_new_passes_inert_without_meta():
    assert run_passes(passes=["cross-role-write", "snapshot-discipline",
                              "lock-patrol"]) == []
    assert analysis.lint_passes() == [
        "cross-role-write", "donation", "dynamic-shape-risk", "f64-upcast",
        "host-callback", "lock-patrol", "snapshot-discipline"]
