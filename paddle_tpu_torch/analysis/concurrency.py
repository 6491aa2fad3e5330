"""Static concurrency analyses: thread-role shared-state audit + snapshot
lint (a port of ``paddle_tpu/analysis/concurrency.py``, re-pointed at the
port's own sources).

Two AST-based passes over the serving/router/observability sources of
``paddle_tpu_torch``, both registered in the lint framework
(:mod:`.lint`) and severity-sorted by ``run_passes``:

``cross-role-write``
    Classifies each method by the thread role it runs on (step-loop /
    http-handler / poller / scrape / router-dispatch / supervisor / caller)
    from a hand-maintained role map of entry points plus within-class
    call-graph propagation.  An attribute *write* on an object reachable
    from two or more roles, without a surrounding ``with <lock>``, is a
    finding.  Known-safe surfaces are encoded in an allowlist whose every
    rule carries evidence asserted against the port's source text, so a
    stale rule rots loudly ("allowlist-rot" error finding) instead of
    silently.

``snapshot-discipline``
    A live mutable host buffer, also mutated in place elsewhere in the
    class, handed to a sink that reads it after the call returns, without
    a laundering copy. The reference's sinks are a jax dispatch and wire
    serialization; torch's are ``torch.from_numpy`` and ``torch.as_tensor``
    / ``torch.asarray`` on a numpy buffer (both share its memory), a
    ``.to(..., non_blocking=True)`` or ``copy_(..., non_blocking=True)``
    from host memory (the copy reads its source after the call returns),
    the engine's program dispatch (``_timed``) and the wire's
    serialization (``serialize_handoff``, ``pack``, ``dumps``).
    ``.clone()``, ``.copy()``, ``np.array(...)`` and ``torch.tensor(...)``
    launder a buffer.

``audit_default()`` runs both passes over the default source set.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
import re

from .lint import Finding, register_lint_pass, run_passes

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Findings
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AuditFinding(Finding):
    """A cross-role unlocked write (or allowlist bookkeeping record)."""

    key: str = ""
    attr: str = ""
    roles: tuple = ()

    def to_dict(self):
        d = super().to_dict()
        d["key"] = self.key
        d["attr"] = self.attr
        d["roles"] = list(self.roles)
        return d


@dataclasses.dataclass
class SnapshotFinding(Finding):
    """A live mutable buffer handed to a dispatch/serialization sink."""

    attr: str = ""
    mutated_at: tuple = ()

    def to_dict(self):
        d = super().to_dict()
        d["attr"] = self.attr
        d["mutated_at"] = list(self.mutated_at)
        return d


# ---------------------------------------------------------------------------
# Allowlist with source-asserted evidence
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AllowRule:
    """Suppress findings whose key matches ``pattern`` (fnmatch).

    ``evidence`` is a tuple of ``(relpath, regex)`` pairs that must each
    match the named source file's current text; if any fails, the rule is
    dead and an ``allowlist-rot`` *error* finding is emitted instead of a
    suppression — the allowlist rots loudly.
    """

    pattern: str
    justification: str
    evidence: tuple = ()


def _check_evidence(rule, root):
    """Return None if all evidence holds, else a rot description string."""
    for relpath, regex in rule.evidence:
        path = os.path.join(root, relpath)
        try:
            with open(path, "r") as fh:
                text = fh.read()
        except OSError:
            return "evidence file missing: %s" % relpath
        if re.search(regex, text) is None:
            return "evidence regex no longer matches %s: %r" % (relpath, regex)
    return None


# ---------------------------------------------------------------------------
# Role map
# ---------------------------------------------------------------------------

# "basename.py::Class.method" (fnmatch wildcards allowed) -> role or roles.
# This is the hand-maintained seed; within-class call-graph propagation
# spreads roles from these entry points to everything they call.
DEFAULT_ROLE_MAP = {
    # --- serving/engine.py ----------------------------------------------
    # ServingEngine is single-threaded *by contract*: EngineGateway._lock
    # serializes every handler-side entry with the step loop (see the
    # engine allowlist rule's evidence).  The roles below describe where
    # calls originate, not unguarded concurrency.
    "engine.py::ServingEngine.step": "step-loop",
    "engine.py::ServingEngine.add_request": ("caller", "http-handler"),
    "engine.py::ServingEngine.export_kv": ("caller", "http-handler"),
    "engine.py::ServingEngine.import_kv": ("caller", "http-handler"),
    "engine.py::ServingEngine.start_draining": ("caller", "http-handler"),
    "engine.py::ServingEngine.drain": "caller",
    "engine.py::ServingEngine.close": "caller",
    "engine.py::ServingEngine.run": "caller",
    "engine.py::ServingEngine.debug_state": "scrape",
    "engine.py::ServingEngine.request_trace": "scrape",
    # --- serving/resilience/supervisor.py (the reference has the same
    # class but does not audit it) -----------------------------------------
    # the restart runs inside engine.step() (the health tick), its report
    # is read by /metrics.json and /debug/state scrapes
    "supervisor.py::EngineSupervisor.restart": "supervisor",
    "supervisor.py::EngineSupervisor.consider": "step-loop",
    "supervisor.py::EngineSupervisor.trigger": "step-loop",
    "supervisor.py::EngineSupervisor.note_completion": "step-loop",
    "supervisor.py::EngineSupervisor.report": "scrape",
    # --- serving/router/transport.py ------------------------------------
    # _drive is the stepping thread; in the port it also yields the GIL
    # between steps (time.sleep(0)) with the lock released
    "transport.py::EngineGateway._drive": "step-loop",
    "transport.py::EngineGateway.submit": ("caller", "http-handler"),
    "transport.py::EngineGateway.wait": ("caller", "http-handler"),
    "transport.py::EngineGateway.cancel": ("caller", "http-handler"),
    "transport.py::EngineGateway.prefill": ("caller", "http-handler"),
    "transport.py::EngineGateway.import_request": ("caller", "http-handler"),
    "transport.py::EngineGateway.handle_*": "http-handler",
    "transport.py::EngineGateway.drain": "caller",
    "transport.py::EngineGateway.kill": "caller",
    "transport.py::EngineGateway.close": "caller",
    # the router's HTTP transport: its calls start on router-dispatch
    # threads, each POST waits on a thread of its own (_HTTPCall)
    "transport.py::HTTPTransport.begin": "router-dispatch",
    "transport.py::HTTPTransport.prefill": "router-dispatch",
    "transport.py::HTTPTransport.decode_import": "router-dispatch",
    "transport.py::HTTPTransport.health": ("router-dispatch", "caller"),
    "transport.py::HTTPTransport.state": ("router-dispatch", "caller"),
    "transport.py::_HTTPCall.done": "router-dispatch",
    "transport.py::_HTTPCall.result": "router-dispatch",
    "transport.py::_HTTPCall.cancel": "router-dispatch",
    # --- serving/router/core.py -----------------------------------------
    "core.py::Router.submit": "caller",
    "core.py::Router.generate": "caller",
    "core.py::Router._drive": "router-dispatch",
    "core.py::Router._drive_disagg": "router-dispatch",
    "core.py::Router.refresh": ("caller", "router-dispatch"),
    "core.py::Router.state": "scrape",
    "core.py::RouterTicket._finish": "router-dispatch",
    "core.py::RouterTicket.done": "caller",
    "core.py::RouterTicket.result": "caller",
    # --- observability/fleet/poller.py ----------------------------------
    "poller.py::FleetPoller._loop": "poller",
    "poller.py::FleetPoller.poll_once": ("poller", "caller"),
    "poller.py::FleetPoller._scrape": "scrape-worker",
    "poller.py::FleetPoller.snapshot": ("scrape", "caller"),
    "poller.py::FleetPoller.fleet_health": ("scrape", "caller"),
    "poller.py::FleetPoller.fleet_tenants": ("scrape", "caller"),
    "poller.py::FleetPoller.prometheus_text": ("scrape", "caller"),
    "poller.py::FleetPoller.detector_counts": ("scrape", "caller"),
    "poller.py::FleetPoller.start": "caller",
    "poller.py::FleetPoller.stop": "caller",
    # --- observability/registry.py --------------------------------------
    # Every registry child is written from instrumented code paths (the
    # step loop) and read by scrapes; MetricsRegistry._lock guards both.
    "registry.py::MetricsRegistry.*": ("step-loop", "scrape"),
    "registry.py::_Child.*": ("step-loop", "scrape"),
    "registry.py::_GaugeChild.*": ("step-loop", "scrape"),
    "registry.py::_HistogramChild.*": ("step-loop", "scrape"),
}

_WRITE_MUTATORS = {
    "append",
    "appendleft",
    "add",
    "remove",
    "discard",
    "clear",
    "update",
    "extend",
    "insert",
    "pop",
    "popleft",
    "setdefault",
    "put",
}

_LOCKISH = re.compile(r"lock|cond|mutex|guard", re.IGNORECASE)

# Constructors whose instances synchronize internally: mutator calls on an
# attribute bound to one of these in __init__ are not unlocked writes.
# Event/Queue/Semaphore are interpreter-level atomic; Reservoir and
# StepLedger are repo classes that take their own lock in every mutator
# (their docstrings say "thread-safe" and the evidence is one grep away).
_SYNC_CTORS = {
    "Event",
    "Queue",
    "SimpleQueue",
    "LifoQueue",
    "Semaphore",
    "BoundedSemaphore",
    "Barrier",
    "Reservoir",
    "StepLedger",
}


def _self_root(node):
    """Attribute root for a ``self.X[...]...`` chain, or None."""
    n = node
    while isinstance(n, (ast.Subscript, ast.Attribute)):
        if (
            isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name)
            and n.value.id == "self"
        ):
            return n.attr
        n = n.value
    return None


class _MethodScan(ast.NodeVisitor):
    """Collect per-method: self-calls, self-attr occurrences, lock context."""

    def __init__(self):
        self.calls = set()  # names of self.method() calls
        self.unlocked_calls = set()  # self-calls made outside lock context
        # (attr, "read"|"write", locked: bool, lineno, via: "bind"|"mutate")
        self.occurrences = []
        self._lock_depth = 0

    # -- lock context -----------------------------------------------------

    def visit_With(self, node):
        lockish = 0
        for item in node.items:
            try:
                txt = ast.unparse(item.context_expr)
            except Exception:
                txt = ""
            if _LOCKISH.search(txt):
                lockish += 1
        self._lock_depth += lockish
        for stmt in node.body:
            self.visit(stmt)
        self._lock_depth -= lockish

    visit_AsyncWith = visit_With

    # -- occurrences ------------------------------------------------------

    def _note(self, attr, kind, lineno, via="bind"):
        if attr is not None:
            self.occurrences.append(
                (attr, kind, self._lock_depth > 0, lineno, via)
            )

    def visit_Attribute(self, node):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            kind = "write" if isinstance(node.ctx, (ast.Store, ast.Del)) else "read"
            self._note(node.attr, kind, node.lineno)
        self.generic_visit(node)

    def visit_Subscript(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            root = _self_root(node)
            if root is not None:
                self._note(root, "write", node.lineno, via="mutate")
        self.generic_visit(node)

    def visit_Call(self, node):
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if isinstance(fn.value, ast.Name) and fn.value.id == "self":
                self.calls.add(fn.attr)
                if self._lock_depth == 0:
                    self.unlocked_calls.add(fn.attr)
            elif fn.attr in _WRITE_MUTATORS:
                root = _self_root(fn.value)
                if root is not None:
                    self._note(root, "write", node.lineno, via="mutate")
        self.generic_visit(node)


def _method_name(node):
    return node.name


def _sync_attrs_from_init(fn_node):
    """Attrs bound to internally-synchronized objects in ``__init__``."""
    out = set()
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        fn = node.value.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
        if name not in _SYNC_CTORS:
            continue
        for tgt in node.targets:
            if (
                isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"
            ):
                out.add(tgt.attr)
    return out


def _scan_class(cls_node):
    """Return ({method: _MethodScan}, sync_attrs) for a class body.

    ``__init__``/``__new__`` writes are excluded (construction
    happens-before publication), but ``__init__`` is still mined for
    attributes bound to internally-synchronized objects.
    """
    scans = {}
    sync_attrs = set()
    for item in cls_node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if item.name in ("__init__", "__new__"):
                sync_attrs |= _sync_attrs_from_init(item)
                continue
            sc = _MethodScan()
            for stmt in item.body:
                sc.visit(stmt)
            scans[item.name] = sc
    return scans, sync_attrs


def _seed_roles(basename, clsname, methods, role_map):
    """Map method -> set of roles from the role map (fnmatch on full key)."""
    roles = {m: set() for m in methods}
    for pattern, role in role_map.items():
        pat_file, _, pat_meth = pattern.partition("::")
        if not fnmatch.fnmatch(basename, pat_file):
            continue
        for m in methods:
            full = "%s.%s" % (clsname, m)
            if fnmatch.fnmatch(full, pat_meth):
                if isinstance(role, str):
                    roles[m].add(role)
                else:
                    roles[m].update(role)
    return roles


def _propagate(roles, scans):
    """Fixpoint: a method called from a role runs on that role too."""
    changed = True
    while changed:
        changed = False
        for m, sc in scans.items():
            for callee in sc.calls:
                if callee in roles and not roles[m] <= roles[callee]:
                    roles[callee] |= roles[m]
                    changed = True
    return roles


def _normalize_sources(sources):
    """Yield (display_name, text) pairs from paths or (name, text) tuples."""
    for src in sources:
        if isinstance(src, tuple):
            yield src
        else:
            path = src if os.path.isabs(src) else os.path.join(_PKG_DIR, src)
            try:
                with open(path, "r") as fh:
                    yield src, fh.read()
            except OSError:
                continue


def _audit_sources(sources, role_map, allow, root):
    findings = []
    rule_hits = {id(r): 0 for r in allow}
    rot = {}
    for rule in allow:
        why = _check_evidence(rule, root)
        if why is not None:
            rot[id(rule)] = why
            findings.append(
                AuditFinding(
                    pass_name="cross-role-write",
                    severity="error",
                    site=rule.pattern,
                    detail="allowlist-rot: %s (rule: %s)" % (why, rule.justification),
                    key=rule.pattern,
                )
            )
    for name, text in sources:
        basename = os.path.basename(name)
        try:
            tree = ast.parse(text)
        except SyntaxError as e:
            findings.append(
                AuditFinding(
                    pass_name="cross-role-write",
                    severity="warning",
                    site="%s:%s" % (basename, e.lineno or 0),
                    detail="unparseable source: %s" % e.msg,
                )
            )
            continue
        for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
            scans, sync_attrs = _scan_class(cls)
            if not scans:
                continue
            roles = _seed_roles(basename, cls.name, scans.keys(), role_map)
            seeded = {m for m, r in roles.items() if r}
            roles = _propagate(roles, scans)
            # Caller-lock propagation: a helper reached ONLY through
            # in-class call sites that all sit inside a lock context runs
            # under the caller's lock.  Seeded entry points never qualify
            # (external callers hold nothing).
            called = set()
            called_unlocked = set()
            for sc in scans.values():
                called |= sc.calls
                called_unlocked |= sc.unlocked_calls
            lock_inherited = {
                m
                for m in scans
                if m in called and m not in called_unlocked and m not in seeded
            }
            # attr -> set of roles that touch it / that write it unlocked
            attr_roles = {}
            attr_unlocked_writes = {}  # attr -> [(method, lineno, roles)]
            for m, sc in scans.items():
                mroles = roles.get(m, set())
                if not mroles:
                    continue
                for attr, kind, locked, lineno, via in sc.occurrences:
                    if attr.startswith("__"):
                        continue
                    attr_roles.setdefault(attr, set()).update(mroles)
                    if kind != "write" or locked or m in lock_inherited:
                        continue
                    if via == "mutate" and attr in sync_attrs:
                        # Internally-synchronized container (Event, Queue,
                        # Reservoir, StepLedger, ...): its mutators are safe.
                        continue
                    attr_unlocked_writes.setdefault(attr, []).append(
                        (m, lineno, mroles)
                    )
            for attr, rset in sorted(attr_roles.items()):
                if len(rset) < 2 or attr not in attr_unlocked_writes:
                    continue
                if _LOCKISH.search(attr):
                    # The lock object itself (self._lock = ...) is not data.
                    continue
                for m, lineno, mroles in attr_unlocked_writes[attr]:
                    key = "%s::%s.%s.%s" % (basename, cls.name, m, attr)
                    matched = None
                    for rule in allow:
                        if id(rule) in rot:
                            continue
                        if fnmatch.fnmatch(key, rule.pattern):
                            matched = rule
                            break
                    if matched is not None:
                        rule_hits[id(matched)] += 1
                        continue
                    findings.append(
                        AuditFinding(
                            pass_name="cross-role-write",
                            severity="error",
                            site="%s:%d" % (basename, lineno),
                            detail=(
                                "unlocked write to %s.%s in %s.%s; attribute "
                                "reachable from roles {%s}"
                                % (
                                    cls.name,
                                    attr,
                                    cls.name,
                                    m,
                                    ", ".join(sorted(attr_roles[attr])),
                                )
                            ),
                            key=key,
                            attr=attr,
                            roles=tuple(sorted(attr_roles[attr])),
                        )
                    )
    for rule in allow:
        if id(rule) in rot:
            continue
        n = rule_hits[id(rule)]
        if n:
            findings.append(
                AuditFinding(
                    pass_name="cross-role-write",
                    severity="info",
                    site=rule.pattern,
                    detail="allowlisted %d write(s): %s" % (n, rule.justification),
                    key=rule.pattern,
                )
            )
        else:
            findings.append(
                AuditFinding(
                    pass_name="cross-role-write",
                    severity="warning",
                    site=rule.pattern,
                    detail=(
                        "unused allowlist rule (matched nothing): %s"
                        % rule.justification
                    ),
                    key=rule.pattern,
                )
            )
    return findings


# ---------------------------------------------------------------------------
# Snapshot-discipline pass
# ---------------------------------------------------------------------------

# Call names that launder a buffer into an independent snapshot:
# numpy's copies and conversions, torch's clone and torch.tensor (which
# always copies its data).
_SNAPSHOT_LAUNDER = {
    "copy",
    "deepcopy",
    "array",
    "ascontiguousarray",
    "tobytes",
    "tolist",
    "astype",
    "item",
    "clone",
    "tensor",
}

# Callee names that hand a buffer to the engine's program dispatch or
# the wire, or whose result shares the buffer's memory: every argument
# is live after the call returns.
_SNAPSHOT_SINKS = {"_timed", "from_numpy", "as_tensor", "asarray",
                   "serialize_handoff", "pack", "dumps"}

# Copies that read their host source after the call returns, but only
# when asked to (``non_blocking=True``): ``src.to(dev, non_blocking=True)``
# reads its receiver, ``dst.copy_(src, non_blocking=True)`` its argument.
_ASYNC_COPY_RECEIVER = {"to", "cuda"}
_ASYNC_COPY_ARGUMENT = {"copy_"}

# In-place mutation spellings on an array or tensor attribute.
_INPLACE_MUTATORS = {"fill", "sort", "put", "partition", "resize",
                     "fill_", "zero_", "copy_", "add_", "sub_", "mul_",
                     "index_put_", "index_fill_", "index_copy_",
                     "masked_fill_", "scatter_", "clamp_"}


def _is_laundered(node):
    """True if the expr's value is a fresh snapshot (``.copy()`` etc.)."""
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _SNAPSHOT_LAUNDER:
            return True
        if isinstance(fn, ast.Name) and fn.id in _SNAPSHOT_LAUNDER:
            return True
    return False


def _live_refs(node):
    """self-attrs referenced live (unlaundered) inside an expression."""
    if node is None:
        return
    if _is_laundered(node):
        return
    root = _self_root(node) if isinstance(node, (ast.Attribute, ast.Subscript)) else None
    if root is not None:
        yield root, node.lineno
        return
    for child in ast.iter_child_nodes(node):
        yield from _live_refs(child)


def _non_blocking(call):
    """True if ``call`` passes ``non_blocking=True``."""
    return any(kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


class _SnapshotScan(ast.NodeVisitor):
    """Per-class: in-place mutated attrs + live attr refs at sink calls."""

    def __init__(self):
        self.mutated = {}  # attr -> [lineno]
        self.sunk = []  # (attr, sink_name, lineno)

    def visit_Subscript(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            root = _self_root(node)
            if root is not None:
                self.mutated.setdefault(root, []).append(node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node):
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if fn.attr in _INPLACE_MUTATORS:
                root = _self_root(fn.value)
                if root is not None:
                    self.mutated.setdefault(root, []).append(node.lineno)
            if fn.attr in _SNAPSHOT_SINKS:
                self._sink_args(node, fn.attr)
            elif _non_blocking(node):
                if fn.attr in _ASYNC_COPY_RECEIVER:
                    for attr, lineno in _live_refs(fn.value):
                        self.sunk.append((attr, fn.attr, lineno))
                elif fn.attr in _ASYNC_COPY_ARGUMENT:
                    self._sink_args(node, fn.attr)
        elif isinstance(fn, ast.Name) and fn.id in _SNAPSHOT_SINKS:
            self._sink_args(node, fn.id)
        self.generic_visit(node)

    def _sink_args(self, node, sink):
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for attr, lineno in _live_refs(arg):
                self.sunk.append((attr, sink, lineno))


def _snapshot_sources(sources):
    findings = []
    for name, text in sources:
        basename = os.path.basename(name)
        try:
            tree = ast.parse(text)
        except SyntaxError:
            continue
        for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
            sc = _SnapshotScan()
            for item in cls.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for stmt in item.body:
                        sc.visit(stmt)
            seen = set()
            for attr, sink, lineno in sc.sunk:
                if attr not in sc.mutated:
                    continue
                key = (cls.name, attr, sink, lineno)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(
                    SnapshotFinding(
                        pass_name="snapshot-discipline",
                        severity="error",
                        site="%s:%d" % (basename, lineno),
                        detail=(
                            "live buffer %s.%s handed to %s() but mutated in "
                            "place at %s lines %s; snapshot with .copy() or "
                            ".clone() before the sink"
                            % (
                                cls.name,
                                attr,
                                sink,
                                basename,
                                ",".join(str(n) for n in sc.mutated[attr][:5]),
                            )
                        ),
                        attr=attr,
                        mutated_at=tuple(sc.mutated[attr][:5]),
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# Registered passes + default audit
# ---------------------------------------------------------------------------

# Default allowlist for the real tree.  Every rule carries evidence regexes
# asserted against the live source: if the guarded pattern disappears, the
# rule turns into an allowlist-rot error instead of silently suppressing.
DEFAULT_AUDIT_ALLOW = (
    AllowRule(
        pattern="engine.py::ServingEngine.*",
        justification=(
            "ServingEngine is single-threaded by contract: every handler-"
            "side entry (submit/wait/cancel/prefill/import_request/drain) "
            "reaches the engine through EngineGateway under its RLock, and "
            "_drive() holds the same lock across step()."
        ),
        evidence=(
            ("serving/router/transport.py", r"self\._lock = threading\.RLock\(\)"),
            (
                "serving/router/transport.py",
                r"def submit\((.|\n){0,1200}?with self\._lock",
            ),
            (
                "serving/router/transport.py",
                r"with self\._lock:\n(.|\n){0,200}?"
                r"worked = bool\(self\.engine\.step\(\)\)",
            ),
        ),
    ),
    AllowRule(
        pattern="supervisor.py::EngineSupervisor.*",
        justification=(
            "EngineSupervisor is written only on the step-loop thread: "
            "consider() and note_completion() run inside engine.step(), "
            "restart() from consider() through trigger(). Its one other "
            "role is report(), a scrape that reads ints, a dict rebound "
            "whole and len() of a set: each read is atomic under the GIL "
            "and a stale one is tolerated, as the engine rule tolerates "
            "debug_state's."
        ),
        evidence=(
            ("serving/engine.py", r"self\.supervisor\.consider\(fired\)"),
            ("serving/resilience/supervisor.py",
             r"def trigger\((.|\n){0,400}?self\.restart\("),
            ("serving/resilience/supervisor.py",
             r"\"replaying\": len\(self\._awaiting\)"),
            ("serving/resilience/supervisor.py",
             r"self\._last = \{"),
        ),
    ),
    AllowRule(
        pattern="transport.py::EngineGateway.kill._dead",
        justification=(
            "kill() flips the monotonic _dead flag without the lock on "
            "purpose: SIGKILL semantics must not wait for a step that is "
            "holding the gateway lock; readers tolerate staleness."
        ),
        evidence=(
            ("serving/router/transport.py", r"self\._dead = True"),
        ),
    ),
    AllowRule(
        pattern="core.py::RouterTicket._finish.*",
        justification=(
            "RouterTicket publishes result fields before _done.set(); "
            "consumers only read them after waiting on the event, so the "
            "Event provides the happens-before edge (event-sequenced "
            "publish)."
        ),
        evidence=(
            ("serving/router/core.py", r"self\._done\.set\(\)"),
        ),
    ),
)

DEFAULT_AUDIT_SOURCES = (
    "serving/engine.py",
    "serving/resilience/supervisor.py",
    "serving/router/transport.py",
    "serving/router/core.py",
    "serving/router/breaker.py",
    "serving/router/journal.py",
    "observability/fleet/poller.py",
    "observability/registry.py",
)

DEFAULT_SNAPSHOT_SOURCES = (
    "serving/engine.py",
    "serving/kv_pool.py",
    "serving/paged/pool.py",
    "serving/sched/sampling.py",
    "serving/kv_wire.py",
)


@register_lint_pass("cross-role-write")
def _cross_role_write_pass(program, meta):
    """Thread-role shared-state auditor. Inert without ``meta["thread_audit"]``."""
    cfg = meta.get("thread_audit")
    if cfg is None:
        return []
    sources = list(_normalize_sources(cfg.get("sources", DEFAULT_AUDIT_SOURCES)))
    role_map = cfg.get("role_map", DEFAULT_ROLE_MAP)
    allow = cfg.get("allow", DEFAULT_AUDIT_ALLOW)
    root = cfg.get("root", _PKG_DIR)
    return _audit_sources(sources, role_map, allow, root)


@register_lint_pass("snapshot-discipline")
def _snapshot_discipline_pass(program, meta):
    """Live-buffer-to-dispatch lint. Inert without ``meta["snapshot_audit"]``."""
    cfg = meta.get("snapshot_audit")
    if cfg is None:
        return []
    sources = list(_normalize_sources(cfg.get("sources", DEFAULT_SNAPSHOT_SOURCES)))
    return _snapshot_sources(sources)


def audit_default():
    """Run both static passes over the default source set."""
    return run_passes(
        passes=["cross-role-write", "snapshot-discipline"],
        thread_audit={"sources": DEFAULT_AUDIT_SOURCES},
        snapshot_audit={"sources": DEFAULT_SNAPSHOT_SOURCES},
    )
