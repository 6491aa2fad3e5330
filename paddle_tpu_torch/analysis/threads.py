"""Runtime lock patrol: lockdep-style deadlock and held-across-dispatch
lint (a port of ``paddle_tpu/analysis/threads.py``).

``LockPatrol`` wraps every ``threading.Lock`` / ``RLock`` / ``Condition``
created inside ``paddle_tpu_torch.*`` with a site-attributed proxy
(creation file:line is the lock's identity) and records the
acquired-while-holding edge graph across all threads. A cycle in the
merged graph is a ``LockOrderFinding`` naming every lock site on the
cycle plus the acquisition stack that created each edge. Separately,
``note_blocking`` hooks flag any patrolled lock held while control enters
a blocking call. The blocking kinds are the reference's: ``aot_dispatch``,
noted where the serving engine runs one of its programs
(``ServingEngine._timed``), and ``socket``, noted in the blocking socket
primitives. The engine's read-back waits on a CUDA event
(``ServingEngine._read_back``); it is the counterpart of the reference's
harvest, which the reference does not note, so the port adds no kind for
it either.

Locks created outside the patrolled paths (torch's own, the standard
library's, the tests') stay real locks. Gating mirrors the reference:
off by default, refcounted ``enable_patrol()`` / ``disable_patrol()``
and a ``lock_patrol()`` context manager; the port reads no environment,
so nothing arms it at import. When off, no factory is patched and the
only residual cost in the engine hot path is a single module-global
boolean test.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket as _socket_mod
import sys
import threading
import traceback

from .lint import Finding, register_lint_pass

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_THIS_FILE = os.path.abspath(__file__)

# Real factories, captured before any patching so nested enables and the
# patrol's own bookkeeping always use unproxied primitives.
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

_SOCKET_METHODS = ("connect", "recv", "recv_into", "sendall", "send", "accept")

# Fast-path flag read by the engine dispatch hook; True only while armed.
_armed = False
_state = None
_refs = 0
_master = _REAL_LOCK()
_tls = threading.local()

# (site_substring, blocking_kind, justification) triples: a patrolled lock
# whose site contains the substring is allowed to be held across blocking
# calls of that kind.  Kept tiny and justified inline so it rots loudly.
DEFAULT_PATROL_ALLOW = (
    (
        "transport.py",
        "aot_dispatch",
        "EngineGateway._lock serializes submissions with the step loop by "
        "design: _drive() holds it across engine.step() so POST handlers "
        "observe a consistent engine; no socket I/O ever happens under it.",
    ),
)


@dataclasses.dataclass
class LockOrderFinding(Finding):
    """A cycle in the merged acquired-while-holding graph."""

    locks: tuple = ()
    stacks: tuple = ()

    def to_dict(self):
        d = super().to_dict()
        d["locks"] = list(self.locks)
        d["stacks"] = list(self.stacks)
        return d


@dataclasses.dataclass
class HeldAcrossFinding(Finding):
    """A patrolled lock held across a dispatch or blocking socket call."""

    lock_site: str = ""
    blocking_kind: str = ""
    blocking_label: str = ""
    blocked_at: str = ""
    stack: str = ""

    def to_dict(self):
        d = super().to_dict()
        d["lock_site"] = self.lock_site
        d["blocking_kind"] = self.blocking_kind
        d["blocking_label"] = self.blocking_label
        d["blocked_at"] = self.blocked_at
        d["stack"] = self.stack
        return d


class _PatrolState:
    def __init__(self, paths, allow):
        self.paths = tuple(os.path.abspath(p) for p in paths)
        self.allow = tuple(allow)
        self.nlocks = 0
        # one [count] cell a thread, each written by its thread alone
        # (an acquire counts itself without taking a lock)
        self.counts = []
        # (a_site, b_site) -> {"thread": name, "stack": str}
        self.edges = {}
        # a_site -> set of b_sites acquired while a held
        self.adj = {}
        self.findings = []
        self._seen_cycles = set()
        self._seen_held = set()


def _book():
    """This thread's ``(state, held locks, [acquire count])`` for the
    active patrol state, made on the thread's first acquire under it."""
    st = _state
    book = getattr(_tls, "book", None)
    if book is None or book[0] is not st:
        book = (st, [], [0])
        _tls.book = book
        if st is not None:
            with _master:
                st.counts.append(book[2])
    return book


def _held():
    return _book()[1]


def _stack(skip=2):
    return "".join(traceback.format_stack(sys._getframe(skip)))


def _find_path(adj, start, goal):
    """Iterative DFS: a path start -> ... -> goal in adj, or None."""
    stack = [(start, [start])]
    visited = set()
    while stack:
        node, path = stack.pop()
        if node == goal:
            return path
        if node in visited:
            continue
        visited.add(node)
        for nxt in adj.get(node, ()):
            stack.append((nxt, path + [nxt]))
    return None


def _add_edge(st, a_site, b_site, stack_txt, thread_name):
    if (a_site, b_site) in st.edges:
        return
    st.edges[(a_site, b_site)] = {"thread": thread_name, "stack": stack_txt}
    st.adj.setdefault(a_site, set()).add(b_site)
    # New edge a->b closes a cycle iff a path b -> ... -> a already exists.
    back = _find_path(st.adj, b_site, a_site)
    if back is None:
        return
    cycle_sites = back  # b, ..., a ; new edge a->b closes it
    key = frozenset(cycle_sites)
    if key in st._seen_cycles:
        return
    st._seen_cycles.add(key)
    edge_pairs = list(zip(cycle_sites, cycle_sites[1:])) + [(a_site, b_site)]
    stacks = tuple(
        "acquired %s while holding %s [thread %s]\n%s"
        % (b, a, st.edges[(a, b)]["thread"], st.edges[(a, b)]["stack"])
        for a, b in edge_pairs
        if (a, b) in st.edges
    )
    st.findings.append(
        LockOrderFinding(
            pass_name="lock-order",
            severity="error",
            site=a_site,
            detail="lock-order cycle: " + " -> ".join(cycle_sites + [b_site]),
            locks=tuple(dict.fromkeys(cycle_sites)),
            stacks=stacks,
        )
    )


def _note_attempt(proxy):
    """Record ordering edges at acquire *attempt*, lockdep-style.

    Recording on attempt (not success) is what lets the patrol name a
    cycle even while the deadlock it predicts is actually in flight —
    neither thread would ever complete its second acquire. An attempt
    that adds no edge (the common case: nothing held, or every edge
    already known) only counts itself, in a cell of its thread's own.
    """
    st = _state
    if st is None:
        return
    _, held, count = _book()
    if not held:
        count[0] += 1
        return
    if any(h is proxy for h in held):
        # RLock reentrancy: no new ordering information, no self-edges.
        return
    count[0] += 1
    new_edges = [h.site for h in held
                 if h.site != proxy.site
                 and (h.site, proxy.site) not in st.edges]
    if new_edges:
        tname = threading.current_thread().name
        stack_txt = _stack(3)
        with _master:
            for a_site in new_edges:
                _add_edge(st, a_site, proxy.site, stack_txt, tname)


def _note_release(proxy):
    if _state is None:
        return
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i] is proxy:
            del held[i]
            return


class _PatrolProxy:
    """Site-attributed wrapper around a real Lock/RLock."""

    __slots__ = ("_real", "site", "kind")

    def __init__(self, real, site, kind):
        self._real = real
        self.site = site
        self.kind = kind

    def acquire(self, blocking=True, timeout=-1):
        if not _armed:
            return self._real.acquire(blocking, timeout)
        # the common case inline (nothing held: no edge can form, the
        # attempt only counts itself); the rest in _note_attempt
        book = getattr(_tls, "book", None)
        if book is None or book[0] is not _state:
            book = _book()
        held = book[1]
        if held:
            _note_attempt(self)
        else:
            book[2][0] += 1
        ok = self._real.acquire(blocking, timeout)
        if ok:
            held.append(self)
        return ok

    def release(self):
        self._real.release()
        if _armed:
            book = getattr(_tls, "book", None)
            if book is not None and book[1] and book[1][-1] is self:
                book[1].pop()
            else:
                _note_release(self)

    # ``with lock:`` is the hot spelling: acquire and release inlined
    # (one Python frame each way)
    def __enter__(self):
        if _armed:
            book = getattr(_tls, "book", None)
            if book is None or book[0] is not _state:
                book = _book()
            held = book[1]
            if held:
                _note_attempt(self)
            else:
                book[2][0] += 1
            self._real.acquire()
            held.append(self)
        else:
            self._real.acquire()
        return self

    def __exit__(self, *exc):
        self._real.release()
        if _armed:
            book = getattr(_tls, "book", None)
            if book is not None and book[1] and book[1][-1] is self:
                book[1].pop()
            else:
                _note_release(self)
        return False

    def locked(self):
        return self._real.locked()

    def __repr__(self):
        return "<patrolled %s at %s>" % (self.kind, self.site)


class _PatrolCondition(_PatrolProxy):
    """Condition proxy: wait() releases the lock, so held-state must track."""

    __slots__ = ("_cond",)

    def __init__(self, cond, site):
        super().__init__(cond, site, "Condition")
        self._cond = cond

    def _pop_silent(self):
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                return True
        return False

    def wait(self, timeout=None):
        was_held = _armed and self._pop_silent()
        try:
            return self._cond.wait(timeout)
        finally:
            if was_held:
                # Reacquisition on wakeup is a no-order event: the lock was
                # already ours before the wait; re-push without edges.
                _held().append(self)

    def wait_for(self, predicate, timeout=None):
        was_held = _armed and self._pop_silent()
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            if was_held:
                _held().append(self)

    def notify(self, n=1):
        return self._cond.notify(n)

    def notify_all(self):
        return self._cond.notify_all()


def _creation_site(depth=2):
    """file:line of the caller, or None if outside the patrolled paths."""
    st = _state
    if st is None:
        return None
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return None
    fn = frame.f_code.co_filename
    if not fn or fn.startswith("<"):
        return None
    afn = os.path.abspath(fn)
    if afn == _THIS_FILE:
        return None
    for p in st.paths:
        if afn.startswith(p):
            name = getattr(frame.f_code, "co_qualname", frame.f_code.co_name)
            parent = os.path.basename(os.path.dirname(afn))
            return "%s/%s:%d (%s)" % (
                parent,
                os.path.basename(afn),
                frame.f_lineno,
                name,
            )
    return None


def _patrol_lock():
    real = _REAL_LOCK()
    site = _creation_site()
    if site is None:
        return real
    st = _state
    if st is not None:
        with _master:
            st.nlocks += 1
    return _PatrolProxy(real, site, "Lock")


def _patrol_rlock():
    real = _REAL_RLOCK()
    site = _creation_site()
    if site is None:
        return real
    st = _state
    if st is not None:
        with _master:
            st.nlocks += 1
    return _PatrolProxy(real, site, "RLock")


def _patrol_condition(lock=None):
    site = _creation_site()
    if site is None:
        if lock is not None and isinstance(lock, _PatrolProxy):
            lock = lock._real
        return _REAL_CONDITION(lock)
    if lock is not None and isinstance(lock, _PatrolProxy):
        lock = lock._real
    cond = _REAL_CONDITION(lock)
    st = _state
    if st is not None:
        with _master:
            st.nlocks += 1
    return _PatrolCondition(cond, site)


def _blocking_site():
    """Innermost frame outside this module and the socket module."""
    f = sys._getframe(1)
    skip = (_THIS_FILE, os.path.abspath(_socket_mod.__file__))
    while f is not None:
        fn = f.f_code.co_filename
        if fn and not fn.startswith("<") and os.path.abspath(fn) not in skip:
            return "%s/%s:%d (%s)" % (
                os.path.basename(os.path.dirname(os.path.abspath(fn))),
                os.path.basename(fn),
                f.f_lineno,
                getattr(f.f_code, "co_qualname", f.f_code.co_name),
            )
        f = f.f_back
    return "<unknown>"


def note_blocking(kind, label=""):
    """Record that control is entering a blocking call of ``kind``.

    Called from the engine's program dispatch (``ServingEngine._timed``,
    ``kind="aot_dispatch"``) and from the patched blocking socket
    primitives (``kind="socket"``).
    Any patrolled lock currently held by this thread is a finding unless the
    patrol allowlist covers that (site, kind) pair.
    """
    st = _state
    if st is None:
        return
    held = _held()
    if not held:
        return
    blocked_at = _blocking_site()
    tname = threading.current_thread().name
    seen_proxies = set()
    for h in held:
        if id(h) in seen_proxies:
            continue
        seen_proxies.add(id(h))
        allowed = False
        for site_sub, allow_kind, _just in st.allow:
            if site_sub in h.site and allow_kind == kind:
                allowed = True
                break
        if allowed:
            continue
        key = (h.site, kind, blocked_at)
        with _master:
            if key in st._seen_held:
                continue
            st._seen_held.add(key)
            st.findings.append(
                HeldAcrossFinding(
                    pass_name="lock-held-across-dispatch",
                    severity="error",
                    site=h.site,
                    detail=(
                        "lock %s held while entering blocking %s (%s) at %s "
                        "[thread %s]" % (h.site, kind, label, blocked_at, tname)
                    ),
                    lock_site=h.site,
                    blocking_kind=kind,
                    blocking_label=label,
                    blocked_at=blocked_at,
                    stack=_stack(2),
                )
            )


def _wrap_socket_method(name):
    real = getattr(_socket_mod.socket, name)

    def wrapper(self, *args, **kwargs):
        if _armed and getattr(self, "gettimeout", None) is not None:
            # Nonblocking sockets (timeout 0) never wedge a holder.
            try:
                blocking = self.gettimeout() != 0
            except OSError:
                blocking = True
            if blocking:
                note_blocking("socket", name)
        return real(self, *args, **kwargs)

    wrapper.__name__ = name
    wrapper._patrol_wrapped = real
    return wrapper


_socket_saved = {}


def _install():
    threading.Lock = _patrol_lock
    threading.RLock = _patrol_rlock
    threading.Condition = _patrol_condition
    for name in _SOCKET_METHODS:
        had_own = name in _socket_mod.socket.__dict__
        _socket_saved[name] = (had_own, getattr(_socket_mod.socket, name))
        try:
            setattr(_socket_mod.socket, name, _wrap_socket_method(name))
        except (AttributeError, TypeError):
            _socket_saved.pop(name, None)


def _uninstall():
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    for name, (had_own, orig) in list(_socket_saved.items()):
        try:
            if had_own:
                setattr(_socket_mod.socket, name, orig)
            else:
                delattr(_socket_mod.socket, name)
        except (AttributeError, TypeError):
            pass
    _socket_saved.clear()


class LockPatrol:
    """Read-only view over the active (or last) patrol state."""

    def __init__(self, state):
        self._st = state

    def findings(self):
        with _master:
            return list(self._st.findings)

    def report(self):
        with _master:
            return {
                "enabled": _state is self._st,
                "locks": self._st.nlocks,
                "edges": len(self._st.edges),
                "acquires": sum(c[0] for c in self._st.counts),
                "findings": [f.to_dict() for f in self._st.findings],
            }


def enable_patrol(paths=None, allow=DEFAULT_PATROL_ALLOW):
    """Arm the lock patrol (refcounted). Returns a :class:`LockPatrol` view.

    ``paths``: directories whose lock creations are patrolled; defaults to
    the ``paddle_tpu_torch`` package dir.  Nested enables share one state; only
    the outermost ``disable_patrol`` tears down.
    """
    global _armed, _state, _refs
    with _master:
        _refs += 1
        if _refs == 1:
            _state = _PatrolState(paths or (_PKG_DIR,), allow)
            _install()
            _armed = True
        return LockPatrol(_state)


def disable_patrol():
    """Disarm one level of patrol; outermost call restores the factories."""
    global _armed, _state, _refs
    with _master:
        if _refs == 0:
            return
        _refs -= 1
        if _refs == 0:
            _armed = False
            _uninstall()
            _state = None
            _tls.book = None


@contextlib.contextmanager
def lock_patrol(paths=None, allow=DEFAULT_PATROL_ALLOW):
    """Context manager: arm the patrol, yield the :class:`LockPatrol` view."""
    patrol = enable_patrol(paths=paths, allow=allow)
    try:
        yield patrol
    finally:
        disable_patrol()


def patrol_report():
    """Current patrol report; identical shape whether armed or not."""
    with _master:
        st = _state
        if st is None:
            return {
                "enabled": False,
                "locks": 0,
                "edges": 0,
                "acquires": 0,
                "findings": [],
            }
    return LockPatrol(st).report()


@register_lint_pass("lock-patrol")
def _lock_patrol_pass(program, meta):
    """Surface runtime patrol findings through the lint framework.

    Inert unless ``meta["patrol"]`` carries a :class:`LockPatrol` view.
    """
    patrol = meta.get("patrol")
    if patrol is None:
        return []
    return patrol.findings()
