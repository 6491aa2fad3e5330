"""Leak detector: birth-site attribution for Tensors made inside a branch
or loop body (a port of ``paddle_tpu/analysis/birth.py``).

The reference's target is a value born inside a ``lax`` sub-trace (a
cond branch, a while condition or body) that escapes into the outer
trace, where it is a dead tracer. The port's target is the same shape
under ``jit.to_static``'s capture: a Tensor born inside a captured
branch or loop body (``static.nn.cond`` / ``while_loop``, and the
``if``/``while`` dy2static turns into them) that escapes its scope other
than as the branch's or body's output, through a closure, a list or an
attribute. A conditional node runs its body only when the data picks
it, so such a Tensor holds storage that an untaken branch never wrote
(or a loop's last trip, or nothing after zero trips); an output is
copied into buffers outside the scope and is safe.

While tracking is on:

* **births**: every Tensor made under a ``TraceContext`` records who
  made it (the op, or the function that called ``Tensor()``), where
  (``file:line``), in which trace and in which scope (``cond_true#3``);
* **scopes**: ``static.nn``'s branches and bodies run inside
  :func:`subtrace` scopes, checked when they close;
* **escapes**: an op that reads a Tensor whose birth scope has closed,
  or a step that returns one, raises :class:`TracerLeakError` naming the
  birth op, its site, the scope and the escape site.

Off (the default), the only cost is one ``is not None`` test where a
Tensor is made under a trace and where an op reads its arguments. Turn
it on with :func:`birth_tracking`, or :func:`enable` / :func:`disable`.
The reference's ``PADDLE_TPU_ANALYSIS`` variable is not read: the port
reads no environment.
"""
import contextlib
import os
import sys
import threading
import weakref
from collections import namedtuple

from ..core import trace as trace_mod

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CORE_DIR = os.path.join(_PKG_DIR, "core")
_OPS_DIR = os.path.join(_PKG_DIR, "ops")
_STATIC_NN = os.path.join(_PKG_DIR, "static", "nn.py")
_SELF = os.path.abspath(__file__)

#: Who created a Tensor, where, and under which trace and scope.
BirthSite = namedtuple("BirthSite", ["op", "site", "trace", "subtrace"])


class TracerLeakError(RuntimeError):
    """A Tensor born inside a branch or loop body escaped its scope.

    ``findings`` is a list of dicts, each with the keys ``tensor``,
    ``birth_op``, ``birth_site``, ``birth_trace`` and ``escape_site``.
    """

    def __init__(self, message, findings=()):
        super().__init__(message)
        self.findings = list(findings)


class _BirthState:
    __slots__ = ("enabled", "births", "captures", "stack", "closed",
                 "counter")

    def __init__(self):
        self.enabled = 0
        self.reset()

    def reset(self):
        self.births = {}    # id(tensor) -> (weakref, BirthSite)
        self.captures = {}  # id(tensor) -> escape site
        self.stack = []     # open scopes, innermost last
        self.closed = set()
        self.counter = 0


_state = threading.local()


def _st():
    st = getattr(_state, "birth", None)
    if st is None:
        st = _state.birth = _BirthState()
    return st


def enabled():
    return _st().enabled > 0


def enable():
    """Turn tracking on (reentrant; see :func:`birth_tracking`)."""
    st = _st()
    st.enabled += 1
    if st.enabled == 1:
        st.reset()
    trace_mod._birth_hook = _record_birth
    trace_mod._capture_hook = _on_capture


def disable():
    st = _st()
    if st.enabled > 0:
        st.enabled -= 1
    if st.enabled == 0:
        trace_mod._birth_hook = None
        trace_mod._capture_hook = None


@contextlib.contextmanager
def birth_tracking():
    """``with birth_tracking():`` attributes leaks in the block."""
    enable()
    try:
        yield
    finally:
        disable()


# ---------------------------------------------------------------- hooks

def _is_internal(filename):
    return filename.startswith(_CORE_DIR) or filename == _SELF


def _birth_frame():
    """(op, site) of a Tensor's making: the innermost frame outside
    core/ and ops/ (the user's line; the reference stops at the op's
    wrapper), with the op's registered name lifted from the dispatcher's
    frame on the way out."""
    try:
        f = sys._getframe(2)
    except ValueError:  # pragma: no cover - interpreter edge
        return "<unknown>", "<unknown>"
    op = None
    for _ in range(32):
        if f is None:
            break
        code = f.f_code
        if _is_internal(code.co_filename) \
                or code.co_filename.startswith(_OPS_DIR):
            if (os.path.basename(code.co_filename) == "dispatch.py"
                    and code.co_name == "__call__" and op is None):
                name = getattr(f.f_locals.get("self"), "name", None)
                if name:
                    op = str(name)
            f = f.f_back
            continue
        return op or code.co_name, f"{code.co_filename}:{f.f_lineno}"
    return op or "<unknown>", "<unknown>"


def _caller_site():
    """The innermost frame outside core/, ops/, static/nn.py and this
    module: the code that read the leaked Tensor."""
    try:
        f = sys._getframe(2)
    except ValueError:  # pragma: no cover
        return "<unknown>"
    for _ in range(32):
        if f is None:
            break
        fn = f.f_code.co_filename
        if _is_internal(fn) or fn.startswith(_OPS_DIR) or fn == _STATIC_NN:
            f = f.f_back
            continue
        return f"{fn}:{f.f_lineno} ({f.f_code.co_name})"
    return "<unknown>"


def _record_birth(tensor):
    """``trace._birth_hook``: stamp a Tensor made under a trace."""
    st = _st()
    if not st.enabled:
        return
    ctx = trace_mod._active
    if ctx is None:
        return
    op, site = _birth_frame()
    tid = id(tensor)
    births = st.births

    def _gone(_ref, tid=tid, births=births):
        births.pop(tid, None)

    births[tid] = (weakref.ref(tensor, _gone),
                   BirthSite(op, site, f"{ctx.mode}@{id(ctx) & 0xffffff:06x}",
                             st.stack[-1] if st.stack else ""))


def _live(st, tensor):
    rec = st.births.get(id(tensor))
    if rec is None or rec[0]() is not tensor:
        return None
    return rec[1]


def _on_capture(tensor):
    """``trace._capture_hook``: an op reads ``tensor``. Reading one born
    in a scope that has closed is a leak."""
    st = _st()
    if not st.enabled:
        return
    birth = _live(st, tensor)
    if birth is None or not birth.subtrace or birth.subtrace in st.stack:
        return
    site = _caller_site()
    st.captures[id(tensor)] = site
    finding = _finding(tensor, birth, site)
    raise TracerLeakError(_message(finding), [finding])


def _finding(tensor, birth, escape_site):
    return {
        "tensor": tensor.name,
        "birth_op": birth.op,
        "birth_site": birth.site,
        "birth_trace": birth.subtrace or birth.trace,
        "escape_site": escape_site or "<returned by the step>",
    }


def _message(finding):
    return (
        f"tracer leak: value {finding['tensor']!r} born in "
        f"{finding['birth_op']} at {finding['birth_site']} under scope "
        f"{finding['birth_trace']} escaped its owning scope, read at "
        f"{finding['escape_site']}. A Tensor made inside a captured "
        "branch or loop body holds storage that a branch the data does "
        "not take never writes: return it from the branch or body (its "
        "outputs are copied out) instead of keeping it in a closure, a "
        "list or an attribute.")


# ------------------------------------------------------------- checking

def birth_of(tensor):
    """The BirthSite recorded for ``tensor``, or None."""
    return _live(_st(), tensor)


def check_trace(ctx=None, raise_error=True):
    """The escapes noted so far (``ctx`` is taken for the reference's
    signature): Tensors an op read after their birth scope closed. Returns the findings; raises :class:`TracerLeakError`
    carrying them when ``raise_error`` (the default) and any were
    found. Run at every scope's exit while tracking is on."""
    st = _st()
    findings = []
    for tid, site in list(st.captures.items()):
        rec = st.births.get(tid)
        if rec is None:
            continue
        tensor, birth = rec[0](), rec[1]
        if tensor is None or not birth.subtrace \
                or birth.subtrace in st.stack:
            continue
        findings.append(_finding(tensor, birth, site))
    if findings and raise_error:
        raise TracerLeakError(
            "\n".join(_message(f) for f in findings), findings)
    return findings


def check_outputs(tensors):
    """A step's outputs: any born in a closed scope escaped it (run by
    ``to_static`` at the end of its record and capture calls)."""
    st = _st()
    if not st.enabled:
        return
    findings = []
    for t in tensors:
        birth = _live(st, t)
        if birth is not None and birth.subtrace \
                and birth.subtrace not in st.stack:
            findings.append(_finding(t, birth, None))
    if findings:
        raise TracerLeakError(
            "\n".join(_message(f) for f in findings), findings)


# ------------------------------------------------------ sub-trace scope

class _NullScope:
    def __enter__(self):
        return ""

    def __exit__(self, *exc):
        return False


_NULL_SCOPE = _NullScope()


class _SubtraceScope:
    __slots__ = ("tag",)

    def __init__(self, label, st):
        st.counter += 1
        self.tag = f"{label}#{st.counter}"

    def __enter__(self):
        _st().stack.append(self.tag)
        return self.tag

    def __exit__(self, exc_type, *exc):
        st = _st()
        if self.tag in st.stack:
            st.stack.remove(self.tag)
        st.closed.add(self.tag)
        if exc_type is None:
            check_trace()
        return False


def subtrace(label):
    """Scope a branch or loop body (``cond_true``, ``while_body``, ...)
    for leak attribution: a no-op unless tracking is on."""
    st = _st()
    if not st.enabled:
        return _NULL_SCOPE
    return _SubtraceScope(label, st)
