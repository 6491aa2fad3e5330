"""W3C-traceparent-style trace context: the propagated identity (a
copy of ``paddle_tpu/observability/trace/context.py``).

One :class:`TraceContext` names one distributed request: a 128-bit
``trace_id`` every process's spans join on, the 64-bit ``span_id`` of
the CALLER's span (the parent a receiving process hangs its spans
under), and a small JSON-safe ``baggage`` dict that rides every hop
(the router stamps its request tag there, so an engine-side span ring
can be grepped by router rid without a join).

The wire form is the W3C trace-context header value::

    00-<32 hex trace_id>-<16 hex span_id>-01

carried as a ``"traceparent"`` field on the gateway POST bodies and
inside the KV handoff payload (``"trace": {"traceparent", "baggage"}``
— see serving.kv_wire). Only version ``00`` with the sampled flag is
ever emitted; parsing accepts any flag byte.

``coerce`` is the graceful-degradation contract: whatever arrives —
None (a direct ``add_request`` with no router above it), a truncated
header, corrupted wire baggage, an old-format journal entry — the
caller gets a VALID context back and never an exception. A locally
minted root is marked ``minted_local`` so assembled traces can tell
"joined the fleet trace" from "started its own".
"""
import os
import re

__all__ = ["TraceContext", "TRACEPARENT_RE"]

TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")

# baggage hygiene: a handful of small scalar entries, never a payload
_MAX_BAGGAGE_ITEMS = 16
_MAX_BAGGAGE_CHARS = 256


def _new_trace_id():
    return os.urandom(16).hex()


def _new_span_id():
    return os.urandom(8).hex()


def _clean_baggage(baggage):
    """Sanitize a would-be baggage mapping: keep at most
    _MAX_BAGGAGE_ITEMS str-keyed scalar entries, drop the rest.
    Anything that isn't a mapping sanitizes to {} — corrupted baggage
    degrades to an empty bag, never an exception."""
    if not isinstance(baggage, dict):
        return {}
    out = {}
    for k, v in baggage.items():
        if len(out) >= _MAX_BAGGAGE_ITEMS:
            break
        if not isinstance(k, str):
            continue
        if isinstance(v, bool) or not isinstance(v, (str, int, float)):
            v = str(v)
        if isinstance(v, str) and len(v) > _MAX_BAGGAGE_CHARS:
            v = v[:_MAX_BAGGAGE_CHARS]
        out[k[:_MAX_BAGGAGE_CHARS]] = v
    return out


class TraceContext:
    """One request's propagated trace identity (immutable by
    convention: derive with :meth:`child`, never mutate in place)."""

    __slots__ = ("trace_id", "span_id", "baggage", "minted_local")

    def __init__(self, trace_id, span_id, baggage=None,
                 minted_local=False):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)
        self.baggage = _clean_baggage(baggage)
        self.minted_local = bool(minted_local)

    # ------------------------------------------------------- minting
    @classmethod
    def mint(cls, baggage=None, minted_local=False):
        """A fresh root context (the router's admission moment — or,
        via :meth:`coerce`, a local root for an orphan request)."""
        return cls(_new_trace_id(), _new_span_id(), baggage=baggage,
                   minted_local=minted_local)

    def child(self, baggage=None):
        """Derive a context for an outgoing hop: same trace, new span
        id (the callee's spans parent on it)."""
        bag = dict(self.baggage)
        bag.update(_clean_baggage(baggage))
        return TraceContext(self.trace_id, _new_span_id(), baggage=bag,
                            minted_local=self.minted_local)

    # ----------------------------------------------------- wire forms
    def to_traceparent(self):
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, value, baggage=None):
        """Parse the header form; raises ValueError on malformed input
        (callers that must not raise go through :meth:`coerce`)."""
        m = TRACEPARENT_RE.match(str(value).strip().lower())
        if m is None:
            raise ValueError(
                f"malformed traceparent {str(value)[:64]!r}")
        return cls(m.group(1), m.group(2), baggage=baggage)

    def as_dict(self):
        """The JSON wire form carried on POST bodies and inside KV
        handoff payloads."""
        return {"traceparent": self.to_traceparent(),
                "baggage": dict(self.baggage)}

    # ---------------------------------------------------- degradation
    @classmethod
    def coerce(cls, obj):
        """ALWAYS returns a valid TraceContext; NEVER raises.

        Accepts a TraceContext (passed through), a traceparent string,
        a ``{"traceparent": ..., "baggage": ...}`` dict (the wire
        form), or garbage/None — the last two degrade to a locally
        minted root so an engine keeps serving whatever arrives."""
        if isinstance(obj, TraceContext):
            return obj
        try:
            if isinstance(obj, str):
                return cls.from_traceparent(obj)
            if isinstance(obj, dict):
                return cls.from_traceparent(
                    obj["traceparent"], baggage=obj.get("baggage"))
        except (KeyError, ValueError, TypeError, AttributeError):
            pass
        return cls.mint(minted_local=True)

    def __repr__(self):
        return (f"TraceContext({self.to_traceparent()!r}, "
                f"minted_local={self.minted_local})")
