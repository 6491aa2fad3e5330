"""Replica transports: how the router reaches an engine (a port of
``paddle_tpu/serving/router/transport.py``).

Two flavors behind one surface (``begin`` / ``health`` / ``state`` /
``replica_id``):

  * :class:`InProcessTransport` — wraps an :class:`EngineGateway`
    (an engine plus the thread that steps it), zero sockets.
    The fast path for tests and one-host fleets; token
    streams flow through ``on_token`` into the router journal, and
    ``cancel`` really cancels (hedged losers release their slot).
  * :class:`HTTPTransport` — POSTs ``/v1/generate`` on a replica's
    metrics server (the gateway mounts it via
    ``serve_metrics(post_routes=)``). The over-the-wire path the
    kill-a-replica drill SIGKILLs mid-request.

Failure taxonomy — the distinction the circuit breaker feeds on:

  * :class:`TransportError` — the replica is unreachable or died
    mid-request (connection refused/reset, gateway killed, timeout).
    Trips the breaker, triggers failover.
  * :class:`TransportRefused` — the replica answered and said no
    (draining/closed → HTTP 503). A clean verdict, NOT a failure:
    the router fails over without charging the breaker.
"""
import json
import threading
import time
import urllib.error
import urllib.request

from ..kv_wire import KVWireError

__all__ = ["TransportError", "TransportRefused", "EngineGateway",
           "InProcessTransport", "HTTPTransport"]


def _body_trace(body):
    """Extract the distributed-trace fields a gateway wire body may
    carry (``traceparent`` + optional ``baggage``). Returns None when
    absent; NEVER validates — the engine's TraceContext.coerce mints
    a local root on anything malformed, so a corrupted header cannot
    refuse a request."""
    tp = body.get("traceparent")
    if tp is None:
        return None
    return {"traceparent": tp, "baggage": body.get("baggage")}


def _trace_fields(trace):
    """The wire form of a trace context for an outbound POST body:
    ``{"traceparent", "baggage"}`` (baggage omitted when empty).
    Accepts a TraceContext or its dict form; None -> {}."""
    if trace is None:
        return {}
    d = trace if isinstance(trace, dict) else trace.as_dict()
    out = {}
    if d.get("traceparent") is not None:
        out["traceparent"] = d["traceparent"]
        if d.get("baggage"):
            out["baggage"] = d["baggage"]
    return out


class TransportError(RuntimeError):
    """Replica unreachable / died mid-dispatch: breaker-charging."""


class TransportRefused(RuntimeError):
    """Replica explicitly refused (draining/closed): clean verdict."""


# --------------------------------------------------------------- gateway
class EngineGateway:
    """Owns ONE engine's step loop and submission surface.

    The engine itself is single-threaded by design; the gateway adds
    the one lock + stepping thread that lets HTTP handler threads (and
    the in-process router) submit concurrently while steps run. Every
    touch of the engine — steps, submissions, exports, imports, drain
    and close — goes through that lock, so the engine's host tensors
    and its pipelined (dispatched, not yet read) results are only ever
    seen by one thread at a time. On the card the stepping thread's
    CUDA work goes on that thread's current stream, the same one for
    every step of the engine.
    ``serve()`` mounts ``POST /v1/generate`` next to the engine's
    existing GET debug surface. ``kill()`` simulates SIGKILL for
    in-process chaos: the stepping thread stops mid-work, every outstanding
    wait raises :class:`TransportError`, nothing is drained.
    """

    def __init__(self, engine, idle_sleep_s=0.002,
                 generate_timeout_s=120.0):
        self.engine = engine
        self._idle_sleep_s = float(idle_sleep_s)
        self.generate_timeout_s = float(generate_timeout_s)
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._dead = False
        self._closed = False
        self._thread = threading.Thread(
            target=self._drive, daemon=True,
            name=f"gateway-{engine.replica_id}")
        self._thread.start()

    @property
    def replica_id(self):
        return self.engine.replica_id

    @property
    def dead(self):
        return self._dead

    def _drive(self):
        while not self._stop.is_set():
            worked = False
            with self._lock:
                if not self.engine._closed and self.engine.pending:
                    worked = bool(self.engine.step())
            if not worked:
                self._wake.wait(self._idle_sleep_s)
                self._wake.clear()
            else:
                # hand the GIL over between steps: a thread blocked on
                # the lock (a submission, a probe) would otherwise wait
                # while this loop takes the lock straight back
                time.sleep(0)

    # --------------------------------------------------- submission
    def submit(self, prompt, max_new_tokens, eos_id=None,
               deadline_ms=None, on_token=None, trace=None,
               tenant_id=None):
        """Enqueue on the engine; returns the Request handle. Raises
        TransportRefused when the engine is draining/closed (a clean
        verdict), TransportError when the gateway was killed.
        ``trace`` is the propagated distributed-trace context (any
        form TraceContext.coerce accepts — the engine never rejects
        a request over a bad trace). ``tenant_id`` overrides the
        attribution id; None defers to the trace baggage (the routed
        case), then to ``"default"``."""
        if self._dead:
            raise TransportError(
                f"replica {self.replica_id} is dead")
        with self._lock:
            try:
                req = self.engine.add_request(
                    prompt, max_new_tokens, eos_id=eos_id,
                    deadline_ms=deadline_ms, on_token=on_token,
                    trace=trace, tenant_id=tenant_id)
            except RuntimeError as e:   # draining/closed
                raise TransportRefused(str(e)) from e
        self._wake.set()
        return req

    def wait(self, req, timeout=None):
        """Block until ``req`` is done. TransportError if the gateway
        dies while waiting; returns False on timeout (request still
        running), True when done.

        The death check comes FIRST: ``kill()`` closes the engine,
        which aborts in-flight requests as done-with-partial-tokens —
        a waiter that trusted ``req.done`` on a dead gateway would
        return that truncated stream as a success. Real SIGKILL
        semantics: a call still unharvested when the replica dies
        errors out (the response never arrived), and the journal
        replay regenerates the stream bit-exact elsewhere."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            if self._dead:
                raise TransportError(
                    f"replica {self.replica_id} died mid-request "
                    f"(rid {req.rid})")
            if req.done:
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.001)

    def cancel(self, req):
        """Cancel an in-flight request: clamp its token budget so the
        very next harvest retires it (slot/blocks released through the
        normal stop path — no special-case teardown to leak). The
        hedging loser path."""
        with self._lock:
            if not req.done:
                req.max_new_tokens = max(1, len(req.generated))
        self._wake.set()
        return True

    # ------------------------------------------- disaggregated hops
    def prefill(self, prompt, deadline_ms=None, timeout=None,
                trace=None):
        """Hop 1 of a disaggregated request: compute the prompt's KV
        (+ the first token) on this replica and serialize the blocks
        for the wire. Blocking; returns ``{rid, replica_id,
        first_token, handoff}``. TransportRefused when the engine
        can't take it (draining / legacy pool / request expired before
        export), TransportError when the gateway died mid-hop.
        ``trace`` propagates into the request AND (via export_kv)
        into the handoff payload, so the decode tier joins the same
        trace."""
        if self._dead:
            raise TransportError(f"replica {self.replica_id} is dead")
        with self._lock:
            try:
                req = self.engine.add_request(
                    prompt, 1, deadline_ms=deadline_ms, hold_kv=True,
                    trace=trace)
            except (RuntimeError, ValueError) as e:
                # draining/closed, or no paged pool on this replica
                raise TransportRefused(str(e)) from e
        self._wake.set()
        if timeout is None:
            timeout = self.generate_timeout_s
            if deadline_ms is not None:
                timeout = min(timeout, deadline_ms / 1000.0 + 5.0)
        if not self.wait(req, timeout=timeout):
            raise TransportError(
                f"prefill timed out (rid {req.rid})")
        if req.shed_reason or not req.generated:
            raise TransportRefused(
                f"prefill produced no token "
                f"({req.shed_reason or 'deadline'})")
        with self._lock:
            try:
                handoff = self.engine.export_kv(req.rid)
            except KeyError as e:
                # retired without its hold (expired/aborted): clean no
                raise TransportRefused(str(e)) from e
        return {"rid": req.rid, "replica_id": self.replica_id,
                "first_token": int(req.generated[0]),
                "handoff": handoff}

    def import_request(self, payload, max_new_tokens, eos_id=None,
                       deadline_ms=None, on_token=None):
        """Hop 2 of a disaggregated request: bind a KV handoff into
        this replica's pool and start decoding. Returns the live
        Request as soon as the blocks are BOUND (the caller waits for
        completion separately — the bind wall is the import half of
        the handoff latency). TransportRefused on a payload this pool
        rejects (digest/shape drift — the pool is untouched) or a
        draining engine / full pool; TransportError when dead."""
        if self._dead:
            raise TransportError(f"replica {self.replica_id} is dead")
        with self._lock:
            try:
                req = self.engine.import_kv(
                    payload, max_new_tokens, eos_id=eos_id,
                    deadline_ms=deadline_ms, on_token=on_token)
            except KVWireError as e:
                raise TransportRefused(
                    f"kv import refused: {e}") from e
            except RuntimeError as e:   # draining/closed/full pool
                raise TransportRefused(str(e)) from e
        self._wake.set()
        return req

    # ---------------------------------------------------- lifecycle
    def drain(self, wait=True, timeout=30.0):
        """Flip the engine's drain flag (new submissions refused with
        503/TransportRefused) while the stepping thread finishes the
        already-admitted work."""
        with self._lock:
            self.engine.start_draining()
        self._wake.set()
        if wait:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._lock:
                    if not self.engine.pending:
                        return True
                time.sleep(0.005)
            return False
        return True

    def kill(self):
        """In-process SIGKILL: stop the stepping thread abruptly, fail every
        outstanding wait. The engine is then closed only for resource
        hygiene (a real SIGKILL frees memory the hard way too): its
        dispatched, unread results are discarded unread."""
        self._dead = True
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=10.0)
        try:
            with self._lock:
                self.engine.close()
        except Exception:   # noqa: BLE001 - hygiene only, dead anyway
            pass

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=10.0)
        if not self._dead:
            with self._lock:
                self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -------------------------------------------------- wire surface
    def serve(self, port=0, addr="127.0.0.1"):
        """Expose the engine's full debug surface plus
        ``POST /v1/generate`` — the replica is now reachable over the
        wire by an :class:`HTTPTransport`. ``/v1/prefill`` and
        ``/v1/import`` are mounted unconditionally: disaggregation is
        a routing posture, not a capability, so every replica speaks
        both hops (failover survivors must)."""
        return self.engine.serve_metrics(
            port=port, addr=addr,
            post_routes={"/v1/generate": self.handle_generate,
                         "/v1/prefill": self.handle_prefill,
                         "/v1/import": self.handle_import},
            lock=self._lock)

    def handle_generate(self, body):
        """The ``POST /v1/generate`` handler: validate, submit, block
        until done, answer the full token stream. Returns ``(status,
        payload)`` tuples on refusal/invalid input — the metrics
        server renders them as clean JSON errors."""
        prompt = body.get("prompt")
        max_new = body.get("max_new_tokens")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            return (400, {"error": "prompt must be a non-empty list "
                                   "of token ids"})
        if not isinstance(max_new, int) or max_new < 1:
            return (400, {"error": "max_new_tokens must be an "
                                   "int >= 1"})
        deadline_ms = body.get("deadline_ms")
        tenant_id = body.get("tenant_id")
        if tenant_id is not None and not isinstance(tenant_id, str):
            return (400, {"error": "tenant_id must be a string"})
        try:
            req = self.submit(prompt, max_new,
                              eos_id=body.get("eos_id"),
                              deadline_ms=deadline_ms,
                              trace=_body_trace(body),
                              tenant_id=tenant_id)
        except TransportRefused as e:
            return (503, {"error": "refused", "detail": str(e)[:200],
                          "draining": True})
        except (TypeError, ValueError) as e:
            return (400, {"error": f"{type(e).__name__}: {e}"[:200]})
        timeout = self.generate_timeout_s
        if deadline_ms is not None:
            timeout = min(timeout, deadline_ms / 1000.0 + 5.0)
        if not self.wait(req, timeout=timeout):
            return (504, {"error": "generate timed out",
                          "rid": req.rid})
        return {
            "rid": req.rid,
            "replica_id": self.replica_id,
            "tokens": [int(t) for t in req.generated],
            "shed_reason": req.shed_reason,
        }

    def handle_prefill(self, body):
        """``POST /v1/prefill``: run hop 1 and answer the serialized
        handoff. 503 on refusal so :class:`_HTTPCall`'s taxonomy maps
        it to TransportRefused (clean no, breaker untouched)."""
        prompt = body.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            return (400, {"error": "prompt must be a non-empty list "
                                   "of token ids"})
        try:
            out = self.prefill(prompt,
                               deadline_ms=body.get("deadline_ms"),
                               trace=_body_trace(body))
        except TransportRefused as e:
            return (503, {"error": "refused", "detail": str(e)[:200]})
        except TransportError as e:
            return (504, {"error": str(e)[:200]})
        except (TypeError, ValueError) as e:
            return (400, {"error": f"{type(e).__name__}: {e}"[:200]})
        return out

    def handle_import(self, body):
        """``POST /v1/import``: bind the handoff (hop 2), decode to
        completion, answer the full stream plus the server-measured
        bind wall (``bind_ms`` — the import half of handoff latency,
        unskewed by the HTTP round trip)."""
        max_new = body.get("max_new_tokens")
        if not isinstance(max_new, int) or max_new < 1:
            return (400, {"error": "max_new_tokens must be an "
                                   "int >= 1"})
        deadline_ms = body.get("deadline_ms")
        t0 = time.monotonic()
        try:
            req = self.import_request(
                body.get("handoff"), max_new,
                eos_id=body.get("eos_id"), deadline_ms=deadline_ms)
        except TransportRefused as e:
            return (503, {"error": "refused", "detail": str(e)[:200]})
        except TransportError as e:
            return (504, {"error": str(e)[:200]})
        except (TypeError, ValueError) as e:
            return (400, {"error": f"{type(e).__name__}: {e}"[:200]})
        bind_ms = (time.monotonic() - t0) * 1000.0
        timeout = self.generate_timeout_s
        if deadline_ms is not None:
            timeout = min(timeout, deadline_ms / 1000.0 + 5.0)
        if not self.wait(req, timeout=timeout):
            return (504, {"error": "decode timed out",
                          "rid": req.rid})
        return {
            "rid": req.rid,
            "replica_id": self.replica_id,
            "tokens": [int(t) for t in req.generated],
            "shed_reason": req.shed_reason,
            "bind_ms": bind_ms,
        }


# --------------------------------------------------------- in-process
class _InProcessCall:
    def __init__(self, gateway, req):
        self._gw = gateway
        self._req = req
        self.abandoned = False

    @property
    def done(self):
        return self._req.done or self._gw.dead

    def result(self, timeout=None):
        if not self._gw.wait(self._req, timeout=timeout):
            raise TransportError(
                f"in-process generate timed out "
                f"(rid {self._req.rid})")
        return {
            "rid": self._req.rid,
            "replica_id": self._gw.replica_id,
            "tokens": [int(t) for t in self._req.generated],
            "shed_reason": self._req.shed_reason,
        }

    def cancel(self):
        self.abandoned = True
        if self._gw.dead:
            return False
        return self._gw.cancel(self._req)


class InProcessTransport:
    """Router-side view of a same-process replica (engine+gateway).
    Token streams reach the router live via ``on_token`` — exactly
    what the journal needs for mid-stream failover."""

    def __init__(self, gateway, replica_id=None):
        self.gateway = gateway
        self.replica_id = replica_id or gateway.replica_id

    def begin(self, prompt, max_new_tokens, eos_id=None,
              deadline_ms=None, on_token=None, trace=None):
        cb = None
        if on_token is not None:
            cb = lambda _req, tok: on_token(int(tok))  # noqa: E731
        req = self.gateway.submit(prompt, max_new_tokens,
                                  eos_id=eos_id,
                                  deadline_ms=deadline_ms,
                                  on_token=cb, trace=trace)
        return _InProcessCall(self.gateway, req)

    def prefill(self, prompt, deadline_ms=None, trace=None):
        """Blocking hop 1: prompt KV + first token, serialized."""
        if self.gateway.dead:
            raise TransportError(
                f"replica {self.replica_id} is dead")
        return self.gateway.prefill(prompt, deadline_ms=deadline_ms,
                                    trace=trace)

    def decode_import(self, handoff, max_new_tokens, eos_id=None,
                      deadline_ms=None, on_token=None):
        """Blocking hop 2: bind the handoff, decode to completion.
        ``on_token`` streams post-first tokens live (the first token
        is already journaled from hop 1). Returns the generate-shaped
        dict plus ``bind_s``, the import-bind wall."""
        if self.gateway.dead:
            raise TransportError(
                f"replica {self.replica_id} is dead")
        cb = None
        if on_token is not None:
            cb = lambda _req, tok: on_token(int(tok))  # noqa: E731
        t0 = time.monotonic()
        req = self.gateway.import_request(
            handoff, max_new_tokens, eos_id=eos_id,
            deadline_ms=deadline_ms, on_token=cb)
        bind_s = time.monotonic() - t0
        timeout = self.gateway.generate_timeout_s
        if deadline_ms is not None:
            timeout = min(timeout, deadline_ms / 1000.0 + 5.0)
        if not self.gateway.wait(req, timeout=timeout):
            raise TransportError(
                f"in-process decode timed out (rid {req.rid})")
        return {
            "rid": req.rid,
            "replica_id": self.replica_id,
            "tokens": [int(t) for t in req.generated],
            "shed_reason": req.shed_reason,
            "bind_s": bind_s,
        }

    def health(self):
        eng = self.gateway.engine
        if self.gateway.dead:
            raise TransportError(
                f"replica {self.replica_id} is dead")
        if eng.health is not None:
            return eng.health.report()
        return {"healthy": True, "draining": eng._draining,
                "degraded": False}

    def state(self):
        if self.gateway.dead:
            raise TransportError(
                f"replica {self.replica_id} is dead")
        with self.gateway._lock:
            return self.gateway.engine.debug_state()

    def close(self):
        self.gateway.close()


# --------------------------------------------------------------- HTTP
class _HTTPCall:
    def __init__(self, url, payload, timeout_s):
        self._outcome = None    # ("ok", dict) | ("err", exc)
        self.abandoned = False

        def run():
            data = json.dumps(payload).encode("utf-8")
            req = urllib.request.Request(
                url, data=data,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(
                        req, timeout=timeout_s) as resp:
                    body = json.loads(resp.read().decode("utf-8"))
                self._outcome = ("ok", body)
            except Exception as e:   # noqa: BLE001 - classified below
                self._outcome = ("err", e)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="router-http-call")
        self._thread.start()

    @property
    def done(self):
        return self._outcome is not None

    def result(self, timeout=None):
        self._thread.join(timeout)
        if self._outcome is None:
            raise TransportError("HTTP generate timed out")
        kind, val = self._outcome
        if kind == "ok":
            return val
        if isinstance(val, urllib.error.HTTPError):
            if val.code == 503:
                raise TransportRefused(
                    f"replica refused (503)") from val
            raise TransportError(
                f"HTTP {val.code} from replica") from val
        raise TransportError(
            f"{type(val).__name__}: {val}"[:200]) from val

    def cancel(self):
        # no server-side cancel on the wire protocol: the loser runs
        # to completion on the replica, the router just abandons the
        # result (counted distinctly from a true cancel)
        self.abandoned = True
        return False


class HTTPTransport:
    """Router-side view of a replica across the wire. ``on_token`` is
    accepted but unused (the wire protocol is request/response, not
    streaming) — mid-stream failover degrades to full re-dispatch,
    which greedy determinism still makes bit-exact."""

    def __init__(self, url, replica_id=None, timeout_s=60.0,
                 probe_timeout_s=2.0):
        self.url = url.rstrip("/")
        if "://" not in self.url:
            self.url = "http://" + self.url
        self.replica_id = replica_id or self.url
        self.timeout_s = float(timeout_s)
        self.probe_timeout_s = float(probe_timeout_s)

    def begin(self, prompt, max_new_tokens, eos_id=None,
              deadline_ms=None, on_token=None, trace=None):
        payload = {"prompt": [int(t) for t in prompt],
                   "max_new_tokens": int(max_new_tokens)}
        payload.update(_trace_fields(trace))
        if eos_id is not None:
            payload["eos_id"] = int(eos_id)
        if deadline_ms is not None:
            payload["deadline_ms"] = float(deadline_ms)
        timeout = self.timeout_s
        if deadline_ms is not None:
            timeout = min(timeout, deadline_ms / 1000.0 + 5.0)
        return _HTTPCall(self.url + "/v1/generate", payload, timeout)

    def prefill(self, prompt, deadline_ms=None, trace=None):
        """Blocking hop 1 over the wire: POST ``/v1/prefill``."""
        payload = {"prompt": [int(t) for t in prompt]}
        payload.update(_trace_fields(trace))
        if deadline_ms is not None:
            payload["deadline_ms"] = float(deadline_ms)
        timeout = self.timeout_s
        if deadline_ms is not None:
            timeout = min(timeout, deadline_ms / 1000.0 + 5.0)
        return _HTTPCall(self.url + "/v1/prefill", payload,
                         timeout).result(timeout=timeout)

    def decode_import(self, handoff, max_new_tokens, eos_id=None,
                      deadline_ms=None, on_token=None):
        """Blocking hop 2 over the wire: POST ``/v1/import``.
        ``on_token`` is unused (request/response wire) — a mid-stream
        decode death degrades to full re-dispatch on a survivor,
        which greedy determinism keeps bit-exact."""
        payload = {"handoff": handoff,
                   "max_new_tokens": int(max_new_tokens)}
        if eos_id is not None:
            payload["eos_id"] = int(eos_id)
        if deadline_ms is not None:
            payload["deadline_ms"] = float(deadline_ms)
        timeout = self.timeout_s
        if deadline_ms is not None:
            timeout = min(timeout, deadline_ms / 1000.0 + 5.0)
        out = _HTTPCall(self.url + "/v1/import", payload,
                        timeout).result(timeout=timeout)
        if "bind_ms" in out:
            out["bind_s"] = float(out.pop("bind_ms")) / 1000.0
        return out

    def _get(self, path):
        try:
            with urllib.request.urlopen(
                    self.url + path,
                    timeout=self.probe_timeout_s) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except Exception as e:   # noqa: BLE001 - posture probe
            raise TransportError(
                f"{type(e).__name__}: {e}"[:200]) from e

    def health(self):
        return self._get("/debug/health")

    def state(self):
        return self._get("/debug/state")

    def close(self):
        pass
