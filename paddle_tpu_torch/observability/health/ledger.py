"""Per-step serving ledger: the health observatory's flight data (a
copy of ``paddle_tpu/observability/health/ledger.py``).

Every engine step appends ONE structured row — wall/dispatch/sync
seconds, queue and slot state, token/admission/shed deltas, paged-pool
block economy, compile flags — into a bounded ring. The ledger is the
black box the anomaly detectors (health.detectors) evaluate online and
the incident bundles (health.incidents) snapshot at capture time: when
a serve loop wedges, the last rows name the step it died on and what
the engine was doing there.

Rows are plain JSON-safe dicts; ``LEDGER_ROW_KEYS`` is the schema
contract (tests pin it — keys only get added, never renamed). The
ledger itself is dumb bounded storage: the ENGINE authors rows (it
owns the counters the deltas come from), detectors only read.
"""
import collections
import threading

# the per-step row schema the engine authors (tests/test_health.py pins
# this contract; incident_report.py renders a table from it)
LEDGER_ROW_KEYS = (
    "step",               # engine step id (1-based, monotone)
    "t",                  # wall-clock epoch seconds at row append
    "wall_s",             # step wall time (serving/step scope)
    "dispatch_s",         # delta wall spent ISSUING device work
    "sync_s",             # delta wall BLOCKED on device->host reads
    "queue_depth",        # queued requests after the step
    "queue_age_s",        # how long the queue head has waited
    "occupied_slots",     # live slots after the step
    "chunked_inflight",   # chunk plans still mid-prefill
    "admitted",           # requests admitted this step
    "tokens",             # tokens emitted this step
    "completed",          # requests retired this step
    "goodput_tokens",     # SLO-met tokens credited this step
    "prefill_tokens",     # prompt tokens computed this step
    "prefill_chunks",     # chunked-prefill dispatches this step
    "shed",               # requests load-shed this step
    "deprioritized",      # requests deferred this step
    "new_compiles",       # executables built this step
    "steady_compiles",    # of those, after declared warmup
    "slo_on",             # SLO targets configured (bool)
    "prefix_hit_rate",    # cumulative prefix-cache hit rate (None=n/a)
    "pool_free_blocks",   # paged pool economy (None on legacy pool)
    "pool_evictable_blocks",
    "pool_live_blocks",
    "conservation_ok",    # periodic audit verdict (None = not audited)
    "conservation_error",
    "cache_thrash",       # radix evict-then-reinsert events this step
    "pool_evictable_delta",  # evictable-block count change this step
)


class StepLedger:
    """Thread-safe bounded ring of per-step rows.

    ``keep`` bounds memory under serve-forever traffic (the same
    discipline as the flight recorder's completed ring); ``steps``
    counts every row ever appended, so ``steps - kept`` is the
    overwritten history.
    """

    def __init__(self, keep=512):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.keep = int(keep)
        self._rows = collections.deque(maxlen=self.keep)
        self._steps = 0
        self._lock = threading.Lock()

    def append(self, row):
        """Append one row. The ledger takes OWNERSHIP of the dict (no
        defensive copy — this runs on every engine step); readers get
        copies from rows()/last()."""
        with self._lock:
            self._rows.append(row)
            self._steps += 1

    @property
    def steps(self):
        """Rows ever appended (ring overwrites don't un-count)."""
        return self._steps

    @property
    def last_step_id(self):
        """The ``step`` field of the newest row; 0 before any step —
        the heartbeat's "last thing the engine finished" attribution."""
        with self._lock:
            return self._rows[-1]["step"] if self._rows else 0

    def __len__(self):
        with self._lock:
            return len(self._rows)

    def last(self):
        with self._lock:
            return dict(self._rows[-1]) if self._rows else None

    def rows(self, last=None):
        """The newest ``last`` rows (all kept rows when None), oldest
        first, as copies — safe to serialize while stepping."""
        with self._lock:
            rows = list(self._rows)
        if last is not None:
            rows = rows[-int(last):]
        return [dict(r) for r in rows]

    def tail(self, n):
        return self.rows(last=n)

    def as_dict(self, last=None):
        """The ``/debug/ledger`` JSON body."""
        rows = self.rows(last=last)
        return {
            "steps": self._steps,
            "kept": len(self),
            "keep": self.keep,
            "last_step": self.last_step_id,
            "rows": rows,
        }
