"""Concurrency analysis for the port's serving fleet (a port of part of
``paddle_tpu/analysis``).

* **Lint framework** (:mod:`.lint`) — :class:`Finding`, pluggable passes
  registered by name, and :func:`run_passes`, the runner with the
  reference's ``(passes, **meta)`` contract. The reference's jaxpr walk
  and its four jaxpr passes wait for the port's capture analogue.

* **Lock patrol** (:mod:`.threads`) — lockdep-style runtime deadlock
  lint: :func:`lock_patrol` wraps every Lock/RLock/Condition created
  inside ``paddle_tpu_torch.*`` with a site-attributed proxy, records
  the acquired-while-holding graph across threads, and reports cycles
  (``lock-order``) and locks held across the engine's program dispatch
  or blocking socket calls (``lock-held-across-dispatch``). Off by
  default; when off the only hot-path residue is one boolean test.

* **Concurrency lint** (:mod:`.concurrency`) — static AST passes over
  the port's sources: ``cross-role-write`` flags unlocked attribute
  writes reachable from two or more thread roles, against an allowlist
  whose rules carry evidence asserted on the port's text so they rot
  loudly; ``snapshot-discipline`` flags live host buffers (mutated in
  place elsewhere in the class) handed to a sink that reads them after
  the call returns (``torch.from_numpy``, a non-blocking copy, the
  engine's dispatch, the wire). :func:`audit_default` runs both.

Quick start::

    from paddle_tpu_torch import analysis

    with analysis.lock_patrol() as patrol:   # race/deadlock drill
        drive_engine()
    assert not patrol.findings()

    findings = analysis.audit_default()      # static concurrency audit
"""
from .lint import (  # noqa: F401
    SEVERITIES, Finding, findings_to_json, lint_passes, register_lint_pass,
    run_passes,
)
from .threads import (  # noqa: F401
    DEFAULT_PATROL_ALLOW, HeldAcrossFinding, LockOrderFinding, LockPatrol,
    disable_patrol, enable_patrol, lock_patrol, note_blocking, patrol_report,
)
from .concurrency import (  # noqa: F401
    DEFAULT_AUDIT_ALLOW, DEFAULT_AUDIT_SOURCES, DEFAULT_ROLE_MAP,
    DEFAULT_SNAPSHOT_SOURCES, AllowRule, AuditFinding, SnapshotFinding,
    audit_default,
)
