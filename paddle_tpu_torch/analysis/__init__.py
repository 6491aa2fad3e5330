"""Concurrency analysis for the port's serving fleet (a port of part of
``paddle_tpu/analysis``).

* **Lint framework** (:mod:`.lint`) — :class:`Finding`, pluggable passes
  registered by name, :func:`run_passes`, and the reference's four
  program passes (``f64-upcast``, ``donation``, ``dynamic-shape-risk``,
  ``host-callback``) over the op list a recording keeps
  (:class:`Program`): :func:`lint_fn` records a function on ``meta``
  tensors, ``TracedFunction.lint()`` (of a ``to_static(...,
  lint=True)`` function) and ``ServingEngine.lint()`` walk a captured
  step and the engine's decode.

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

* **Leak detector** (:mod:`.birth`) — birth-site attribution for a
  Tensor born inside a captured branch or loop body (``static.nn.cond``
  / ``while_loop``) that escapes its scope other than as an output:
  :func:`birth_tracking` turns it on, an escape raises
  :class:`TracerLeakError` naming the birth op, its ``file:line`` and
  the scope (``cond_true#n``, ``while_body#n``).

Quick start::

    from paddle_tpu_torch import analysis

    with analysis.lock_patrol() as patrol:   # race/deadlock drill
        drive_engine()
    assert not patrol.findings()

    findings = analysis.audit_default()      # static concurrency audit
"""
from .lint import (  # noqa: F401
    SEVERITIES, Finding, Program, donated_invars_from_argnums, eqn_site,
    findings_to_json, iter_eqns, lint_fn, lint_jaxpr, lint_passes,
    lint_program, record_program, register_lint_pass, run_passes,
)
from .threads import (  # noqa: F401
    DEFAULT_PATROL_ALLOW, HeldAcrossFinding, LockOrderFinding, LockPatrol,
    disable_patrol, enable_patrol, lock_patrol, note_blocking, patrol_report,
)
from .birth import (  # noqa: F401
    BirthSite, TracerLeakError, birth_of, birth_tracking, check_trace,
    disable, enable, enabled, subtrace,
)
from .concurrency import (  # noqa: F401
    DEFAULT_AUDIT_ALLOW, DEFAULT_AUDIT_SOURCES, DEFAULT_ROLE_MAP,
    DEFAULT_SNAPSHOT_SOURCES, AllowRule, AuditFinding, SnapshotFinding,
    audit_default,
)
