"""Lint framework: pluggable analysis passes emitting machine-readable
findings (a port of ``paddle_tpu/analysis/lint.py:48-90``).

A pass is a function ``(meta) -> list[Finding]`` registered with
:func:`register_lint_pass`; :func:`run_passes` runs some or all of them
over one metadata dict and sorts the findings most severe first. A pass
ignores the metadata keys it does not use, so one call can feed every
pass, and a pass whose key is absent contributes nothing.

The reference's runner, ``lint_jaxpr``, also walks a lowered jaxpr
through four passes of its own (``f64-upcast``, ``donation``,
``dynamic-shape-risk``, ``host-callback``). The port compiles no
jaxpr, so it keeps the runner's ``(passes, **meta)`` contract and the
passes that read metadata only: the lock patrol's and the two static
concurrency passes (:mod:`.threads`, :mod:`.concurrency`).
"""
import dataclasses
import json

SEVERITIES = ("error", "warning", "info")
_SEV_ORDER = {s: i for i, s in enumerate(SEVERITIES)}


@dataclasses.dataclass
class Finding:
    """One lint finding. ``to_dict()`` is the machine-readable schema
    (the ``pass`` key carries the pass name)."""
    pass_name: str
    severity: str
    site: str
    detail: str

    def to_dict(self):
        return {"pass": self.pass_name, "severity": self.severity,
                "site": self.site, "detail": self.detail}

    def __str__(self):
        return (f"[{self.severity}] {self.pass_name} @ {self.site}: "
                f"{self.detail}")


def findings_to_json(findings, indent=2):
    return json.dumps([f.to_dict() for f in findings], indent=indent)


_PASSES = {}


def register_lint_pass(name):
    """Register ``fn(meta) -> list[Finding]`` under ``name``.
    Re-registering replaces (tests stub passes this way)."""
    def deco(fn):
        _PASSES[name] = fn
        return fn
    return deco


def lint_passes():
    """Names of all registered passes, sorted."""
    return sorted(_PASSES)


def run_passes(passes=None, **meta):
    """Run the registered passes (``passes`` selects a subset by name)
    over ``meta``; returns the findings sorted most severe first. An
    unknown pass name raises KeyError."""
    names = list(passes) if passes is not None else lint_passes()
    findings = []
    for name in names:
        fn = _PASSES.get(name)
        if fn is None:
            raise KeyError(f"unknown lint pass {name!r}; registered: "
                           f"{lint_passes()}")
        findings.extend(fn(meta) or [])
    findings.sort(key=lambda f: _SEV_ORDER.get(f.severity, len(SEVERITIES)))
    return findings
