"""Lint framework and the program passes (a port of
``paddle_tpu/analysis/lint.py``).

A pass is a function ``(program, meta) -> list[Finding]`` registered
with :func:`register_lint_pass`; :func:`run_passes` runs some or all of
them over one program (or None) and one metadata dict and sorts the
findings most severe first. A pass ignores the metadata keys it does
not use, and a pass whose input is absent contributes nothing, so one
call feeds every pass: the four program passes below, the lock patrol's
(:mod:`.threads`) and the two static concurrency passes
(:mod:`.concurrency`).

The reference walks a lowered jaxpr. The port compiles none, so the
passes walk the op list that a recording sees (:class:`Program`): the
torch calls of one run of the function under ``core.trace.RecordMode``,
each with its inputs' and outputs' shapes, dtypes and devices and the
user's call site, and the host reads among them. The record call of a
``to_static(..., lint=True)`` function keeps that list
(``TracedFunction.lint()``); :func:`lint_fn`
records a function on ``meta`` tensors, so nothing runs on a device.

``f64-upcast``
    an op that gives float64 from inputs that are not all float64 (or
    from none: a fresh f64 constant). Severity ``error``.
``donation``
    a large input (``min_donation_bytes``, 1 MiB by default) that the
    program returns a new buffer of (an output of its shape and dtype),
    updated out of place instead of written in place: the double
    buffering that donation avoids. An input written in place by the
    program, or flagged in ``donated_invars`` (see
    :func:`donated_invars_from_argnums`), is aliased. Emits nothing
    unless ``backend_aliases``, which defaults to True for a program on
    CUDA and False on the CPU. Severity ``warning``.
``dynamic-shape-risk``
    one key built under more than one shape signature, from
    ``watchdog=`` (``CompileWatchdog.signature_groups()``) and
    ``traced=`` (a ``TracedFunction``: entries that differ only in
    their tensors' shapes, each one more capture). Severity
    ``warning``.
``host-callback``
    a host read inside the program (``item``, ``tolist``, ``numpy``, a
    Tensor's ``bool``/``float``/``int``: a sync of the card each run),
    or an op on the CPU inside a program that runs on CUDA. Severity
    ``warning``.
"""
import dataclasses
import json

import numpy as np
import torch

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
    """Register ``fn(program_or_None, meta) -> list[Finding]`` under
    ``name``. Re-registering replaces (tests stub passes this way)."""
    def deco(fn):
        _PASSES[name] = fn
        return fn
    return deco


def lint_passes():
    """Names of all registered passes, sorted."""
    return sorted(_PASSES)


def run_passes(passes=None, program=None, **meta):
    """Run the registered passes (``passes`` selects a subset by name)
    over ``program`` (a :class:`Program` or None) and ``meta``; returns
    the findings sorted most severe first. An unknown pass name raises
    KeyError."""
    names = list(passes) if passes is not None else lint_passes()
    findings = []
    for name in names:
        fn = _PASSES.get(name)
        if fn is None:
            raise KeyError(f"unknown lint pass {name!r}; registered: "
                           f"{lint_passes()}")
        findings.extend(fn(program, meta) or [])
    findings.sort(key=lambda f: _SEV_ORDER.get(f.severity, len(SEVERITIES)))
    return findings


# ------------------------------------------------------------ the program

class Program:
    """What the program passes walk: ``ops``, the ``core.trace.OpRecord``
    list of one recorded run; ``invars``/``outvars``, the program's
    input and output tensors as ``(shape, dtype, device)``; ``cuda``,
    whether it ran on the card."""

    def __init__(self, ops, invars=(), outvars=(), cuda=None):
        self.ops = list(ops)
        self.invars = list(invars)
        self.outvars = list(outvars)
        if cuda is None:
            cuda = any(a[2] == "cuda" for op in self.ops
                       for a in op.inputs + op.outputs)
        self.cuda = bool(cuda)

    def written(self):
        """Indices of the inputs some op writes in place."""
        return {i for op in self.ops for i in op.writes}

    def __repr__(self):
        return (f"Program({len(self.ops)} ops, {len(self.invars)} inputs, "
                f"{len(self.outvars)} outputs, cuda={self.cuda})")


def _leaves(obj, out):
    """The tensors of a nested structure, in order (a port ``Tensor``
    by its torch value)."""
    from ..core.tensor import Tensor
    if isinstance(obj, Tensor):
        out.append(obj._value)
    elif isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _leaves(o, out)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=repr):
            _leaves(obj[k], out)
    return out


def _to_meta(obj):
    """``obj`` with every tensor replaced by a ``meta`` tensor of its
    shape, dtype, strides and ``requires_grad``."""
    from ..core.tensor import Tensor
    if isinstance(obj, Tensor):
        return Tensor._wrap(_to_meta(obj._value), name=obj.name)
    if isinstance(obj, torch.Tensor):
        m = torch.empty_strided(obj.shape, obj.stride(), dtype=obj.dtype,
                                device="meta")
        return m.requires_grad_(obj.requires_grad) \
            if obj.is_floating_point() or obj.is_complex() else m
    if isinstance(obj, (list, tuple)):
        seq = [_to_meta(o) for o in obj]
        return seq if isinstance(obj, list) else tuple(seq)
    if isinstance(obj, dict):
        return {k: _to_meta(v) for k, v in obj.items()}
    return obj


def program_from_trace(ctx, args, out):
    """The :class:`Program` of a run recorded under ``ctx`` (a
    ``TraceContext`` whose ``ops`` was a list) with inputs ``args`` and
    outputs ``out``."""
    from ..core.trace import _aval
    return Program(ctx.ops, [_aval(t) for t in _leaves(args, [])],
                   [_aval(t) for t in _leaves(out, [])],
                   cuda=getattr(ctx, "cuda", None) or None)


def input_ids(args):
    """``{id(root tensor): input index}`` for a ``TraceContext`` to map
    in-place writes onto the program's inputs."""
    from ..core.trace import root_tensor
    return {id(root_tensor(t)): i for i, t in enumerate(_leaves(args, []))}


def record_program(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once on ``meta`` copies of its tensor
    arguments under a recording trace and return its :class:`Program`;
    nothing runs on a device. A host read inside gives zeros (it is
    recorded, and the walk goes on)."""
    from ..core import trace as trace_mod
    margs, mkwargs = _to_meta(args), _to_meta(kwargs)
    ctx = trace_mod.TraceContext("record")
    ctx.ops = []
    ctx.placeholders = True
    ctx.invar_ids = input_ids((margs, mkwargs))
    with trace_mod.trace_guard(ctx), trace_mod.RecordMode(ctx):
        out = fn(*margs, **mkwargs)
    return Program(ctx.ops, [trace_mod._aval(t)
                             for t in _leaves((args, kwargs), [])],
                   [trace_mod._aval(t) for t in _leaves(out, [])],
                   cuda=any(t.is_cuda for t in _leaves((args, kwargs), [])))


def _resolve(target):
    """target -> Program: a Program, an object with ``.program``, or
    None (the metadata passes still run)."""
    if target is None or isinstance(target, Program):
        return target
    inner = getattr(target, "program", None)
    if isinstance(inner, Program):
        return inner
    raise TypeError(
        f"lint target {type(target).__name__} is not a Program; pass "
        "record_program(fn, *args) or use lint_fn(fn, *args), "
        "TracedFunction.lint() or ServingEngine.lint()")


def lint_program(target=None, passes=None, **meta):
    """Run the lint passes over a recorded program; returns the findings
    sorted most severe first. ``target``: a :class:`Program` (or an
    object with ``.program``), or None to run only the metadata passes
    (``dynamic-shape-risk`` over a ``watchdog=``). ``passes`` selects a
    subset by name. Metadata the program passes read:
    ``donated_invars``, ``backend_aliases``, ``min_donation_bytes``,
    ``watchdog``, ``traced``."""
    return run_passes(passes, program=_resolve(target), **meta)


# the reference's name for the same runner
lint_jaxpr = lint_program


def lint_fn(fn, *args, passes=None, **meta):
    """``lint_program(record_program(fn, *args), ...)``."""
    return lint_program(record_program(fn, *args), passes=passes, **meta)


def iter_eqns(program):
    """Every op of ``program`` in the order it ran, host reads
    included."""
    yield from program.ops


def eqn_site(op):
    """``file:line (function)`` of the user frame that made the op;
    "<unknown>" when unavailable."""
    return getattr(op, "site", None) or "<unknown>"


def donated_invars_from_argnums(args, donate_argnums):
    """Per-input donation flags for positional ``args`` with
    ``donate_argnums`` donated: the flattened tensor leaves of each
    argument, in order (the shape the ``donation`` pass reads)."""
    donate = set(donate_argnums)
    flags = []
    for i, a in enumerate(args):
        flags.extend([i in donate] * len(_leaves(a, [])))
    return tuple(flags)


# ---------------------------------------------------------------- passes

_F64 = torch.float64


@register_lint_pass("f64-upcast")
def _pass_f64_upcast(program, meta):
    if program is None:
        return []
    findings = []
    for op in iter_eqns(program):
        if op.kind != "op" or not any(a[1] == _F64 for a in op.outputs):
            continue
        in_dtypes = [a[1] for a in op.inputs]
        if in_dtypes and all(dt == _F64 for dt in in_dtypes):
            continue    # f64 flowing through; the first upcast is flagged
        src = ",".join(sorted({str(dt).replace("torch.", "")
                               for dt in in_dtypes})) or "<none>"
        findings.append(Finding(
            "f64-upcast", "error", eqn_site(op),
            f"{op.name} produces float64 from [{src}] — silent f64 "
            "promotion on the hot path (2x memory; the card's f64 rate "
            "is a fraction of f32's)"))
    return findings


def _nbytes(aval):
    shape, dtype, _ = aval
    return int(np.prod(shape or (1,))) * torch.empty(
        (), dtype=dtype).element_size()


@register_lint_pass("donation")
def _pass_donation(program, meta):
    if program is None:
        return []
    aliases = meta.get("backend_aliases")
    if aliases is None:
        aliases = program.cuda
    if not aliases:
        # the CPU: a copy there is no device memory to save
        return []
    donated = tuple(meta.get("donated_invars") or ())
    min_bytes = int(meta.get("min_donation_bytes", 1 << 20))
    written = program.written()
    outs = {(tuple(a[0]), a[1]) for a in program.outvars}
    findings = []
    for i, aval in enumerate(program.invars):
        nbytes = _nbytes(aval)
        is_donated = (donated[i] if i < len(donated) else False) \
            or i in written
        if nbytes >= min_bytes and not is_donated \
                and (tuple(aval[0]), aval[1]) in outs:
            dt = str(aval[1]).replace("torch.", "")
            findings.append(Finding(
                "donation", "warning", f"invar[{i}]",
                f"{dt}[{','.join(str(d) for d in aval[0])}] ({nbytes} "
                "bytes) is returned as a new buffer of its shape, not "
                "written in place — the update double-buffers instead "
                "of aliasing (the serving engine writes its KV cache in "
                "place)"))
    return findings


def _signature_sources(meta):
    return [s for s in (meta.get("watchdog"), meta.get("traced"))
            if s is not None]


@register_lint_pass("dynamic-shape-risk")
def _pass_dynamic_shape_risk(program, meta):
    findings = []
    for source in _signature_sources(meta):
        for key, group in sorted(source.signature_groups().items()):
            sigs = group["signatures"]
            if len(sigs) <= 1:
                continue
            sites = group["call_sites"]
            findings.append(Finding(
                "dynamic-shape-risk", "warning", sites[-1],
                f"{key} built under {len(sigs)} distinct shape "
                "signatures — a shape that follows the data builds (and "
                f"captures) once per value; signatures: {sigs[:4]}"))
    return findings


@register_lint_pass("host-callback")
def _pass_host_callback(program, meta):
    if program is None:
        return []
    findings = []
    for op in iter_eqns(program):
        if op.kind == "host_read":
            findings.append(Finding(
                "host-callback", "warning", eqn_site(op),
                f"{op.name}() of a tensor inside the program — one "
                "host round-trip per run (a print or "
                "float(loss) left in a decode/train step?)"))
        elif program.cuda and op.inputs and all(
                a[2] == "cpu" for a in op.inputs + op.outputs):
            findings.append(Finding(
                "host-callback", "warning", eqn_site(op),
                f"{op.name} runs on the CPU inside a program that runs "
                "on CUDA — host work between the card's launches"))
    return findings
