"""``paddle._C_ops`` (a port of ``paddle_tpu/_C_ops.py``; reference
python/paddle/_C_ops.py, the generated per-op fast entry points of
pybind/op_function_generator.cc).

A registered ``Op`` is the port's counterpart of a generated entry point:
calling it goes straight into the dispatcher, which defers it into the
lazy graph (``core/lazy.py``) under ``FLAGS_lazy_eager``, or runs it.
``_C_ops.<name>`` resolves the registry's op by name on first use and
caches the wrapper in this module, so later reads are plain attribute
lookups; ``dir()`` lists the registry.

The reference's calling convention: the tensors, then alternating
``'attr', value`` pairs, e.g. ``_C_ops.matmul_v2(x, y, 'trans_x', False,
'trans_y', False)``; keywords work too. ``_ATTR_ALIASES`` maps the
generated spellings onto the ops' keywords, and ``_DEFAULTS`` fills the
attributes a call leaves out. A required attribute still missing raises
``TypeError``; an unknown op ``AttributeError``.
"""
__all__ = []

# the generated entry points' attr spellings differ from the op
# kernels' keyword names for a few hot ops
_ATTR_ALIASES = {"trans_x": "transpose_x", "trans_y": "transpose_y"}

# the reference's generated functions fall back to op-registered attr
# defaults when a call omits attrs; the registry's ops take required
# keyword-only attrs, so the common defaults live here
_DEFAULTS = {
    "matmul_v2": {"transpose_x": False, "transpose_y": False},
    "matmul": {"transpose_x": False, "transpose_y": False},
    "softmax": {"axis": -1},
    "concat": {"axis": 0},
}

# modules that register ops when imported
_OP_MODULES = ("ops", "ops.linalg", "ops.sequence", "nn.functional",
               "vision.ops")


def _wrap(op):
    """The reference's convention (positional tensors, then alternating
    ``'attr_name', value`` pairs) onto the registry op's ``(tensors...,
    **attrs)``."""
    import inspect

    try:
        required = {
            p.name for p in inspect.signature(op.fn).parameters.values()
            if p.kind is inspect.Parameter.KEYWORD_ONLY
            and p.default is inspect.Parameter.empty}
    except (TypeError, ValueError):
        required = set()
    defaults = _DEFAULTS.get(op.name, {})

    def call(*args, **kwargs):
        pos = []
        i = 0
        while i < len(args) and not isinstance(args[i], str):
            pos.append(args[i])
            i += 1
        attrs = {_ATTR_ALIASES.get(k, k): v for k, v in kwargs.items()}
        while i + 1 < len(args):
            k = args[i]
            attrs[_ATTR_ALIASES.get(k, k)] = args[i + 1]
            i += 2
        for k in (required - attrs.keys()) & defaults.keys():
            attrs[k] = defaults[k]
        still = required - attrs.keys()
        if still:
            raise TypeError(
                f"_C_ops.{op.name} requires attrs {sorted(still)} "
                f"(pass as keywords or alternating name/value pairs)")
        return op(*pos, **attrs)

    call.__name__ = op.name
    call.op = op
    return call


def __getattr__(name):
    import importlib

    from .core.dispatch import _REGISTRY

    if name not in _REGISTRY:
        # op modules register on import; load them before declaring the
        # name missing (an import error of theirs propagates)
        for mod in _OP_MODULES:
            importlib.import_module(f"{__name__.rsplit('.', 1)[0]}.{mod}")
    if name in _REGISTRY:
        fn = _wrap(_REGISTRY[name])
        globals()[name] = fn    # later reads skip __getattr__
        return fn
    raise AttributeError(
        f"no registered op {name!r} (see paddle_tpu_torch.core.dispatch)")


def __dir__():
    from .core.dispatch import _REGISTRY
    return sorted(_REGISTRY)
