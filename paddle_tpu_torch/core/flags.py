"""Process-level flags, ``paddle.set_flags`` / ``get_flags`` style (a
port of ``paddle_tpu/core/flags.py``), with the reference's names and
defaults.

What reads each flag in the port:

* ``FLAGS_check_nan_inf`` — the eager dispatcher (``core/dispatch.py``)
  scans every float output of a core op and raises FloatingPointError on
  a NaN or an Inf.
* ``FLAGS_lazy_eager`` (default True, as the reference's) — read by
  the lazy eager executor (``core/lazy.py``): eager ops, backward and
  optimizer steps are deferred into a graph that runs at a host read or
  at ``optimizer.clear_grad()``, on the card as one CUDA graph replayed
  per step. False gives the immediate path, each op run when called.
* ``FLAGS_deterministic``, ``FLAGS_log_compiles`` and
  ``FLAGS_fuse_parameter_memory_size`` — kept and read by nothing: the
  port's kernels use no atomics (two runs give the same bits), it
  compiles nothing per op and has no data-parallel reducer yet.
* ``FLAGS_compilation_cache_dir`` and
  ``FLAGS_compilation_cache_min_compile_secs`` — configured XLA's
  persistent compilation cache in the reference; kept and read by
  nothing (the port's kernels are built once into the package's
  ``_build/``). The directory's default is the reference's path, left
  unexpanded.

The reference also reads ``FLAGS_*`` from the environment; the port
reads no environment, so a flag is its default until ``set_flags``.
"""
import os

_DEFAULTS = {
    "FLAGS_check_nan_inf": False,
    "FLAGS_deterministic": True,
    "FLAGS_log_compiles": False,
    "FLAGS_fuse_parameter_memory_size": 25.0,
    "FLAGS_compilation_cache_dir": os.path.join(
        "~", ".cache", "paddle_tpu", "xla"),
    "FLAGS_compilation_cache_min_compile_secs": 0.3,
    "FLAGS_lazy_eager": True,
}

_flags = {}


def _coerce(default, v):
    if isinstance(default, bool):
        if isinstance(v, str):
            return v.lower() in ("1", "true", "yes", "on")
        return bool(v)
    if isinstance(default, float):
        return float(v)
    if isinstance(default, int):
        return int(v)
    return v


def get_flag(name):
    if name in _flags:
        return _flags[name]
    return _DEFAULTS.get(name)


def set_flags(flags):
    """``paddle.set_flags({'FLAGS_check_nan_inf': 1})``: each value is
    coerced to its flag's default type (an unknown flag is kept as
    given)."""
    for k, v in flags.items():
        default = _DEFAULTS.get(k)
        _flags[k] = _coerce(default, v) if default is not None else v


def get_flags(names):
    if isinstance(names, str):
        names = [names]
    return {n: get_flag(n) for n in names}
