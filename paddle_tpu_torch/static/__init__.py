"""``paddle.static``, the switch alone (a port of the static-mode flag of
``paddle_tpu/static/__init__.py``): ``enable_static``,
``disable_static``, ``in_dynamic_mode`` and ``InputSpec``. With the
switch on, ``Model`` runs its steps through ``jit.to_static``.
``Program``, ``Executor`` and ``static.nn`` are not ported yet."""
from .input_spec import InputSpec  # noqa: F401

_static_mode = [False]


def enable_static():
    _static_mode[0] = True


def disable_static(place=None):
    _static_mode[0] = False


def in_dynamic_mode():
    return not _static_mode[0]
