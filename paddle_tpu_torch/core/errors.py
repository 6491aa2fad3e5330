"""Error-code taxonomy + enforce helpers (a copy of
``paddle_tpu/core/errors.py``).

Reference parity: paddle/fluid/platform/enforce.h:427 (PADDLE_ENFORCE*
macros), paddle/fluid/platform/errors.h + error_codes.proto (LEGACY,
INVALID_ARGUMENT, NOT_FOUND, OUT_OF_RANGE, ALREADY_EXISTS,
RESOURCE_EXHAUSTED, PRECONDITION_NOT_MET, PERMISSION_DENIED,
EXECUTION_TIMEOUT, UNIMPLEMENTED, UNAVAILABLE, FATAL, EXTERNAL) and
python/paddle/fluid/core error mapping (each code raises a dedicated
Python exception type that ALSO subclasses the natural builtin, so
except ValueError-style user code keeps working).
"""


class OutOfRangeError(IndexError):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(ValueError):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(MemoryError):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(RuntimeError):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(PermissionError):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(TimeoutError):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(NotImplementedError):
    code = "UNIMPLEMENTED"


class UnavailableError(RuntimeError):
    code = "UNAVAILABLE"


class FatalError(RuntimeError):
    code = "FATAL"


class ExternalError(OSError):
    code = "EXTERNAL"


class InvalidArgumentError(ValueError):
    code = "INVALID_ARGUMENT"


class NotFoundError(FileNotFoundError):
    code = "NOT_FOUND"


_ALL = (OutOfRangeError, AlreadyExistsError, ResourceExhaustedError,
        PreconditionNotMetError, PermissionDeniedError,
        ExecutionTimeoutError, UnimplementedError, UnavailableError,
        FatalError, ExternalError, InvalidArgumentError, NotFoundError)


def error_for_code(code):
    for cls in _ALL:
        if cls.code == code:
            return cls
    return FatalError


# -- enforce helpers (reference: enforce.h PADDLE_ENFORCE_* macros) -------

def enforce(cond, msg, exc=InvalidArgumentError):
    if not cond:
        raise exc(msg)


def enforce_eq(a, b, msg=None, exc=InvalidArgumentError):
    if a != b:
        raise exc(msg or f"expected equality, got {a!r} != {b!r}")


def enforce_ne(a, b, msg=None, exc=InvalidArgumentError):
    if a == b:
        raise exc(msg or f"expected inequality, got {a!r} == {b!r}")


def enforce_gt(a, b, msg=None, exc=InvalidArgumentError):
    if not a > b:
        raise exc(msg or f"expected {a!r} > {b!r}")


def enforce_ge(a, b, msg=None, exc=InvalidArgumentError):
    if not a >= b:
        raise exc(msg or f"expected {a!r} >= {b!r}")


def enforce_lt(a, b, msg=None, exc=InvalidArgumentError):
    if not a < b:
        raise exc(msg or f"expected {a!r} < {b!r}")


def enforce_le(a, b, msg=None, exc=InvalidArgumentError):
    if not a <= b:
        raise exc(msg or f"expected {a!r} <= {b!r}")


def enforce_not_none(v, msg=None, exc=NotFoundError):
    if v is None:
        raise exc(msg or "expected a value, got None")
    return v
