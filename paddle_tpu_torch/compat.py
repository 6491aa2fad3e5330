"""String and number helpers (a copy of ``paddle_tpu/compat.py``;
Paddle's ``python/paddle/compat.py``: the text conversions still used by
dataset and fleet plumbing and by user code).
"""
import math

__all__ = []

int_type = int
long_type = int


def _convert(obj, fn, inplace):
    if obj is None:
        return obj
    if isinstance(obj, (list, set)):
        converted = [_convert(item, fn, inplace) for item in obj]
        if inplace:
            obj.clear()
            if isinstance(obj, list):
                obj.extend(converted)
            else:
                obj.update(converted)
            return obj
        return type(obj)(converted)
    return fn(obj)


def to_text(obj, encoding="utf-8", inplace=False):
    """bytes -> str (elementwise through list/set containers);
    reference compat.py:25."""
    def one(o):
        if isinstance(o, bytes):
            return o.decode(encoding)
        return str(o) if not isinstance(o, str) else o
    return _convert(obj, one, inplace)


def to_bytes(obj, encoding="utf-8", inplace=False):
    """str -> bytes (elementwise through list/set containers);
    reference compat.py:121."""
    def one(o):
        if isinstance(o, str):
            return o.encode(encoding)
        return bytes(o) if not isinstance(o, bytes) else o
    return _convert(obj, one, inplace)


def round(x, d=0):  # noqa: A001
    """Half-away-from-zero rounding (python2 semantics the reference
    preserves; python3's builtin rounds half-to-even);
    reference compat.py:206."""
    p = 10 ** d
    if x > 0:
        return float(math.floor((x * p) + math.copysign(0.5, x))) / p
    if x < 0:
        return float(math.ceil((x * p) + math.copysign(0.5, x))) / p
    return math.copysign(0.0, x)


def floor_division(x, y):
    """reference compat.py:232."""
    return x // y


def get_exception_message(exc):
    """reference compat.py:249."""
    return str(exc)
