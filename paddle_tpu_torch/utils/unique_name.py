"""``paddle.utils.unique_name`` (a port of
``paddle_tpu/utils/unique_name.py``; Paddle's
``fluid/unique_name.py``: ``generate``, ``guard``, ``switch``)."""
import contextlib

_generators = [{}]


def generate(key):
    """``key_N`` with an increasing N for each key in the current
    generator."""
    counters = _generators[-1]
    n = counters.get(key, 0)
    counters[key] = n + 1
    return f"{key}_{n}"


def generate_with_ignorable_key(key):
    return generate(key)


def switch(new_generator=None):
    """Make ``new_generator`` (a fresh one when None) current; returns
    the one it replaces."""
    old = _generators[-1]
    _generators[-1] = new_generator if new_generator is not None else {}
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    """A fresh name scope (or ``new_generator``, a dict); the previous
    one comes back on exit."""
    _generators.append(new_generator if isinstance(new_generator, dict)
                       else {})
    try:
        yield
    finally:
        _generators.pop()
