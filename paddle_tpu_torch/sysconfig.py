"""Build-config queries (a port of ``paddle_tpu/sysconfig.py``;
Paddle's ``python/paddle/sysconfig.py``): ``get_include`` and
``get_lib`` for compiling extensions against the package. Host ops build
through ``utils.cpp_extension`` with a C ABI and need no header of the
package; ``get_lib`` is the port's native build directory
(``paddle_tpu_torch/_build/``: its kernels and the native runtime),
the counterpart of the reference's ``runtime_cpp``.
"""
import os

__all__ = ["get_include", "get_lib"]

_PKG = os.path.dirname(os.path.abspath(__file__))


def get_include():
    """Directory of the C/C++ headers shipped with the package."""
    return os.path.join(_PKG, "include")


def get_lib():
    """Directory of the package's native shared objects."""
    return os.path.join(_PKG, "_build")
