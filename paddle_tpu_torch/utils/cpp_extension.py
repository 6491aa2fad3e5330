"""Custom ops (a port of ``paddle_tpu/utils/cpp_extension.py``;
Paddle's ``paddle/fluid/extension/`` and
``python/paddle/utils/cpp_extension/``).

A device op is a torch function registered with the port's dispatcher
(``register_custom_op``, through ``core.dispatch.register_op``): it runs
on the card as the built-in ops do, and under lazy eager it joins the
graph. A host op is C++ CPU code (a tokenizer, a sampler, a feature
extractor) that ``load`` compiles with ``g++`` into a shared library
under ``get_build_directory()`` and loads with ``ctypes``. Its C ABI is
the reference's::

    void op(const float** ins, const int64_t* in_sizes, int n_in,
            float* out, int64_t out_size)

The inputs are passed as f32 and the output has the first input's
shape. Given CUDA tensors, a host op copies them to the host, calls the
op and returns the result on their device: that is the host op's
contract, as the reference's ``jax.pure_callback`` is. It runs at once,
never inside a lazy graph or a captured one. ``CUDAExtension`` raises,
as the reference's does; a device kernel is registered with
``register_custom_op`` instead.
"""
import ctypes
import hashlib
import os
import subprocess

import numpy as np
import torch

from ..core.dispatch import register_op as _register_op

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def register_custom_op(name, fn, differentiable=True):
    """Register a torch function as a framework op (the device path).
    Returns a callable taking and returning Tensors."""
    return _register_op(name, differentiable=differentiable)(fn)


def get_build_directory(verbose=False):
    """Where ``load`` builds (reference ``extension_utils.py``
    ``get_build_directory``): ``PADDLE_EXTENSION_DIR``, else
    ``_build/extensions`` in the package, beside its kernels."""
    path = os.environ.get("PADDLE_EXTENSION_DIR") or os.path.join(
        _PKG, "_build", "extensions")
    os.makedirs(path, exist_ok=True)
    return path


def _build(name, sources, flags, build_dir, verbose):
    """The shared library of ``sources``, built once for their contents
    and flags (into a temporary name, then renamed, so that concurrent
    builds of one library never load a half-written file)."""
    h = hashlib.md5()
    for src in sources:
        h.update(os.path.abspath(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    so_path = os.path.join(build_dir, f"{name}_{h.hexdigest()[:12]}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = (["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o", tmp]
           + list(sources) + flags)
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"extension build failed:\n{res.stderr}")
    os.replace(tmp, so_path)
    if verbose:
        print(f"built {so_path}")
    return so_path


class _HostOps:
    """A loaded host-op library: each attribute is an exported op as a
    callable over Tensors."""

    def __init__(self, name, lib):
        self._name = name
        self._lib = lib

    def __getattr__(self, sym):
        if sym.startswith("_"):
            raise AttributeError(sym)
        cfn = getattr(self._lib, sym)
        cfn.restype = None
        cfn.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64]

        def host_call(*arrays):
            arrs = [np.ascontiguousarray(a, np.float32) for a in arrays]
            out = np.empty_like(arrs[0])
            ptrs = (ctypes.POINTER(ctypes.c_float) * len(arrs))(
                *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                  for a in arrs])
            sizes = (ctypes.c_int64 * len(arrs))(*[a.size for a in arrs])
            cfn(ptrs, sizes, len(arrs),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                out.size)
            return out

        def op_fn(*xs):
            dev = xs[0].device
            if dev.type == "meta":
                raise RuntimeError("a host op runs at once")
            out = host_call(*[x.detach().to("cpu", torch.float32).numpy()
                              for x in xs])
            return torch.from_numpy(out).to(dev)

        wrapped = _register_op(f"custom_{self._name}_{sym}",
                               differentiable=False)(op_fn)

        def api(*tensors):
            return wrapped(*tensors)
        api.__name__ = sym
        setattr(self, sym, api)     # resolved and registered once
        return api


def load(name, sources, extra_cxx_cflags=None, build_directory=None,
         verbose=False, **kwargs):
    """Compile C++ ``sources`` into a host-op library (reference
    ``cpp_extension.load``) and load it; attribute lookups on the result
    resolve the exported ops as Python callables."""
    build_dir = build_directory or get_build_directory()
    os.makedirs(build_dir, exist_ok=True)
    so_path = _build(name, list(sources), list(extra_cxx_cflags or []),
                     build_dir, verbose)
    return _HostOps(name, ctypes.CDLL(so_path))


class CppExtension:
    """``setup()``'s descriptor of a host-op extension (reference
    ``CppExtension``), built by ``load``."""

    def __init__(self, sources, **kwargs):
        self.sources = sources
        self.kwargs = kwargs


def CUDAExtension(*args, **kwargs):
    raise RuntimeError(
        "CUDAExtension is not built by this package: register a device "
        "op as a torch function with register_custom_op, or build host "
        "C++ ops with cpp_extension.load")


def setup(name=None, ext_modules=None, **kwargs):
    """Reference ``cpp_extension.setup``: each extension is built into
    the build directory by ``load`` (no egg or install step); returns
    the loaded libraries."""
    mods = ext_modules if isinstance(ext_modules, (list, tuple)) \
        else ([ext_modules] if ext_modules is not None else [])
    built = []
    for ext in mods:
        srcs = getattr(ext, "sources", None) or []
        ext_name = getattr(ext, "name", None) or name
        built.append(load(ext_name, srcs,
                          build_directory=get_build_directory()))
    return built
