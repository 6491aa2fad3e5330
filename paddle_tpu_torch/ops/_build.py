"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` into ``_build/<name>-<hash>.so`` (the hash covers the
source text and the flags, so an edited source rebuilds and an
unchanged one is reused). The library is loaded with ``ctypes``; no
PyTorch header is compiled, which keeps a build to seconds.

Nothing here runs at import: the first wrapper call on a CUDA tensor
builds (or finds) its library. ``build_all`` starts one ``nvcc`` per
source at once, for callers that want every kernel ready up front.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}      # kernel source name -> loaded ctypes.CDLL
_fns = {}       # (source name, symbol) -> declared ctypes function


def nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _paths(name):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{tag}.so", BUILD_DIR / f"{name}-{tag}.log"


def _start(name):
    """Start ``nvcc`` for one source unless its library is already
    built; returns (popen or None, output path, log path, tmp path)."""
    src, so, log = _paths(name)
    if so.exists():
        return None, so, log, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, so, log, tmp


def _finish(name, proc, so, log, tmp):
    out, _ = proc.communicate()
    log.write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)


def sources():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all():
    """Build every ``csrc/*.cu`` with one ``nvcc`` each, all started
    together. Returns the wall seconds the builds took."""
    t0 = time.perf_counter()
    with _lock:
        started = [(n, *_start(n)) for n in sources()]
        try:
            for name, proc, so, log, tmp in started:
                if proc is not None:
                    _finish(name, proc, so, log, tmp)
        finally:
            for _, proc, _, _, _ in started:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return time.perf_counter() - t0


def build_log(name):
    """What ``nvcc``/``ptxas`` printed for the current build of
    ``name`` (registers, shared memory, spills), or '' if it was not
    built by this checkout."""
    _, _, log = _paths(name)
    return log.read_text() if log.exists() else ""


def load(name):
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            proc, so, log, tmp = _start(name)
            if proc is not None:
                _finish(name, proc, so, log, tmp)
            lib = _libs[name] = ctypes.CDLL(str(so))
        return lib


def function(name, symbol, argtypes):
    """``symbol`` of ``csrc/<name>.cu`` with its C signature declared:
    pointers and the stream as ``c_void_p`` (a bare int would be cut to
    32 bits), the return value the launch's ``cudaGetLastError()``."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn
