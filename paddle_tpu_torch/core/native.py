"""ctypes bindings to the native runtime (a port of
``paddle_tpu/core/native.py`` over the same ``runtime_cpp/runtime.cc``).

Reference analogues: blocking queue (operators/reader/blocking_queue.h),
host arena allocator (memory/allocation/), trace collector
(platform/profiler.h), MultiSlot parser (framework/data_feed.cc).

The source is built on first use by one compiler command of its own
(``$CXX``, else ``g++``, with the runtime's Makefile flags) into
``paddle_tpu_torch/_build/libpaddle_tpu_runtime-<hash>.so``, the hash
covering the source and the flags; ``runtime_cpp/build/`` is never
written. Where the build fails, ``available()`` is False and the
classes raise ``RuntimeError``, as the reference's do.
"""
import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "runtime_cpp", "runtime.cc")
_BUILD = os.path.join(_PKG, "_build")
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
_lib = None
_lock = threading.Lock()


def library_path():
    """Where the built runtime goes: ``_build/`` and a hash of the source
    and the flags."""
    h = hashlib.sha256(open(_SRC, "rb").read())
    h.update(" ".join(CXXFLAGS).encode())
    return os.path.join(_BUILD,
                        f"libpaddle_tpu_runtime-{h.hexdigest()[:16]}.so")


def build():
    """Compile ``runtime_cpp/runtime.cc`` unless its library is built;
    returns the library's path or raises ``RuntimeError``."""
    try:
        so = library_path()
    except OSError as e:
        raise RuntimeError(f"native runtime source not found: {e}")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", "") or ""
        raise RuntimeError(f"native runtime build failed: {e} {detail}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.ptq_queue_create.restype = ctypes.c_void_p
        lib.ptq_queue_create.argtypes = [ctypes.c_size_t]
        lib.ptq_queue_put.restype = ctypes.c_int
        lib.ptq_queue_put.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
        lib.ptq_queue_get.restype = ctypes.c_int64
        lib.ptq_queue_get.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
        lib.ptq_queue_front_size.restype = ctypes.c_int64
        lib.ptq_queue_front_size.argtypes = [ctypes.c_void_p]
        lib.ptq_queue_size.restype = ctypes.c_size_t
        lib.ptq_queue_size.argtypes = [ctypes.c_void_p]
        lib.ptq_queue_close.argtypes = [ctypes.c_void_p]
        lib.ptq_queue_destroy.argtypes = [ctypes.c_void_p]
        lib.pta_arena_create.restype = ctypes.c_void_p
        lib.pta_arena_alloc.restype = ctypes.c_void_p
        lib.pta_arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.pta_arena_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_size_t]
        lib.pta_arena_stats.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_size_t)] * 4
        lib.pta_arena_destroy.argtypes = [ctypes.c_void_p]
        lib.ptt_trace_create.restype = ctypes.c_void_p
        lib.ptt_trace_now_us.restype = ctypes.c_int64
        lib.ptt_trace_now_us.argtypes = [ctypes.c_void_p]
        lib.ptt_trace_record.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int]
        lib.ptt_trace_dump.restype = ctypes.c_int64
        lib.ptt_trace_dump.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ptt_trace_destroy.argtypes = [ctypes.c_void_p]
        lib.ptd_parse_multislot.restype = ctypes.c_void_p
        lib.ptd_parse_multislot.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                            ctypes.c_int, ctypes.c_int]
        lib.ptd_slot_num_values.restype = ctypes.c_int64
        lib.ptd_slot_num_values.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ptd_slot_num_samples.restype = ctypes.c_int64
        lib.ptd_slot_num_samples.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ptd_slot_copy.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.POINTER(ctypes.c_int64)]
        lib.ptd_parsed_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available():
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


class NativeBlockingQueue:
    """MPMC bounded byte-buffer queue backed by C++ (GIL released during
    blocking waits via ctypes)."""

    def __init__(self, capacity=64):
        self._lib = _load()
        self._q = self._lib.ptq_queue_create(capacity)

    def put_bytes(self, data: bytes):
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        r = self._lib.ptq_queue_put(self._q, buf, len(data))
        if r != 0:
            raise RuntimeError("queue closed")

    def put_array(self, arr: np.ndarray):
        self.put_bytes(np.ascontiguousarray(arr).tobytes())

    def get_bytes(self):
        size = self._lib.ptq_queue_front_size(self._q)
        if size < 0:
            return None
        out = (ctypes.c_uint8 * size)()
        n = self._lib.ptq_queue_get(self._q, out, size)
        if n < 0:
            return None
        return bytes(out[:n])

    def qsize(self):
        return self._lib.ptq_queue_size(self._q)

    def close(self):
        self._lib.ptq_queue_close(self._q)

    def __del__(self):
        try:
            self._lib.ptq_queue_destroy(self._q)
        except Exception:
            pass


class NativeArena:
    """Aligned host slab allocator with stats (reference allocator facade
    semantics for host staging buffers)."""

    def __init__(self):
        self._lib = _load()
        self._a = self._lib.pta_arena_create()

    def buffer(self, nbytes):
        """Allocate and return (numpy uint8 view, release callable)."""
        p = self._lib.pta_arena_alloc(self._a, nbytes)
        if not p:
            raise MemoryError(nbytes)
        arr = np.ctypeslib.as_array(
            ctypes.cast(p, ctypes.POINTER(ctypes.c_uint8)), (nbytes,))

        def release():
            self._lib.pta_arena_free(self._a, p, nbytes)
        return arr, release

    def stats(self):
        vals = [ctypes.c_size_t() for _ in range(4)]
        self._lib.pta_arena_stats(self._a, *[ctypes.byref(v) for v in vals])
        return {"allocated_bytes": vals[0].value,
                "in_use_bytes": vals[1].value,
                "alloc_calls": vals[2].value,
                "cache_hits": vals[3].value}

    def __del__(self):
        try:
            self._lib.pta_arena_destroy(self._a)
        except Exception:
            pass


class NativeTrace:
    """Host event collector -> chrome://tracing JSON."""

    def __init__(self):
        self._lib = _load()
        self._t = self._lib.ptt_trace_create()

    def now_us(self):
        return self._lib.ptt_trace_now_us(self._t)

    def record(self, name, ts_us, dur_us, tid=0):
        self._lib.ptt_trace_record(self._t, name.encode(), ts_us, dur_us, tid)

    def dump(self, path):
        return self._lib.ptt_trace_dump(self._t, path.encode())

    def __del__(self):
        try:
            self._lib.ptt_trace_destroy(self._t)
        except Exception:
            pass


def parse_multislot(text, num_slots, num_threads=4):
    """Parse slot-format text (reference MultiSlotDataFeed format: per line,
    per slot '<n> v1..vn'). Returns list of (values float32 array,
    offsets int64 array) per slot — CSR over samples."""
    lib = _load()
    data = text.encode() if isinstance(text, str) else text
    ps = lib.ptd_parse_multislot(data, len(data), num_slots, num_threads)
    out = []
    try:
        for s in range(num_slots):
            nv = lib.ptd_slot_num_values(ps, s)
            ns = lib.ptd_slot_num_samples(ps, s)
            vals = np.empty(nv, np.float32)
            offs = np.empty(ns + 1, np.int64)
            lib.ptd_slot_copy(
                ps, s, vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            out.append((vals, offs))
    finally:
        lib.ptd_parsed_destroy(ps)
    return out
