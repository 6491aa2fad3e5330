"""Conditional nodes inside a captured CUDA graph: the port's ``if`` and
``while`` on a device value (``static.nn.cond`` / ``while_loop`` under
``jit.to_static``'s capture).

The reference lowers a Tensor ``if`` to ``lax.cond`` and a Tensor
``while`` to ``lax.while_loop``: one compiled program in which the
device picks the branch and counts the trips. A CUDA graph cannot read a
device value on the host, so the port captures each branch and each loop
body into a CUDA conditional node (CUDA 12.4; ``csrc/graph_cond.cu``
adds them, torch 2.11 binds none): the node's body graph runs when (an
``if``) or as long as (a ``while``) a flag on the device is set, the
flag being written by a one-thread kernel captured before the node (and,
for a ``while``, again at the end of its body). So a replay runs only
the branch the data picks, as many loop trips as the data asks, and the
graph is captured once for every predicate and trip count.

An ``if``/``else`` is two ``if`` nodes, on the predicate and on its
negation; the first branch's outputs are copied into buffers of their
own and the second branch writes its outputs into the same buffers. A
``while``'s carried values live in buffers made before the node; its
body reads them, then writes the new values and the new condition into
them.

A body is captured on a stream of its own, one a nesting depth, made by
``cudaStreamCreateWithFlags`` (a stream cannot capture two graphs at
once, and torch's pool hands the same stream out again); its allocations go to a second memory pool of the
``to_static`` function (the graph's own pool refuses a second routing),
kept for the graph's life.

A hand-written kernel captured inside a body runs only when the body
does, so its launches are not among those a replay adds on the host
(``jit/to_static.py``): the body itself adds them, once each time it
runs, to a counter on the card that the capture context holds, and
``to_static`` reads that counter after the replay.
"""
import contextlib
import ctypes

import torch

# (device index, depth) -> the body stream at that depth; (device index,
# "warm") -> the warm-up captures' stream
_streams = {}
_depth = [0]


def _lib():
    from ..ops import _build
    u64 = ctypes.c_ulonglong
    begin = _build.function(
        "graph_cond", "graph_cond_begin",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.POINTER(u64)])
    end = _build.function(
        "graph_cond", "graph_cond_end",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, u64])
    return begin, end


_STEPS = {1: "reading the capture", 2: "creating the condition handle",
          3: "capturing the condition kernel", 4: "reading the capture",
          5: "adding the conditional node", 6: "setting the dependencies",
          7: "starting the body's capture",
          8: "capturing the body's condition kernel",
          9: "ending the body's capture"}


def _status(stream):
    from ..ops import _build
    fn = _build.function("graph_cond", "graph_cond_stream_status",
                         [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    st = ctypes.c_int(-1)
    fn(stream.cuda_stream, ctypes.byref(st))
    return {0: "idle", 1: "capturing", 2: "invalidated"}.get(st.value,
                                                             "unknown")


def _raise(rc, what, parent, body):
    from .trace import ToStaticError
    if rc == -1:
        raise ToStaticError(f"{what}: the stream is not capturing")
    step, err = divmod(rc, 10000)
    raise ToStaticError(
        f"{what}: {_STEPS.get(step, 'a CUDA call')} failed with CUDA "
        f"error {err} (the step's stream {_status(parent)}, the body's "
        f"stream {_status(body)}, nesting depth {_depth[0]})")


def _own_stream(device, key):
    """A CUDA stream made for ``key`` alone (not one of torch's pool,
    whose streams recur), with its cuBLAS workspace made on it; outside
    any capture."""
    s = _streams.get(key)
    if s is None:
        from ..ops import _build
        make = _build.function("graph_cond", "graph_cond_stream_create",
                               [ctypes.POINTER(ctypes.c_void_p)])
        ptr = ctypes.c_void_p()
        rc = make(ctypes.byref(ptr))
        if rc != 0:
            raise RuntimeError(f"cudaStreamCreateWithFlags failed: {rc}")
        s = _streams[key] = torch.cuda.ExternalStream(ptr.value,
                                                      device=device)
        with torch.cuda.stream(s):
            a = torch.ones(8, 8, device=device)
            (a @ a).sum()
        s.synchronize()
    return s


def body_stream(device):
    """The stream a body at the current nesting depth is captured on."""
    return _own_stream(device, (device.index, _depth[0]))


def warm_stream(device):
    """The stream static.nn's thrown-away warm-up captures run on."""
    return _own_stream(device, (device.index, "warm"))


_WARM_DEPTHS = 4   # nested conditionals a capture can hold
_CUDA_NEEDED = 12040   # conditional nodes came with CUDA 12.4
_versions = {}


def _check_versions():
    """The CUDA runtime and driver must both be 12.4 or later."""
    if not _versions:
        from ..ops import _build
        fn = _build.function("graph_cond", "graph_cond_versions",
                             [ctypes.POINTER(ctypes.c_int)] * 2)
        runtime, driver = ctypes.c_int(0), ctypes.c_int(0)
        rc = fn(ctypes.byref(runtime), ctypes.byref(driver))
        if rc != 0:
            raise RuntimeError(f"reading the CUDA versions failed: {rc}")
        _versions.update(runtime=runtime.value, driver=driver.value)
    old = {k: v for k, v in _versions.items() if v < _CUDA_NEEDED}
    if old:
        from .trace import ToStaticError
        said = ", ".join(f"{k} {v // 1000}.{v % 1000 // 10}"
                         for k, v in old.items())
        raise ToStaticError(
            "a Tensor if/while under capture needs CUDA graph conditional "
            f"nodes (CUDA 12.4 or later); this card has CUDA {said}")


def warm(device):
    """Check the CUDA versions, make the body streams (for
    ``_WARM_DEPTHS`` levels of nesting) and build the helper: called
    outside any capture (by ``static.nn`` in ``to_static``'s record
    call), since neither can happen inside one."""
    _check_versions()
    for depth in range(_WARM_DEPTHS):
        _own_stream(device, (device.index, depth))
    warm_stream(device)


@contextlib.contextmanager
def node(flag, kind, pool, end_flag=None):
    """Capture the block into a conditional node on ``flag`` (a 0-d bool
    CUDA tensor): ``kind`` "if" runs the body when it is set, "while"
    as long as it is; for a while, ``end_flag()`` (called at the end of
    the body) gives the tensor whose value the condition takes after
    each trip. Allocations inside go to ``pool``."""
    begin, end = _lib()
    k = 1 if kind == "while" else 0
    dev = flag.device
    stream = body_stream(dev)
    parent = torch.cuda.current_stream(dev)
    handle = ctypes.c_ulonglong()
    rc = begin(parent.cuda_stream, stream.cuda_stream, flag.data_ptr(), k,
               ctypes.byref(handle))
    if rc != 0:
        _raise(rc, f"a Tensor {kind} under capture", parent, stream)
    # the outermost node routes every allocation to the pool until it
    # ends (a nested one inherits the routing: a pool takes one)
    route = _depth[0] == 0
    if route:
        torch._C._cuda_beginAllocateToPool(dev.index, pool)
    _depth[0] += 1
    last = flag
    counted, before = _launches()
    try:
        with torch.cuda.stream(stream):
            yield
            if end_flag is not None:
                last = end_flag()
            _count_in_body(counted, before)
    finally:
        _depth[0] -= 1
        if route:
            torch._C._cuda_endAllocateToPool(dev.index, pool)
        rc = end(stream.cuda_stream, last.data_ptr(), k, handle.value)
    if rc != 0:
        _raise(rc, f"a Tensor {kind} under capture", parent, stream)


def _launches():
    """The counted kernel wrappers and their counts now."""
    from ..jit.to_static import _counted
    counted = _counted()
    return counted, [w.launches for w in counted]


def _count_in_body(counted, before):
    """Take the launches the body captured (a nested node has taken its
    own) off the host counters, and capture into the body the adds that
    put them on the capture's counter on the card."""
    from . import trace
    ctx = trace._active
    for i, (w, b) in enumerate(zip(counted, before)):
        n = w.launches - b
        if n:
            w.launches = b
            ctx.cond_launches[i].add_(n)
            ctx.cond_counted = True
