"""paddle_tpu_torch's ``core.native`` (ctypes bindings over the same
``runtime_cpp/runtime.cc``) against the JAX package's on the CPU:
``tests/test_native_runtime.py``'s 7 cases (the blocking queue's round
trip, producer/consumer and blocking at capacity; the arena's reuse and
stats; the trace dump; the MultiSlot parser, plain and threaded), each
result held to the reference's bindings where they are built; then the
port's own build (into ``paddle_tpu_torch/_build/``, never
``runtime_cpp/build/``) and ``available()`` False when the build fails.

Every comparison is exact.
"""
import json
import threading

import numpy as np
import pytest

from paddle_tpu.core import native as ref_native
from paddle_tpu_torch.core import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ compiler to build the runtime")


def _ref_or_none(fn):
    """``fn(ref_native)`` where the reference's runtime is built, else
    None (its own tests skip then too)."""
    return fn(ref_native) if ref_native.available() else None


def _roundtrip(N):
    q = N.NativeBlockingQueue(capacity=4)
    arr = np.arange(10, dtype=np.float32)
    q.put_array(arr)
    return np.frombuffer(q.get_bytes(), np.float32)


def test_blocking_queue_roundtrip():
    out = _roundtrip(native)
    np.testing.assert_array_equal(out, np.arange(10, dtype=np.float32))
    want = _ref_or_none(_roundtrip)
    if want is not None:
        np.testing.assert_array_equal(out, want)


def test_blocking_queue_producer_consumer():
    q = native.NativeBlockingQueue(capacity=2)
    results = []

    def producer():
        for i in range(20):
            q.put_bytes(bytes([i]))
        q.close()

    def consumer():
        while True:
            b = q.get_bytes()
            if b is None:
                break
            results.append(b[0])

    tp = threading.Thread(target=producer)
    tc = threading.Thread(target=consumer)
    tp.start()
    tc.start()
    tp.join()
    tc.join()
    assert results == list(range(20))
    assert q.qsize() == 0


def test_queue_blocks_at_capacity():
    q = native.NativeBlockingQueue(capacity=1)
    q.put_bytes(b"a")
    done = []

    def blocked_put():
        q.put_bytes(b"b")
        done.append(1)

    th = threading.Thread(target=blocked_put)
    th.start()
    th.join(timeout=0.2)
    assert not done  # still blocked (queue full)
    assert q.get_bytes() == b"a"
    th.join(timeout=2)
    assert done
    q.close()
    with pytest.raises(RuntimeError, match="closed"):
        q.put_bytes(b"c")


def _arena(N):
    a = N.NativeArena()
    buf, rel = a.buffer(1000)
    assert buf.shape == (1000,)
    buf[:] = 7
    rel()
    buf2, rel2 = a.buffer(900)  # same size class (1024) -> cache hit
    stats = a.stats()
    rel2()
    return stats


def test_arena_reuse_and_stats():
    stats = _arena(native)
    assert stats["alloc_calls"] == 2
    assert stats["cache_hits"] == 1
    want = _ref_or_none(_arena)
    if want is not None:
        assert stats == want


def test_trace_dump(tmp_path):
    tr = native.NativeTrace()
    t0 = tr.now_us()
    tr.record("step", t0, 100, tid=1)
    tr.record("h2d", t0 + 50, 20, tid=2)
    path = str(tmp_path / "trace.json")
    assert tr.dump(path) == 2
    with open(path) as f:
        data = json.load(f)
    assert len(data["traceEvents"]) == 2
    assert data["traceEvents"][0]["name"] == "step"
    assert [e["dur"] for e in data["traceEvents"]] == [100, 20]


@pytest.mark.parametrize("threaded", [False, True])
def test_multislot_parser(threaded):
    if not threaded:
        text, slots, threads = "1 0.5 3 1 2 3\n1 1.5 2 7 8\n", 2, 2
    else:
        rng = np.random.RandomState(0)
        lines, expect = [], []
        for _ in range(257):
            n = rng.randint(1, 5)
            vals = rng.randint(0, 100, n)
            expect.append(vals)
            lines.append(f"{n} " + " ".join(map(str, vals)))
        text, slots, threads = "\n".join(lines), 1, 4
    got = native.parse_multislot(text, num_slots=slots, num_threads=threads)
    if not threaded:
        (vals0, offs0), (vals1, offs1) = got
        np.testing.assert_allclose(vals0, [0.5, 1.5])
        np.testing.assert_array_equal(offs0, [0, 1, 2])
        np.testing.assert_allclose(vals1, [1, 2, 3, 7, 8])
        np.testing.assert_array_equal(offs1, [0, 3, 5])
    else:
        (vals, offs), = got
        for i, e in enumerate(expect):
            np.testing.assert_allclose(vals[offs[i]:offs[i + 1]], e)
    want = _ref_or_none(lambda N: N.parse_multislot(
        text, num_slots=slots, num_threads=threads))
    if want is not None:
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_builds_into_its_own_directory():
    path = native.library_path()
    assert "/paddle_tpu_torch/_build/" in path.replace("\\", "/")
    assert path.endswith(".so")
    import os
    assert os.path.exists(path)


def test_failed_build_is_not_available(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "b"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native.available() is False
    with pytest.raises(RuntimeError, match="build failed"):
        native.NativeArena()
