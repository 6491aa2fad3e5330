"""paddle_tpu_torch's ``device`` against ``tests/test_memory_stats.py``:
the cases with a CPU meaning run here (live tensor bytes, the tracker,
the cuda namespace's memory queries returning 0 without a card), the
card-only ones (``program_memory_analysis``, which captures a function
as a CUDA graph; the allocator's statistics) are marked ``cuda``. Also
the names the reference binds (device kinds, cuDNN's version, streams
and events as tokens without a card). The file imports no JAX at the
top, so the card runs it with ``--noconftest -m cuda``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.device import (
    live_array_bytes, memory_tracker, program_memory_analysis)

cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA device")


class TestLiveArrayBytes:
    def test_counts_new_allocations(self):
        base = live_array_bytes()
        keep = torch.ones((256, 256), dtype=torch.float32) + 0   # 256 KiB
        grown = live_array_bytes()
        assert grown >= base + 256 * 1024, (base, grown)
        del keep

    def test_a_storage_counts_once(self):
        keep = torch.zeros(64, 64) + 1
        views = [keep[:8], keep.t(),
                 paddle.to_tensor(np.ones(3), place=paddle.CPUPlace())]
        base = live_array_bytes("cpu")
        more = [keep[8:], keep.reshape(-1)]     # views: no new storage
        assert live_array_bytes("cpu") == base
        del views, more, keep

    def test_per_device_filter(self):
        keep = torch.ones((128, 128), dtype=torch.float32)
        assert live_array_bytes("cpu") >= 128 * 128 * 4
        # 'cpu' / 'cpu:0' / a CPUPlace / a torch device name the same
        assert live_array_bytes("cpu:0") == live_array_bytes(
            torch.device("cpu")) == live_array_bytes(paddle.CPUPlace())
        del keep
        with pytest.raises(ValueError):
            live_array_bytes("tpu:0")


class TestMemoryTracker:
    def test_tracks_peak_and_delta(self):
        with memory_tracker("cpu") as mt:
            big = torch.zeros((512, 512), dtype=torch.float32) + 1
            mid = mt.sample()
            del big
        assert mid >= 512 * 512 * 4
        assert mt.peak_bytes >= mid
        assert mt.end_bytes <= mt.peak_bytes
        assert mt.delta_bytes == mt.end_bytes - mt.start_bytes


class TestCudaShimForwards:
    def test_cuda_namespace_memory_queries_do_not_raise(self):
        assert paddle.device.cuda.memory_allocated() >= 0
        assert paddle.device.cuda.max_memory_allocated() >= 0
        assert paddle.device.cuda.memory_reserved() >= 0
        assert paddle.device.cuda.max_memory_reserved() >= 0
        paddle.device.cuda.empty_cache()
        paddle.device.synchronize()
        if not torch.cuda.is_available():
            assert paddle.device.memory_stats() == {}
            assert paddle.device.max_memory_allocated() == 0
            import paddle_tpu as ref   # not on the card, which has no JAX
            assert ref.device.cuda.memory_allocated() == \
                paddle.device.cuda.memory_allocated() == 0

    def test_streams_events_and_names(self):
        s = paddle.device.cuda.Stream()
        e = s.record_event()
        assert e.query() and s.query()
        s.wait_event(e)
        s.wait_stream(paddle.device.cuda.current_stream())
        e.synchronize()
        s.synchronize()
        assert paddle.device.cuda.device_count() == (
            torch.cuda.device_count() if torch.cuda.is_available() else 0)
        kinds = paddle.device.get_all_device_type()
        assert "cpu" in kinds and (("gpu" in kinds)
                                   == torch.cuda.is_available())
        assert paddle.device.get_available_device() == [
            f"gpu:{i}" for i in range(paddle.device_count())]
        assert paddle.get_cudnn_version() == paddle.device.get_cudnn_version()
        if not torch.cuda.is_available():
            assert paddle.get_cudnn_version() is None


class TestProgramMemoryAnalysis:
    def test_refused_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("the CPU's refusal")
        with pytest.raises(RuntimeError, match="CUDA device"):
            program_memory_analysis(lambda x: torch.tanh(x @ x).sum(),
                                    torch.ones(64, 64))

    @cuda
    @needs_card
    def test_reports_captured_footprint(self):
        def f(x):
            return torch.tanh(x @ x).sum()

        x = torch.ones((64, 64), dtype=torch.float32, device="cuda")
        ma = program_memory_analysis(f, x)
        assert ma["argument_bytes"] == 64 * 64 * 4
        assert ma["output_bytes"] == 4
        assert ma["total_bytes"] > 0 and ma["pool_bytes"] > 0
        assert program_memory_analysis(f, x) == ma   # deterministic

    @cuda
    @needs_card
    def test_accepts_a_to_static_function(self):
        f = paddle.jit.to_static(lambda x: x * 2)
        ma = program_memory_analysis(f, torch.ones((8,), device="cuda"))
        assert ma["argument_bytes"] == 32

    @cuda
    @needs_card
    def test_allocator_stats_on_the_card(self):
        keep = torch.empty(1 << 20, dtype=torch.uint8, device="cuda")
        st = paddle.device.memory_stats()
        assert st["bytes_in_use"] >= 1 << 20
        assert paddle.device.max_memory_allocated() >= \
            paddle.device.memory_allocated() >= 1 << 20
        assert paddle.device.live_array_bytes(0) >= 1 << 20
        del keep
