"""``paddle.device`` (a port of ``paddle_tpu/device/__init__.py``;
reference python/paddle/device/__init__.py).

The memory queries read torch's caching allocator on the card
(``torch.cuda.memory_stats`` and friends; 0 where there is no card, as
the reference's CPU backend reports nothing). ``live_array_bytes`` and
``memory_tracker`` count the bytes of the live torch tensors the
process can see (each storage once), on every device, the CPU too.

``program_memory_analysis(fn, *args)`` is XLA's compile-time memory
analysis in the reference; the port's counterpart captures ``fn`` once
as a CUDA graph into a private pool and reports that pool: the bytes
the card sets aside for one run of ``fn`` (temporaries and outputs),
deterministic for a fixed ``fn`` and shapes. It needs a CUDA device and
raises on the CPU, where there is no graph to capture.
"""
import gc

import torch

from ..core import trace as trace_mod
from ..core.device import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, NPUPlace, Place, TPUPlace,
    XPUPlace, device_count, get_device, get_place, is_compiled_with_cuda,
    is_compiled_with_npu, is_compiled_with_rocm, is_compiled_with_tpu,
    is_compiled_with_xpu, set_device)


def get_all_device_type():
    """The device kinds this process can run on: ``'cpu'``, and
    ``'gpu'`` where a card is present."""
    return sorted({"cpu"} | ({"gpu"} if torch.cuda.is_available() else set()))


def get_available_device():
    return [f"gpu:{i}" for i in range(device_count())]


def _resolve_device(device):
    """None | an int (a card's index) | ``'gpu:1'`` / ``'cuda:1'`` /
    ``'cpu'`` / ``'cpu:0'`` | a Place | a torch device -> a torch device,
    or None for every device."""
    if device is None:
        return None
    if isinstance(device, torch.device):
        return device
    if isinstance(device, Place):
        return device.torch_device()
    if isinstance(device, bool) or not isinstance(device, (int, str)):
        raise ValueError(f"unsupported device spec {device!r}")
    if isinstance(device, int):
        kind, idx = "gpu", device
    else:
        kind, _, idx = device.lower().partition(":")
        idx = int(idx) if idx else 0
    if kind == "cpu":
        return torch.device("cpu")
    if kind not in ("gpu", "cuda"):
        raise ValueError(f"unsupported device spec {device!r}")
    if not 0 <= idx < device_count():
        raise ValueError(f"device index {idx} out of range (have "
                         f"{device_count()} cards)")
    return torch.device("cuda", idx)


def _card(device):
    """The card ``device`` names (default the current one), or None when
    it names the CPU or there is no card."""
    dev = _resolve_device(device)
    if dev is None:
        return torch.cuda.current_device() if torch.cuda.is_available() \
            else None
    return dev if dev.type == "cuda" else None


def synchronize(device=None):
    card = _card(device)
    if card is not None:
        torch.cuda.synchronize(card)


def memory_stats(device=None):
    """torch's allocator statistics of the card (``device``: None for the
    current card, an index, ``'gpu:1'``, a Place), with the reference's
    keys beside them (``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_reserved``, ``peak_bytes_reserved``); an empty dict without a
    card."""
    card = _card(device)
    if card is None:
        return {}
    stats = dict(torch.cuda.memory_stats(card))
    stats["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
    stats["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
    stats["bytes_reserved"] = int(stats.get("reserved_bytes.all.current", 0))
    stats["peak_bytes_reserved"] = int(stats.get("reserved_bytes.all.peak",
                                                 0))
    return stats


def max_memory_allocated(device=None):
    return int(memory_stats(device).get("peak_bytes_in_use", 0))


def memory_allocated(device=None):
    return int(memory_stats(device).get("bytes_in_use", 0))


def max_memory_reserved(device=None):
    return int(memory_stats(device).get("peak_bytes_reserved", 0))


def memory_reserved(device=None):
    return int(memory_stats(device).get("bytes_reserved", 0))


def empty_cache():
    """Drop dead tensors (a collection) and hand the allocator's cached
    blocks back to the card (the reference's allocator Release():
    allocator_facade.cc)."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def live_array_bytes(device=None):
    """Bytes of the live torch tensors (each storage counted once),
    optionally on one device (same forms as ``memory_stats``; ``'cpu'``
    for the host). The live-buffers surface of the reference's memory
    stat getters (memory/stats.h DeviceMemoryStatCurrentValue), usable on
    the CPU, where there is no allocator to ask."""
    dev = _resolve_device(device)
    seen = set()
    total = 0
    for obj in gc.get_objects():
        # type(), not isinstance: a module proxy among the objects warns
        # when its __class__ is read
        if not issubclass(type(obj), torch.Tensor) or obj.is_meta:
            continue
        if dev is not None and (obj.device.type != dev.type or (
                dev.type == "cuda" and obj.device.index != dev.index)):
            continue
        try:
            st = obj.untyped_storage()
        except (RuntimeError, NotImplementedError):
            continue  # sparse and other storage-less layouts
        key = (str(obj.device), st.data_ptr())
        if key in seen:
            continue
        seen.add(key)
        total += st.nbytes()
    return total


class memory_tracker:
    """Context manager measuring live-tensor memory across a region:

        with paddle.device.memory_tracker() as mt:
            ...training step...
            mt.sample()          # optional mid-region samples
        mt.peak_bytes, mt.delta_bytes

    Peak is the max over enter/samples/exit (the reference's peak memory
    stats, memory/stats.h DeviceMemoryStatPeak)."""

    def __init__(self, device=None):
        self._device = device
        self.start_bytes = 0
        self.peak_bytes = 0
        self.end_bytes = 0

    def sample(self):
        b = live_array_bytes(self._device)
        self.peak_bytes = max(self.peak_bytes, b)
        return b

    def __enter__(self):
        self.start_bytes = self.sample()
        return self

    def __exit__(self, *exc):
        self.end_bytes = self.sample()
        return False

    @property
    def delta_bytes(self):
        return self.end_bytes - self.start_bytes


def _tensors(obj, out):
    from ..core.tensor import Tensor
    if isinstance(obj, Tensor):
        obj = obj.value
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tensors(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensors(o, out)
    return out


def program_memory_analysis(fn, *args, **kwargs):
    """The memory of one run of ``fn(*args, **kwargs)`` on the card,
    measured by capturing it once as a CUDA graph into a pool of its own
    (after one eager warm-up run): ``argument_bytes`` (the arguments'
    tensors), ``output_bytes`` (the outputs'), ``temp_bytes`` (the rest
    of the capture's peak allocation), ``pool_bytes`` (the pool's
    segments, what the card sets aside), ``generated_code_bytes`` and
    ``alias_bytes`` (0: no compiled code, no donation) and
    ``total_bytes``. Deterministic for a fixed ``fn`` and shapes. A
    ``to_static`` function is measured through its undecorated one."""
    inner = getattr(fn, "_fn", fn) if hasattr(fn, "graphs") else fn
    ins = _tensors((args, kwargs), [])
    if not any(t.is_cuda for t in ins) and not torch.cuda.is_available():
        raise RuntimeError(
            "program_memory_analysis measures one CUDA-graph capture of the "
            "function on the card; this process has no CUDA device (the "
            "reference's XLA compile-time analysis has no counterpart on "
            "the CPU)")
    stream = trace_mod.capture_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        inner(*args, **kwargs)           # warm-up: workspaces, lazy init
    torch.cuda.synchronize()
    pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        out = inner(*args, **kwargs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                     if tuple(seg.get("segment_pool_id", ())) == tuple(pool))
    outs = _tensors(out, [])
    result = {
        "argument_bytes": sum(t.untyped_storage().nbytes() for t in ins),
        "output_bytes": sum(t.untyped_storage().nbytes() for t in outs),
        "generated_code_bytes": 0,
        "alias_bytes": 0,
        "pool_bytes": int(pool_bytes),
    }
    result["temp_bytes"] = max(0, int(peak) - result["output_bytes"])
    result["total_bytes"] = (result["temp_bytes"] + result["argument_bytes"]
                             + result["output_bytes"])
    del out, outs, graph
    return result


def get_cudnn_version():
    """cuDNN's version as an int (torch.backends.cudnn.version()); None
    where torch has no cuDNN, as the reference returns when absent."""
    return torch.backends.cudnn.version() \
        if torch.backends.cudnn.is_available() else None


# paddle.device.cuda is a module (Stream / Event / current_stream /
# synchronize); the memory queries attach here too, so reference code
# reading them through the cuda namespace keeps working
from . import cuda as cuda  # noqa: E402

cuda.memory_allocated = memory_allocated
cuda.max_memory_allocated = max_memory_allocated
cuda.memory_reserved = memory_reserved
cuda.max_memory_reserved = max_memory_reserved
cuda.empty_cache = empty_cache
