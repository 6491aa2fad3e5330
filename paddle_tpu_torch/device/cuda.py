"""``paddle.device.cuda`` (a port of ``paddle_tpu/device/cuda.py``;
reference python/paddle/device/cuda/__init__.py: Stream, Event,
current_stream, synchronize). On the card a ``Stream`` and an ``Event``
are torch's; without one they are tokens whose waits return at once, as
the reference's shims are, so the names stay importable."""
import torch


def _index(device):
    if device is None:
        return None
    if isinstance(device, int):
        return device
    if isinstance(device, torch.device):
        return device.index
    if hasattr(device, "device_id"):
        return device.device_id
    _, _, idx = str(device).partition(":")
    return int(idx) if idx else 0


class Stream:
    """A CUDA stream (reference core.CUDAStream). ``priority`` 1 is
    high, 2 normal, as Paddle's."""

    def __init__(self, device=None, priority=2, _stream=None):
        self.device = device
        if _stream is None and torch.cuda.is_available():
            _stream = torch.cuda.Stream(device=_index(device),
                                        priority=-1 if priority == 1 else 0)
        self.cuda_stream = _stream

    def synchronize(self):
        if self.cuda_stream is not None:
            self.cuda_stream.synchronize()

    def query(self):
        return True if self.cuda_stream is None else self.cuda_stream.query()

    def wait_event(self, event):
        if self.cuda_stream is not None and event.cuda_event is not None:
            self.cuda_stream.wait_event(event.cuda_event)

    def wait_stream(self, stream):
        if self.cuda_stream is not None and stream.cuda_stream is not None:
            self.cuda_stream.wait_stream(stream.cuda_stream)

    def record_event(self, event=None):
        ev = event or Event()
        ev.record(self)
        return ev


class Event:
    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False):
        self.cuda_event = torch.cuda.Event(
            enable_timing=enable_timing, blocking=blocking,
            interprocess=interprocess) if torch.cuda.is_available() else None

    def record(self, stream=None):
        if self.cuda_event is not None:
            s = stream.cuda_stream if stream is not None else None
            self.cuda_event.record(s)

    def query(self):
        return True if self.cuda_event is None else self.cuda_event.query()

    def synchronize(self):
        if self.cuda_event is not None:
            self.cuda_event.synchronize()

    def elapsed_time(self, end_event):
        return self.cuda_event.elapsed_time(end_event.cuda_event)


def current_stream(device=None):
    if not torch.cuda.is_available():
        return Stream()
    return Stream(device, _stream=torch.cuda.current_stream(_index(device)))


def synchronize(device=None):
    if torch.cuda.is_available():
        torch.cuda.synchronize(_index(device))


def device_count():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0
