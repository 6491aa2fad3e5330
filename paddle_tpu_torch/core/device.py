"""Device and Place (a port of ``paddle_tpu/core/device.py``), and the
device resolution of the port's entry points.

``resolve_device(None)`` is the current device: the card (``cuda``)
unless ``set_device`` says otherwise. Without CUDA it raises; the port
never carries on quietly on the CPU. A ``Place`` names a device Paddle's
way (``Place(cpu)``, ``Place(gpu:0)``); ``set_device("gpu")`` and
``set_device("cpu")`` switch the current device, and the reference's
accelerator names (``"tpu"``, ``"xpu"``, ...) map to the card as its
``"gpu"`` maps to its accelerator.
"""
import torch


class Place:
    """Device identity, paddle-style."""

    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type, device_id=0):
        self.device_type = device_type
        self.device_id = device_id

    def __repr__(self):
        if self.device_type == "cpu":
            return "Place(cpu)"
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def is_cpu_place(self):
        return self.device_type == "cpu"

    def is_gpu_place(self):
        return self.device_type == "gpu"

    def is_cuda_pinned_place(self):
        return False

    def torch_device(self):
        """The ``torch.device`` of this place."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)


class CPUPlace(Place):
    def __init__(self):
        super().__init__("cpu", 0)


class CUDAPlace(Place):
    def __init__(self, device_id=0):
        super().__init__("gpu", int(device_id))


class _AcceleratorPlace(CUDAPlace):
    """The reference's accelerator Places (``TPUPlace``, ``XPUPlace``,
    ``NPUPlace``, core/device.py:51,133,138) name the card here, as
    ``set_device("tpu")`` does. Where the reference's fall back to the
    CPU without an accelerator, these raise, as ``resolve_device``
    does."""

    def __init__(self, device_id=0):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__} names the CUDA device and none is "
                "available; use CPUPlace() for the CPU")
        super().__init__(device_id)


class TPUPlace(_AcceleratorPlace):
    pass


class XPUPlace(_AcceleratorPlace):
    pass


class NPUPlace(_AcceleratorPlace):
    pass


class CUDAPinnedPlace(Place):
    """Page-locked host memory: tensors live on the CPU."""

    def __init__(self):
        super().__init__("cpu", 0)

    def __repr__(self):
        return "Place(gpu_pinned)"

    def is_cuda_pinned_place(self):
        return True


def place_of(device):
    """The Place of a ``torch.device`` (or of a device string)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return CPUPlace()
    return CUDAPlace(torch.cuda.current_device() if dev.index is None
                     else dev.index)


_current_place = None   # None: the card


def set_device(device):
    """``paddle.device.set_device``: ``'cpu'``, ``'gpu'``, ``'gpu:N'``
    (also ``'cuda[:N]'`` and the reference's accelerator names). Returns
    the new current Place."""
    global _current_place
    dev = device.lower()
    if ":" in dev:
        kind, _, idx = dev.partition(":")
        idx = int(idx)
    else:
        kind, idx = dev, 0
    if kind == "cpu":
        _current_place = CPUPlace()
    elif kind in ("gpu", "cuda", "tpu", "xpu", "npu"):
        _current_place = CUDAPlace(idx)
    else:
        raise ValueError(f"unsupported device {device!r}")
    return _current_place


def get_place():
    """The current Place: the card's until ``set_device`` says
    otherwise."""
    if _current_place is not None:
        return _current_place
    return CUDAPlace(torch.cuda.current_device()
                     if torch.cuda.is_available() else 0)


def get_device():
    """``'cpu'`` or ``'gpu:N'``, Paddle's spelling of the current
    device."""
    p = get_place()
    return "cpu" if p.is_cpu_place() else f"gpu:{p.device_id}"


def resolve_device(device=None):
    """``None`` -> the current device (``cuda`` until ``set_device``
    says otherwise; raises when CUDA is absent); anything else goes
    through ``torch.device`` (a Place through its ``torch_device``) and
    a ``cuda`` request is checked."""
    if device is None:
        dev = _current_place.torch_device() if _current_place is not None \
            else torch.device("cuda")
    elif isinstance(device, Place):
        dev = device.torch_device()
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # name the card, so it compares equal to a tensor's device
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_count():
    """The number of cards (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def is_compiled_with_cuda():
    """True when the installed torch was built with CUDA (the card's
    build; a CPU-only torch answers False)."""
    return torch.version.cuda is not None


def is_compiled_with_tpu():
    return False


def is_compiled_with_xpu():
    return False


def is_compiled_with_npu():
    return False


def is_compiled_with_rocm():
    return False
