"""``paddle.utils`` (a port of ``paddle_tpu/utils/__init__.py``):
``download``'s local data directories, ``unique_name``,
``cpp_extension`` (host C++ ops), and ``try_import``, ``run_check``,
``deprecated`` and ``require_version``."""
from . import download  # noqa: F401
from . import unique_name  # noqa: F401


def try_import(name):
    import importlib
    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(f"optional dependency {name} is unavailable") from e


def run_check():
    """``paddle.utils.run_check``: a matmul on the card, checked against
    the CPU's; prints the card's name. Raises without CUDA."""
    import torch
    from ..core.device import resolve_device
    dev = resolve_device("cuda")
    x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    y = (x.to(dev) @ x.to(dev)).cpu()
    if not torch.equal(y, x @ x):
        raise RuntimeError(f"matmul on {dev} gave {y.tolist()}")
    print(f"paddle_tpu_torch runs on {torch.cuda.get_device_name(dev)} "
          f"({torch.cuda.device_count()} device(s)). All checks passed.")


def deprecated(since=None, update_to=None, reason=None):
    def deco(fn):
        return fn
    return deco


def require_version(min_version, max_version=None):
    """``paddle.utils.require_version``: a version gate against this
    package's ``__version__``."""
    from .. import __version__

    def parse(v):
        return tuple(int(x) for x in str(v).split(".")[:3] if x.isdigit())

    cur = parse(__version__)
    if parse(min_version) > cur:
        raise Exception(
            f"installed version {__version__} < required {min_version}")
    if max_version is not None and parse(max_version) < cur:
        raise Exception(
            f"installed version {__version__} > allowed {max_version}")
