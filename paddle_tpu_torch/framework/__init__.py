"""Framework utilities of the port (reference
``paddle_tpu/framework/__init__.py``): ``save``/``load``, the seed and
the core types."""
from . import io_utils  # noqa: F401
from ..core.rng import seed  # noqa: F401
from ..core.tensor import Parameter, Tensor  # noqa: F401
from .io_utils import load, save  # noqa: F401
