"""``paddle.hapi`` of the port: ``Model``, ``summary``/``flops`` and the
callbacks."""
from .model import Model  # noqa: F401
from .summary import flops, summary  # noqa: F401
from . import callbacks  # noqa: F401
