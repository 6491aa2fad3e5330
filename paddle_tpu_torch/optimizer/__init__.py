"""Optimizers and learning-rate schedules of the port (reference
``paddle_tpu/optimizer``): ``Adam``, ``AdamW`` and every scheduler of
``lr``. The other optimizers of the reference are not ported yet."""
from . import lr
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["lr", "Optimizer", "Adam", "AdamW"]
