"""Optimizers and learning-rate schedules of the port (reference
``paddle_tpu/optimizer``): every optimizer of the reference and every
scheduler of ``lr``."""
from . import lr
from .optimizer import Optimizer
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Ftrl,
                         Lamb, LarsMomentum, Momentum, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "RMSProp", "Lamb", "LarsMomentum", "Adadelta", "Ftrl"]
