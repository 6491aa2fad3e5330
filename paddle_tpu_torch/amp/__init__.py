"""Automatic mixed precision (reference ``paddle_tpu/amp``): ``auto_cast``
with the reference's op lists and levels, ``decorate`` and the dynamic
``GradScaler``."""
from . import auto_cast as _auto_cast_mod
from .auto_cast import amp_enabled, amp_guard, auto_cast
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_guard", "amp_enabled", "GradScaler",
           "AmpScaler", "decorate"]


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``: at O2 cast every parameter of the models
    to ``dtype`` in place (reference ``amp/__init__.py:8-25``); other
    levels change nothing. Returns ``models`` or ``(models,
    optimizers)``."""
    if level == "O2":
        low = _auto_cast_mod._DTYPES[dtype]
        for m in models if isinstance(models, (list, tuple)) else [models]:
            for p in m.parameters():
                p.data = p.data.to(low)
    if optimizers is None:
        return models
    return models, optimizers
