"""Regularizer objects (reference ``paddle_tpu/regularizer.py:10-25``).

An optimizer takes one as ``weight_decay``: ``L2Decay`` adds
``coeff * param`` to the grad inside the update, as a float
``weight_decay`` does; ``L1Decay`` adds ``coeff * sign(param)`` to the
clipped grad before the update (``optimizer.Optimizer.step``).
"""


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        self._mode = "l1"

    def __repr__(self):
        return f"L1Decay(coeff={self._coeff})"


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        self._mode = "l2"

    def __repr__(self):
        return f"L2Decay(coeff={self._coeff})"
