"""A port of ``paddle_tpu/dataset/uci_housing.py``.

Reference: dataset/uci_housing.py — train/test readers yielding
(13-dim float32 features, 1-dim target)."""
import numpy as np

__all__ = []


def _reader(mode):
    from ..text.datasets import UCIHousing
    ds = UCIHousing(mode=mode)  # once per creator

    def reader():
        for feat, price in ds:
            yield (np.asarray(feat, "float32"),
                   np.asarray(price, "float32").reshape(-1))

    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")


def fetch():
    pass
