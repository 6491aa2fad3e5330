"""A port of ``paddle_tpu/dataset/flowers.py``.

Reference: dataset/flowers.py — train/test/valid reader creators
yielding (CHW float32 image, int label)."""
import numpy as np

__all__ = []


def _reader(mode, cycle=False, mapper=None):
    from ..vision.datasets import Flowers
    ds = Flowers(mode=mode)  # once per creator

    def reader():
        while True:
            for img, label in ds:
                sample = (np.asarray(img, "float32"),
                          int(np.asarray(label).reshape(-1)[0]))
                if mapper is not None:
                    sample = mapper(sample)
                yield sample
            if not cycle:
                break

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader("train", cycle, mapper)


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader("test", cycle, mapper)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader("valid", mapper=mapper)


def fetch():
    pass
