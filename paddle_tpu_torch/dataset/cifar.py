"""A port of ``paddle_tpu/dataset/cifar.py``.

Reference: dataset/cifar.py — train10/test10/train100/test100 reader
creators yielding (flat-3072 float32 image in [0, 1], int label)."""
import numpy as np

__all__ = []


def _reader(cls_name, mode, cycle=False):
    from ..vision import datasets as vds
    ds = getattr(vds, cls_name)(mode=mode)  # once per creator

    def reader():
        while True:
            for img, label in ds:
                flat = np.asarray(img, "float32").reshape(-1)
                yield flat, int(np.asarray(label).reshape(-1)[0])
            if not cycle:
                break

    return reader


def train10(cycle=False):
    return _reader("Cifar10", "train", cycle)


def test10(cycle=False):
    return _reader("Cifar10", "test", cycle)


def train100():
    return _reader("Cifar100", "train")


def test100():
    return _reader("Cifar100", "test")


def fetch():
    pass
