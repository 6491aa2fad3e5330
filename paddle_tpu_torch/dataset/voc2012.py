"""A port of ``paddle_tpu/dataset/voc2012.py``.

Reference: dataset/voc2012.py — train/test/val readers yielding
(image, segmentation label) arrays."""
import numpy as np

__all__ = []


def _reader(mode):
    from ..vision.datasets import VOC2012
    ds = VOC2012(mode=mode)  # once per creator

    def reader():
        for img, label in ds:
            yield np.asarray(img), np.asarray(label)

    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")


def val():
    return _reader("valid")


def fetch():
    pass
