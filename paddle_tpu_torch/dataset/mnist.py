"""A port of ``paddle_tpu/dataset/mnist.py``.

Reference: dataset/mnist.py — reader creators yielding
(flat-784 float32 image scaled to [-1, 1], int label)."""
import numpy as np

__all__ = []


def _reader(mode):
    from ..vision.datasets import MNIST
    ds = MNIST(mode=mode)  # once per creator: reader() runs per epoch

    def reader():
        for img, label in ds:
            flat = np.asarray(img, "float32").reshape(-1)
            # contract: pixels in [-1, 1] (real data is [0,1]-normalized
            # so the clip is a no-op; the synthetic offline fallback is
            # unbounded gaussian and gets clamped into contract)
            flat = np.clip(flat * 2.0 - 1.0, -1.0, 1.0)
            yield flat, int(np.asarray(label).reshape(-1)[0])

    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")


def fetch():
    pass
