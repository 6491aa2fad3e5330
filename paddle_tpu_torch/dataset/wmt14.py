"""A port of ``paddle_tpu/dataset/wmt14.py``.

Reference: dataset/wmt14.py — train/test(dict_size) reader creators
yielding (src_ids, trg_ids, trg_next_ids)."""
import numpy as np

__all__ = []


def _reader(mode, dict_size):
    from ..text.datasets import WMT14
    ds = WMT14(mode=mode, dict_size=dict_size)  # once per creator

    def reader():
        for sample in ds:
            yield tuple(list(np.asarray(f).reshape(-1)) for f in sample)

    return reader


def train(dict_size):
    return _reader("train", dict_size)


def test(dict_size):
    return _reader("test", dict_size)


def get_dict(dict_size, reverse=True):
    from ..text.datasets import WMT14
    ds = WMT14(mode="train", dict_size=dict_size)
    return (ds.get_dict("en", reverse=reverse),
            ds.get_dict("fr", reverse=reverse))


def fetch():
    pass
