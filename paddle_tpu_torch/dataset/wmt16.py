"""A port of ``paddle_tpu/dataset/wmt16.py``.

Reference: dataset/wmt16.py — train/test/validation(src_dict_size,
trg_dict_size, src_lang) reader creators + get_dict."""
import numpy as np

__all__ = []


def _reader(mode, src_dict_size, trg_dict_size, src_lang):
    from ..text.datasets import WMT16
    ds = WMT16(mode=mode, src_dict_size=src_dict_size,
               trg_dict_size=trg_dict_size, lang=src_lang)

    def reader():
        for sample in ds:
            yield tuple(list(np.asarray(f).reshape(-1)) for f in sample)

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader("train", src_dict_size, trg_dict_size, src_lang)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader("test", src_dict_size, trg_dict_size, src_lang)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader("val", src_dict_size, trg_dict_size, src_lang)


def get_dict(lang, dict_size, reverse=False):
    from ..text.datasets import WMT16
    ds = WMT16(mode="train", src_dict_size=dict_size,
               trg_dict_size=dict_size)
    return ds.get_dict(lang, reverse=reverse)


def fetch():
    pass
