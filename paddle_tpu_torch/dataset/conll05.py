"""A port of ``paddle_tpu/dataset/conll05.py``.

Reference: dataset/conll05.py — SRL test reader + dict/embedding
queries."""
import numpy as np

__all__ = []


_ds_cache = []


def _ds():
    if not _ds_cache:
        from ..text.datasets import Conll05st
        _ds_cache.append(Conll05st())
    return _ds_cache[0]


def get_dict():
    ds = _ds()
    return ds.word_dict, ds.predicate_dict, ds.label_dict


def get_embedding():
    """Reference returns the downloaded emb file's contents; offline we
    derive a deterministic embedding table sized to the word dict."""
    word_dict = _ds().word_dict
    rng = np.random.RandomState(0)
    return rng.randn(len(word_dict), 32).astype("float32")


def test():
    def reader():
        for sample in _ds():
            yield tuple(np.asarray(f).reshape(-1) for f in sample)

    return reader


def fetch():
    pass
