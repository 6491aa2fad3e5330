"""A port of ``paddle_tpu/dataset/imdb.py``.

Reference: dataset/imdb.py — word_dict() + train/test(word_idx)
reader creators yielding (word-id sequence, 0/1 label)."""
import numpy as np

__all__ = []


def word_dict():
    from ..text.datasets import Imdb
    return dict(Imdb(mode="train").word_idx)


def _reader(mode, word_idx):
    from ..text.datasets import Imdb
    ds = Imdb(mode=mode)  # once per creator
    # the caller sizes their embedding table by THEIR dict: keep every
    # yielded id a valid index into it
    n_vocab = max(1, len(word_idx)) if word_idx else None

    def reader():
        for doc, label in ds:
            ids = [int(i) for i in np.asarray(doc).reshape(-1)]
            if n_vocab is not None:
                ids = [i % n_vocab for i in ids]
            yield ids, int(np.asarray(label).reshape(-1)[0])

    return reader


def train(word_idx):
    return _reader("train", word_idx)


def test(word_idx):
    return _reader("test", word_idx)


def fetch():
    pass
