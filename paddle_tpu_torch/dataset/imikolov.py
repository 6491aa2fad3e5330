"""A port of ``paddle_tpu/dataset/imikolov.py``.

Reference: dataset/imikolov.py — build_dict() + train/test(word_idx,
n) reader creators yielding n-gram tuples (or (src, trg) in SEQ
mode)."""
import numpy as np

__all__ = []


class DataType:
    NGRAM = 1
    SEQ = 2


def build_dict(min_word_freq=50):
    from ..text.datasets import Imikolov
    return dict(Imikolov(mode="train",
                         min_word_freq=min_word_freq).word_idx)


def _reader(mode, word_idx, n, data_type):
    from ..text.datasets import Imikolov
    dtype = "NGRAM" if data_type == DataType.NGRAM else "SEQ"
    ds = Imikolov(data_type=dtype, window_size=n, mode=mode)
    # keep ids valid indices into the caller's dict (they size their
    # embedding table by it)
    n_vocab = max(1, len(word_idx)) if word_idx else None

    def clamp(i):
        i = int(i)
        return i % n_vocab if n_vocab is not None else i

    def reader():
        for sample in ds:
            if dtype == "NGRAM":
                yield tuple(clamp(np.asarray(s).reshape(-1)[0])
                            for s in sample)
            else:
                src, trg = sample
                yield ([clamp(i) for i in np.asarray(src).reshape(-1)],
                       [clamp(i) for i in np.asarray(trg).reshape(-1)])

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return _reader("train", word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _reader("test", word_idx, n, data_type)


def fetch():
    pass
