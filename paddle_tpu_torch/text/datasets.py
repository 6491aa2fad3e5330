"""``paddle.text.datasets`` of the port (a port of
``paddle_tpu/text/datasets.py``): ``Imdb``, ``Imikolov``, ``Movielens``,
``UCIHousing``, ``Conll05st``, ``WMT14`` and ``WMT16``.

Offline, as the reference's: ``UCIHousing`` loads its file under
``DATA_HOME`` where one exists; every other class (and ``UCIHousing``
without its file) builds the reference's seeded synthetic corpus, sample
for sample the same numpy arrays (``numpy.random.RandomState`` draws in
the same order), with the same structure as the real datasets' samples.
"""
import os

import numpy as np

from ..io.dataset import Dataset
from ..utils.download import DATA_HOME


def _rng(seed):
    return np.random.RandomState(seed)


class Imdb(Dataset):
    """Sentiment pairs (ids, label) (reference: datasets/imdb.py)."""

    def __init__(self, data_file=None, mode="train", cutoff=150):
        r = _rng(10 if mode == "train" else 11)
        n = 512
        self.word_idx = {f"w{i}": i for i in range(cutoff)}
        lens = r.randint(5, 64, n)
        self.docs = [r.randint(0, cutoff, l).astype("int64") for l in lens]
        self.labels = r.randint(0, 2, n).astype("int64")

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB-style n-gram tuples (reference: datasets/imikolov.py)."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50):
        r = _rng(12 if mode == "train" else 13)
        vocab = 2000
        self.word_idx = {f"w{i}": i for i in range(vocab)}
        n = 1024
        if data_type.upper() == "NGRAM":
            self.data = [tuple(r.randint(0, vocab, window_size))
                         for _ in range(n)]
        else:  # SEQ
            self.data = [(r.randint(0, vocab, 10).astype("int64"),
                          r.randint(0, vocab, 10).astype("int64"))
                         for _ in range(n)]

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class Movielens(Dataset):
    """(user_id, gender, age, job, movie_id, title_ids, categories,
    rating) tuples (reference: datasets/movielens.py)."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0):
        r = _rng(rand_seed + (0 if mode == "train" else 1))
        n = 512
        self.data = [(
            np.array([r.randint(1, 6041)], "int64"),      # user id
            np.array([r.randint(0, 2)], "int64"),         # gender
            np.array([r.randint(0, 7)], "int64"),         # age bucket
            np.array([r.randint(0, 21)], "int64"),        # job
            np.array([r.randint(1, 3953)], "int64"),      # movie id
            r.randint(0, 5000, 4).astype("int64"),        # title word ids
            r.randint(0, 19, 3).astype("int64"),          # category ids
            np.array([float(r.randint(1, 6))], "float32"),  # rating
        ) for _ in range(n)]

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class UCIHousing(Dataset):
    """13-feature housing rows (reference: datasets/uci_housing.py);
    loads the real space-separated file from DATA_HOME when present."""

    def __init__(self, data_file=None, mode="train"):
        data_file = data_file or os.path.join(DATA_HOME, "uci_housing",
                                              "housing.data")
        if os.path.exists(data_file):
            raw = np.loadtxt(data_file).astype("float32")
        else:
            r = _rng(20)
            feats = r.standard_normal((506, 13)).astype("float32")
            prices = (feats @ r.standard_normal((13, 1)) + 22.5)
            raw = np.concatenate([feats, prices.astype("float32")], axis=1)
        # reference normalizes features then splits 80/20
        feats, target = raw[:, :-1], raw[:, -1:]
        feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-8)
        split = int(len(raw) * 0.8)
        if mode == "train":
            self.data = np.concatenate([feats[:split], target[:split]], 1)
        else:
            self.data = np.concatenate([feats[split:], target[split:]], 1)

    def __getitem__(self, idx):
        row = self.data[idx]
        return row[:-1].astype("float32"), row[-1:].astype("float32")

    def __len__(self):
        return len(self.data)


class Conll05st(Dataset):
    """SRL tuples: (word_ids, ctx_n2..ctx_p2, verb, mark, label seq)
    (reference: datasets/conll05.py)."""

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, mode="train"):
        r = _rng(30)
        vocab, labels, n = 5000, 67, 256
        self.word_dict = {f"w{i}": i for i in range(vocab)}
        self.label_dict = {f"l{i}": i for i in range(labels)}
        self.predicate_dict = {f"v{i}": i for i in range(3000)}
        self.data = []
        for _ in range(n):
            ln = int(r.randint(4, 32))
            words = r.randint(0, vocab, ln).astype("int64")
            sample = [words]
            for _ in range(5):  # ctx windows
                sample.append(r.randint(0, vocab, ln).astype("int64"))
            sample.append(r.randint(0, 3000, ln).astype("int64"))  # verb
            sample.append(r.randint(0, 2, ln).astype("int64"))     # mark
            sample.append(r.randint(0, labels, ln).astype("int64"))
            self.data.append(tuple(sample))

    def get_dict(self):
        return self.word_dict, self.predicate_dict, self.label_dict

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class _WMTBase(Dataset):
    def __init__(self, seed, dict_size, mode="train", trg_dict_size=None):
        r = _rng(seed if mode == "train" else seed + 1)
        self._dict_size = dict_size
        trg_size = trg_dict_size or dict_size
        n = 256
        self.data = []
        for _ in range(n):
            sl, tl = int(r.randint(4, 24)), int(r.randint(4, 24))
            src = r.randint(0, dict_size, sl).astype("int64")
            trg = r.randint(0, trg_size, tl).astype("int64")
            trg_next = np.roll(trg, -1)
            self.data.append((src, trg, trg_next))

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class WMT14(_WMTBase):
    """Reference: datasets/wmt14.py (en→fr id triples)."""

    def __init__(self, data_file=None, mode="train", dict_size=30000):
        super().__init__(40, dict_size, mode)

    def get_dict(self, lang="en", reverse=False):
        d = {f"{lang}{i}": i for i in range(self._dict_size)}
        return {v: k for k, v in d.items()} if reverse else d


class WMT16(_WMTBase):
    """Reference: datasets/wmt16.py (en↔de, trg_next shifted)."""

    def __init__(self, data_file=None, mode="train", src_dict_size=30000,
                 trg_dict_size=30000, lang="en"):
        super().__init__(50, src_dict_size, mode, trg_dict_size)
        self._trg_dict_size = trg_dict_size

    def get_dict(self, lang="en", reverse=False):
        size = self._dict_size if lang == "en" else self._trg_dict_size
        d = {f"{lang}{i}": i for i in range(size)}
        return {v: k for k, v in d.items()} if reverse else d
