"""A port of ``paddle_tpu/dataset/movielens.py``.

Reference: dataset/movielens.py — train/test readers + metadata
queries over the MovieLens 1M schema. Sample layout (modern Movielens
class): (user_id, gender, age, job, movie_id, title_ids, categories,
rating)."""
import collections

import numpy as np

__all__ = []

MovieInfo = collections.namedtuple("MovieInfo",
                                   ["index", "categories", "title"])
UserInfo = collections.namedtuple("UserInfo",
                                  ["index", "gender", "age", "job"])


_ds_cache = {}


def _ds(mode="train"):
    # metadata queries (max_*_id, movie_info, ...) are typically all
    # called during one model build — cache per mode like the
    # reference's __initialize_meta_info__ module global
    ds = _ds_cache.get(mode)
    if ds is None:
        from ..text.datasets import Movielens
        ds = _ds_cache[mode] = Movielens(mode=mode)
    return ds


def _reader(mode):
    def reader():
        for sample in _ds(mode):
            yield tuple(np.asarray(f).reshape(-1) for f in sample)

    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")


def _field_max(idx):
    return max(int(np.asarray(s[idx]).reshape(-1)[0])
               for s in _ds("train"))


def max_movie_id():
    return _field_max(4)


def max_user_id():
    return _field_max(0)


def max_job_id():
    return _field_max(3)


def get_movie_title_dict():
    """word -> index over every title word id in the data."""
    ids = set()
    for s in _ds("train"):
        ids.update(int(i) for i in np.asarray(s[5]).reshape(-1))
    return {f"w{i}": n for n, i in enumerate(sorted(ids))}


def movie_categories():
    """category name -> index over every category id in the data."""
    ids = set()
    for s in _ds("train"):
        ids.update(int(i) for i in np.asarray(s[6]).reshape(-1))
    return {f"c{i}": n for n, i in enumerate(sorted(ids))}


def user_info():
    """user id -> UserInfo."""
    out = {}
    for s in _ds("train"):
        uid = int(np.asarray(s[0]).reshape(-1)[0])
        out[uid] = UserInfo(index=uid,
                            gender=int(np.asarray(s[1]).reshape(-1)[0]),
                            age=int(np.asarray(s[2]).reshape(-1)[0]),
                            job=int(np.asarray(s[3]).reshape(-1)[0]))
    return out


def movie_info():
    """movie id -> MovieInfo."""
    out = {}
    for s in _ds("train"):
        mid = int(np.asarray(s[4]).reshape(-1)[0])
        out[mid] = MovieInfo(
            index=mid,
            categories=[int(i) for i in np.asarray(s[6]).reshape(-1)],
            title=[int(i) for i in np.asarray(s[5]).reshape(-1)])
    return out


def fetch():
    pass
