"""paddle_tpu_torch's legacy data API against the JAX package's on the
CPU: ``dataset`` (the reader creators of ``tests/test_legacy_dataset.py``
over the port's vision and text datasets: mnist, cifar, uci_housing,
imdb, imikolov, movielens, wmt14, wmt16, conll05, flowers, voc2012, the
image utilities, ``common.download`` resolving local files only) and
``reader`` (map_readers, shuffle, chain, compose, buffered, firstn,
cache, xmap_readers).

Every sample, dictionary and metadata query equals the reference's,
element for element (both read the same seeded synthetic data offline);
the image transforms are exact on the same array and numpy seed.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as paddle


def _take(reader, n):
    out = []
    for i, sample in enumerate(reader()):
        if i >= n:
            break
        out.append(sample)
    return out


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


READERS = {
    "mnist.train": lambda P: P.dataset.mnist.train(),
    "mnist.test": lambda P: P.dataset.mnist.test(),
    "cifar.train10": lambda P: P.dataset.cifar.train10(),
    "cifar.test100": lambda P: P.dataset.cifar.test100(),
    "uci_housing.train": lambda P: P.dataset.uci_housing.train(),
    "uci_housing.test": lambda P: P.dataset.uci_housing.test(),
    "imdb.train": lambda P: P.dataset.imdb.train(P.dataset.imdb.word_dict()),
    "imikolov.ngram": lambda P: P.dataset.imikolov.train(
        P.dataset.imikolov.build_dict(), 5),
    "imikolov.seq": lambda P: P.dataset.imikolov.test(
        P.dataset.imikolov.build_dict(), 5,
        P.dataset.imikolov.DataType.SEQ),
    "movielens.train": lambda P: P.dataset.movielens.train(),
    "wmt14.train": lambda P: P.dataset.wmt14.train(1000),
    "wmt16.train": lambda P: P.dataset.wmt16.train(500, 500),
    "wmt16.validation": lambda P: P.dataset.wmt16.validation(500, 500),
    "conll05.test": lambda P: P.dataset.conll05.test(),
    "flowers.train": lambda P: P.dataset.flowers.train(),
    "voc2012.val": lambda P: P.dataset.voc2012.val(),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_creators_match_reference(name):
    got = _take(READERS[name](paddle), 3)
    want = _take(READERS[name](ref), 3)
    assert len(got) == len(want) > 0
    _equal(got, want)


def test_reader_contracts():
    """tests/test_legacy_dataset.py's checks on the port's readers."""
    img, label = _take(paddle.dataset.mnist.train(), 1)[0]
    assert img.shape == (784,) and img.dtype == np.float32
    assert -1.0 <= img.min() and img.max() <= 1.0 and 0 <= label <= 9
    img, label = _take(paddle.dataset.cifar.test100(), 1)[0]
    assert img.shape == (3072,) and 0 <= label <= 99
    feat, price = _take(paddle.dataset.uci_housing.train(), 1)[0]
    assert feat.shape == (13,) and price.shape == (1,)
    gram = _take(paddle.dataset.imikolov.train(
        paddle.dataset.imikolov.build_dict(), 5), 1)[0]
    assert len(gram) == 5
    src, trg, trg_next = _take(paddle.dataset.wmt14.train(1000), 1)[0]
    assert len(src) > 0 and len(trg) == len(trg_next)


def test_dictionaries_and_metadata_match_reference():
    for P_get in (lambda P: P.dataset.imdb.word_dict(),
                  lambda P: P.dataset.imikolov.build_dict(),
                  lambda P: P.dataset.wmt14.get_dict(100),
                  lambda P: P.dataset.wmt16.get_dict("en", 200),
                  lambda P: P.dataset.conll05.get_dict(),
                  lambda P: P.dataset.conll05.get_embedding(),
                  lambda P: P.dataset.movielens.max_user_id(),
                  lambda P: P.dataset.movielens.max_movie_id(),
                  lambda P: P.dataset.movielens.max_job_id(),
                  lambda P: P.dataset.movielens.get_movie_title_dict(),
                  lambda P: P.dataset.movielens.movie_categories()):
        _equal(P_get(paddle), P_get(ref))
    info_t = paddle.dataset.movielens.movie_info()
    info_r = ref.dataset.movielens.movie_info()
    assert info_t.keys() == info_r.keys()
    mid = next(iter(info_t))
    assert tuple(info_t[mid]) == tuple(info_r[mid])
    assert info_t[mid].index == mid and len(info_t[mid].categories) > 0
    users = paddle.dataset.movielens.user_info()
    assert {k: tuple(v) for k, v in users.items()} == \
        {k: tuple(v) for k, v in ref.dataset.movielens.user_info().items()}


def test_image_utils_match_reference():
    im = (np.arange(40 * 30 * 3) % 255).reshape(40, 30, 3).astype("uint8")
    for fn in (lambda I: I.resize_short(im, 24),
               lambda I: I.center_crop(I.resize_short(im, 24), 20),
               lambda I: I.to_chw(I.center_crop(im, 20)),
               lambda I: I.left_right_flip(im)):
        _equal(fn(paddle.dataset.image), fn(ref.dataset.image))
    outs = []
    for P in (paddle, ref):
        np.random.seed(4)
        outs.append([P.dataset.image.simple_transform(
            im, 32, 24, is_train=train, mean=[1.0, 2.0, 3.0])
            for train in (True, True, False)])
    _equal(outs[0], outs[1])
    assert outs[0][0].shape == (3, 24, 24) and outs[0][0].dtype == np.float32


def test_common_download_is_local_only(tmp_path, monkeypatch):
    monkeypatch.setattr(paddle.dataset.common, "DATA_HOME", str(tmp_path))
    (tmp_path / "m").mkdir()
    f = tmp_path / "m" / "a.bin"
    f.write_bytes(b"xyz")
    md5 = paddle.dataset.common.md5file(str(f))
    assert md5 == ref.dataset.common.md5file(str(f))
    assert paddle.dataset.common.download("http://h/a.bin", "m", md5) == \
        str(f)
    with pytest.raises(RuntimeError, match="md5"):
        paddle.dataset.common.download("http://h/a.bin", "m", "0" * 32)
    with pytest.raises(RuntimeError, match="no network"):
        paddle.dataset.common.download("http://h/b.bin", "m", None)


def _src(n):
    def reader():
        return iter(range(n))
    return reader


def _pairs(n):
    def reader():
        return iter([(i, -i) for i in range(n)])
    return reader


def _run_both(build, seed=None):
    outs = []
    for P in (paddle, ref):
        if seed is not None:
            import random
            random.seed(seed)
        outs.append(list(build(P.reader)()))
    return outs


@pytest.mark.parametrize("case", [
    "map_readers", "shuffle", "chain", "compose", "compose_unchecked",
    "buffered", "firstn", "cache", "xmap_ordered", "xmap_unordered"])
def test_reader_decorators_match_reference(case):
    builds = {
        "map_readers": lambda R: R.map_readers(lambda a, b: a * 10 + b,
                                               _src(5), _src(7)),
        "shuffle": lambda R: R.shuffle(_src(23), 5),
        "chain": lambda R: R.chain(_src(3), _src(4)),
        "compose": lambda R: R.compose(_pairs(4), _src(4)),
        "compose_unchecked": lambda R: R.compose(
            _pairs(5), _src(3), check_alignment=False),
        "buffered": lambda R: R.buffered(_src(50), 4),
        "firstn": lambda R: R.firstn(_src(50), 6),
        "cache": lambda R: R.cache(_src(6)),
        "xmap_ordered": lambda R: R.xmap_readers(lambda x: x * x, _src(20),
                                                 3, 4, order=True),
        "xmap_unordered": lambda R: R.xmap_readers(lambda x: x * x,
                                                   _src(20), 3, 4),
    }
    got, want = _run_both(builds[case], seed=9)
    if case == "xmap_unordered":
        got, want = sorted(got), sorted(want)
    assert got == want and len(got) > 0


def test_compose_not_aligned_and_errors_propagate():
    with pytest.raises(paddle.reader.ComposeNotAligned):
        list(paddle.reader.compose(_src(3), _src(4))())

    def bad():
        yield 1
        raise ValueError("boom")
    with pytest.raises(ValueError, match="boom"):
        list(paddle.reader.buffered(bad, 2)())

    def mapper(x):
        if x == 3:
            raise KeyError(x)
        return x
    # buffers larger than the reader, so no worker is left blocked on a
    # full queue once the consumer stops at the error
    with pytest.raises(KeyError):
        list(paddle.reader.xmap_readers(mapper, _src(8), 2, 16)())
    calls = []

    def counted():
        calls.append(1)
        return iter([1, 2])
    c = paddle.reader.cache(counted)
    assert list(c()) == list(c()) == [1, 2] and len(calls) == 1
