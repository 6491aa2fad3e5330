"""paddle.reader decorators (a port of ``paddle_tpu/reader.py``;
reference: python/paddle/reader/decorator.py:
map_readers, shuffle, chain, compose, buffered, firstn, cache,
xmap_readers). A "reader" is a zero-arg callable returning an iterable of
samples — the pre-2.0 data API still used by fleet dataset pipelines.
"""
import itertools
import queue
import random as _random
import threading


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)
    return reader


def shuffle(reader, buf_size):
    def shuffled():
        buf = []
        for s in reader():
            buf.append(s)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        _random.shuffle(buf)
        yield from buf
    return shuffled


def chain(*readers):
    def chained():
        return itertools.chain(*[r() for r in readers])
    return chained


class ComposeNotAligned(ValueError):
    """Reference: reader/decorator.py ComposeNotAligned — raised when
    composed readers yield different numbers of samples."""


def compose(*readers, **kwargs):
    check_alignment = kwargs.get("check_alignment", True)
    _end = object()

    def composed():
        rs = [iter(r()) for r in readers]
        while True:
            vals = [next(it, _end) for it in rs]
            if all(v is _end for v in vals):
                return
            if any(v is _end for v in vals):
                if check_alignment:
                    raise ComposeNotAligned(
                        "readers yield different sample counts")
                return  # unchecked: stop at the shortest reader
            out = ()
            for v in vals:
                out += v if isinstance(v, tuple) else (v,)
            yield out
    return composed


def buffered(reader, size):
    """Background-thread prefetch of up to `size` samples (reference
    decorator.py buffered — the python-side analogue of the C++
    buffered_reader double-buffering)."""
    end = object()

    def buffered_reader():
        q = queue.Queue(maxsize=size)

        def fill():
            try:
                for s in reader():
                    q.put(s)
                q.put(end)
            except BaseException as e:  # propagate to the consumer
                q.put(e)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            s = q.get()
            if s is end:
                break
            if isinstance(s, BaseException):
                raise s
            yield s
    return buffered_reader


def firstn(reader, n):
    def firstn_reader():
        return itertools.islice(reader(), n)
    return firstn_reader


def cache(reader):
    all_data = []
    filled = []

    def cached():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        return iter(all_data)
    return cached


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Thread-pool map over a reader, streaming with at most buffer_size
    samples in flight (reference decorator.py xmap_readers); order=True
    preserves input order."""
    if order:
        def ordered():
            return map(mapper, reader())
        return ordered

    _end = object()

    def xreader():
        in_q = queue.Queue(maxsize=max(1, buffer_size))
        out_q = queue.Queue(maxsize=max(1, buffer_size))

        def feed():
            try:
                for s in reader():
                    in_q.put(s)
            except BaseException as e:
                in_q.put(e)
            for _ in range(process_num):
                in_q.put(_end)

        def work():
            while True:
                s = in_q.get()
                if s is _end:
                    out_q.put(_end)
                    return
                if isinstance(s, BaseException):
                    out_q.put(s)
                    return
                try:
                    out_q.put(mapper(s))
                except BaseException as e:
                    out_q.put(e)  # deliver, never deadlock the consumer

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True)
                   for _ in range(process_num)]
        for t in workers:
            t.start()
        finished = 0
        while finished < process_num:
            r = out_q.get()
            if r is _end:
                finished += 1
                continue
            if isinstance(r, BaseException):
                raise r
            yield r
    return xreader
