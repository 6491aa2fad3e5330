"""LoDTensor: level-of-detail (ragged) tensors (a port of
``paddle_tpu/core/lod.py``).

The data is one dense tensor of the concatenated sequences, on the
device; the LoD offsets are host metadata carried beside it (a list of
offset lists, the outer levels indexing into the next one). The boundary
conversions are explicit: ``to_padded()`` gives ``(padded [N, L, ...],
lengths)`` for the masked dense ops of ``ops/sequence.py``,
``segment_ids()`` the row -> sequence map, ``sequence_list()`` the
sequences as numpy arrays. ``lod_sequence_pool`` and
``lod_sequence_expand`` reduce and repeat by segments in torch.
"""
import numpy as np
import torch

from .tensor import Tensor


def _lengths_to_offsets(lengths):
    off = [0]
    for n in lengths:
        off.append(off[-1] + int(n))
    return off


class LoDTensor(Tensor):
    """Dense data + LoD offsets; the last level indexes rows of the
    data."""

    __slots__ = ("_lod",)

    def __init__(self, data, lod=None, **kw):
        super().__init__(data, **kw)
        self._lod = [list(map(int, lv)) for lv in (lod or [])]
        self._check()

    def _check(self):
        n = self._v.shape[0] if self._v.dim() else 0
        for i, lv in enumerate(self._lod):
            if lv and lv[0] != 0:
                raise ValueError(f"LoD level {i} must start at 0: {lv}")
            if any(a > b for a, b in zip(lv, lv[1:])):
                raise ValueError(f"LoD level {i} not non-decreasing: {lv}")
        if self._lod and self._lod[-1] and self._lod[-1][-1] != n:
            raise ValueError(
                f"last LoD offset {self._lod[-1][-1]} != rows {n}")
        for outer, inner in zip(self._lod, self._lod[1:]):
            if outer and outer[-1] != len(inner) - 1:
                raise ValueError(
                    "outer LoD level must index into the inner level")

    def lod(self):
        return [list(lv) for lv in self._lod]

    def set_lod(self, lod):
        new = [list(map(int, lv)) for lv in lod]
        old, self._lod = self._lod, new
        try:
            self._check()
        except ValueError:
            self._lod = old   # a rejected LoD leaves the tensor as it was
            raise

    def recursive_sequence_lengths(self):
        """The offsets as nested lengths."""
        return [[b - a for a, b in zip(lv, lv[1:])] for lv in self._lod]

    def has_valid_recursive_sequence_lengths(self):
        try:
            self._check()
            return True
        except ValueError:
            return False

    def nseq(self, level=-1):
        return len(self._lod[level]) - 1

    def lengths(self, level=-1):
        lv = self._lod[level]
        return np.asarray([b - a for a, b in zip(lv, lv[1:])], "int64")

    def segment_ids(self, level=-1):
        """Row -> sequence index."""
        return np.repeat(np.arange(self.nseq(level)), self.lengths(level))

    def to_padded(self, pad_value=0.0, level=-1):
        """``(padded [N, L, ...], lengths)`` Tensors."""
        data = np.asarray(self.numpy())
        lv = self._lod[level]
        lens = self.lengths(level)
        L = int(lens.max()) if len(lens) else 0
        out = np.full((len(lens), L) + data.shape[1:], pad_value,
                      data.dtype)
        for i, (a, b) in enumerate(zip(lv, lv[1:])):
            out[i, :b - a] = data[a:b]
        return Tensor(out), Tensor(np.asarray(lens))

    def sequence_list(self, level=-1):
        data = np.asarray(self.numpy())
        lv = self._lod[level]
        return [data[a:b] for a, b in zip(lv, lv[1:])]

    def __repr__(self):
        return f"LoDTensor(shape={self.shape}, lod={self._lod})"


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """``data`` (an array, or a list of per-sequence arrays, whose rows
    concatenate all sequences) with nested LENGTHS turned into offsets,
    on the current device (``place`` is taken and not read, as in the
    reference)."""
    if isinstance(data, list) and data and isinstance(
            data[0], (list, np.ndarray)) and np.asarray(data[0]).ndim >= 1:
        flat = np.concatenate([np.asarray(d) for d in data], axis=0)
    else:
        flat = np.asarray(data)
    lod = [_lengths_to_offsets(lv) for lv in recursive_seq_lens]
    return LoDTensor(flat, lod=lod)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low=0, high=1):
    """Integers in ``[low, high]`` from numpy's global generator, as the
    reference draws them."""
    total = sum(recursive_seq_lens[-1])
    data = np.random.randint(low, high + 1,
                             (total,) + tuple(base_shape)).astype("int64")
    lod = [_lengths_to_offsets(lv) for lv in recursive_seq_lens]
    return LoDTensor(data, lod=lod)


def lod_sequence_pool(t, pool_type="SUM"):
    """``sequence_pool`` over a LoDTensor by segments (SUM, AVERAGE, MAX,
    MIN, FIRST, LAST); a dense ``[nseq, ...]`` Tensor. An empty sequence
    pools to zeros for FIRST and LAST, to the reduction's identity for
    MAX and MIN (``jax.ops.segment_max``'s)."""
    data = t.value
    dev = data.device
    seg = torch.as_tensor(t.segment_ids(), device=dev)
    n = t.nseq()
    tail = tuple(data.shape[1:])
    idx = seg.reshape((-1,) + (1,) * len(tail)).expand(data.shape)
    pt = pool_type.upper()
    if pt in ("SUM", "AVERAGE"):
        out = torch.zeros((n,) + tail, dtype=data.dtype,
                          device=dev).scatter_add(0, idx, data)
        if pt == "AVERAGE":
            cnt = torch.as_tensor(t.lengths(), device=dev).to(data.dtype)
            out = out / torch.clamp(cnt, min=1).reshape(
                (-1,) + (1,) * len(tail))
    elif pt in ("MAX", "MIN"):
        if data.is_floating_point():
            init = -float("inf") if pt == "MAX" else float("inf")
        else:
            init = torch.iinfo(data.dtype).min if pt == "MAX" \
                else torch.iinfo(data.dtype).max
        out = torch.full((n,) + tail, init, dtype=data.dtype,
                         device=dev).scatter_reduce(
            0, idx, data, "amax" if pt == "MAX" else "amin",
            include_self=True)
    elif pt in ("FIRST", "LAST"):
        lv = t._lod[-1]
        rows = data.shape[0]
        pick = [min(a, rows - 1) for a in lv[:-1]] if pt == "FIRST" \
            else [max(b - 1, 0) for b in lv[1:]]
        out = data[torch.as_tensor(pick, dtype=torch.long, device=dev)]
        keep = torch.as_tensor(t.lengths() > 0, device=dev).reshape(
            (-1,) + (1,) * len(tail))
        out = torch.where(keep, out, torch.zeros_like(out))
    else:
        raise ValueError(f"unknown pool_type {pool_type!r}")
    return Tensor._wrap(out)


def lod_sequence_expand(x, ref):
    """Each row of ``x`` repeated by ``ref``'s sequence lengths, as a
    LoDTensor with ``ref``'s last level."""
    lens = ref.lengths()
    data = x.value if isinstance(x, Tensor) else torch.as_tensor(
        np.asarray(x))
    rep = torch.as_tensor(np.repeat(np.arange(len(lens)), lens),
                          dtype=torch.long, device=data.device)
    return LoDTensor(data[rep], lod=[ref._lod[-1]])
