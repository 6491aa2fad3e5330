"""Sparse (row-slice) gradients for embedding tables (a port of
``paddle_tpu/core/sparse_grad.py``; reference semantics: Paddle's
SelectedRows, selected_rows.h:41).

``nn.Embedding(sparse=True)`` looks its rows up with
``F.embedding(..., sparse=True)``, so torch's autograd leaves a sparse
COO grad ``[vocab, dim]`` on the table's torch leaf: its indices are the
looked-up rows and its values their grads, duplicates summed when read.
Torch's own accumulation merges two backwards by concatenating them, as
the reference's ``IndexedSlices.merge`` does. A ``Parameter``'s ``.grad``
wraps such a grad as a ``SparseGradTensor`` whose ``slices`` are those
indices and values; the optimizers' sparse paths and
``ClipGradByGlobalNorm`` read the slices, so a large table never has a
dense grad.

A ``SparseGradTensor`` is a ``Tensor`` whose dense value is made
lazily: whatever reads its value (a hook, ``numpy()``, an op, an
optimizer without a sparse update) gets the dense tensor, after which
``is_sparse()`` is False; ``shape`` and ``dtype`` do not densify.
"""
import torch

from .tensor import Tensor, as_torch

_VALUE = Tensor.__dict__["_v"]   # the slot under the densifying property


class IndexedSlices:
    """Rows ``values[k]`` sit at row ``indices[k]`` of a dense tensor of
    shape ``full_shape``; unlisted rows are zero. Duplicate indices mean
    summation (as SelectedRows). ``indices`` is a 1-D int64 torch
    tensor, ``values`` ``[n, *full_shape[1:]]``."""

    __slots__ = ("indices", "values", "full_shape", "coalesced")

    def __init__(self, indices, values, full_shape, coalesced=False):
        self.indices = indices
        self.values = values
        self.full_shape = tuple(int(s) for s in full_shape)
        self.coalesced = coalesced

    @classmethod
    def from_torch(cls, grad):
        """The slices of a sparse COO tensor with one sparse dim (what
        ``F.embedding(sparse=True)`` leaves), as they are."""
        return cls(grad._indices()[0], grad._values(), grad.shape,
                   coalesced=grad.is_coalesced())

    def to_torch(self):
        """The same rows as a sparse COO tensor."""
        t = torch.sparse_coo_tensor(self.indices[None], self.values,
                                    self.full_shape, check_invariants=False)
        return t._coalesced_(self.coalesced)

    @property
    def nbytes(self):
        return (self.values.numel() * self.values.element_size()
                + self.indices.numel() * self.indices.element_size())

    @property
    def dtype(self):
        return self.values.dtype

    def merge(self, other):
        """Concatenate slice sets (sum semantics via duplicate
        indices)."""
        if self.full_shape != other.full_shape:
            raise ValueError(f"merge: shapes {self.full_shape} and "
                             f"{other.full_shape} differ")
        return IndexedSlices(torch.cat([self.indices, other.indices]),
                             torch.cat([self.values, other.values]),
                             self.full_shape)

    def coalesce(self):
        """Sum duplicate rows -> unique, sorted indices (reference:
        scatter::MergeAdd on SelectedRows)."""
        if self.coalesced:
            return self
        uniq, inv = torch.unique(self.indices, sorted=True,
                                 return_inverse=True)
        summed = torch.zeros((uniq.shape[0], *self.values.shape[1:]),
                             dtype=self.values.dtype,
                             device=self.values.device)
        summed.index_add_(0, inv, self.values)
        return IndexedSlices(uniq, summed, self.full_shape, coalesced=True)

    def to_dense(self):
        dense = torch.zeros(self.full_shape, dtype=self.values.dtype,
                            device=self.values.device)
        return dense.index_add_(0, self.indices, self.values)

    def scale(self, factor):
        return IndexedSlices(self.indices, self.values * factor,
                             self.full_shape, coalesced=self.coalesced)

    def __repr__(self):
        return (f"IndexedSlices(rows={int(self.indices.shape[0])}, "
                f"full_shape={self.full_shape})")


class SparseGradTensor(Tensor):
    """A gradient backed by ``IndexedSlices``, densified on first read of
    its value (the reference's Variable holding SelectedRows, which
    unaware ops see through a to-dense cast)."""

    __slots__ = ("slices",)

    def __init__(self, slices, name=None):
        _VALUE.__set__(self, None)
        self.slices = slices
        self.name = name or "sparse_grad"
        self.persistable = False
        self.trainable = True

    @property
    def _v(self):
        v = _VALUE.__get__(self)
        if v is None and self.slices is not None:
            v = self.slices.to_dense()
            _VALUE.__set__(self, v)
        return v

    @_v.setter
    def _v(self, v):
        _VALUE.__set__(self, v)

    _value = _v

    def is_sparse(self):
        return _VALUE.__get__(self) is None and self.slices is not None

    is_selected_rows = is_sparse

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        dense = self._value
        self.slices = None
        self._assign(as_torch(v, dense.dtype, dense.device))

    @property
    def shape(self):
        if self.is_sparse():
            return list(self.slices.full_shape)
        return Tensor.shape.fget(self)

    @property
    def dtype(self):
        if self.is_sparse():
            from . import dtype as dtype_mod
            return dtype_mod.to_paddle_dtype(self.slices.values.dtype)
        return Tensor.dtype.fget(self)

    def accumulate(self, other):
        """Sum-accumulate another gradient (``IndexedSlices`` or a dense
        tensor) into this one, staying sparse when both are."""
        if isinstance(other, IndexedSlices) and self.is_sparse():
            self.slices = self.slices.merge(other)
            return self
        if isinstance(other, IndexedSlices):
            other = other.to_dense()
        dense = self._value + as_torch(other)
        self.slices = None
        _VALUE.__set__(self, dense)
        return self


def sparse_slices(grad):
    """The ``IndexedSlices`` of a sparse grad (a sparse torch tensor or a
    ``SparseGradTensor`` not yet densified), else None."""
    if isinstance(grad, SparseGradTensor):
        return grad.slices if grad.is_sparse() else None
    if isinstance(grad, torch.Tensor) and grad.is_sparse:
        return IndexedSlices.from_torch(grad)
    return None
