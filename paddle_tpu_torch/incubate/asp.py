"""ASP: automatic n:m (default 2:4) structured sparsity (a port of
``paddle_tpu/incubate/asp.py``; Paddle's
``fluid/contrib/sparsity/{asp.py, utils.py}``).

``prune_model`` zeroes all but the n largest |values| of every group of
m consecutive elements along the rows of ``w.reshape(w.shape[0], -1)``,
in the reference's layout, and registers each mask; ``decorate`` wraps
an optimizer so that every ``step()`` multiplies the masked parameters
by their masks again. As in the reference, every trainable parameter of
rank 2 or more whose rows or flattened columns are a multiple of 4 is
pruned, the word and position embeddings included.

* **Layout.** The reference's linear weights are ``[in, out]``, so its
  groups run along ``out``. The port's torch GPT and BERT store them
  ``[out, in]``; ``prune_model`` computes their masks on the transposed
  view (``text.convert.is_transposed`` says which), so both packages
  keep the same weights. A model of the Paddle ``nn`` surface is in the
  reference's layout already.
* **Device.** ``get_mask_1d`` and ``check_mask_1d`` run in torch on the
  tensor's device: each element's place in its group's ascending order
  of |value|, equal values ordered by position (``np.argsort``'s
  ``kind="stable"``), and the m - n first dropped. For 2:4 that drops
  the very pair ``np.argsort``'s default sort drops, ties included
  (over all 256 groups of 4 values from 0..3); for other n:m a tie
  across the cut may drop another element than the reference's default
  sort, whose order there depends on numpy's build. The reference's
  numpy functions are kept as ``*_plain``. ``get_mask_2d_greedy`` is a
  sequential greedy walk and runs the reference's numpy code on the
  host.
* **Masks** are ``bool`` tensors on the parameter's device (1 byte a
  weight), multiplied into the parameter in its own dtype, which gives
  the reference's product. The registry is keyed by the parameter object
  as the model and the optimizer hold it (a ``torch.nn.Parameter`` or
  the eager core's ``Parameter``), never by ``id()``, and lets a freed
  parameter go.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..core import lazy
from ..core.tensor import Tensor
from ..optimizer.optimizer import WrappedOptimizer, _leaf
from ..text.convert import is_transposed


def _torch(x):
    """``x`` as a torch tensor (a Tensor's value, a numpy array on the
    CPU)."""
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def calculate_density(x):
    """Fraction of nonzeros (reference utils.py:86)."""
    if isinstance(x, (Tensor, torch.Tensor)):
        t = _torch(x)
        return float(torch.count_nonzero(t)) / max(1, t.numel())
    x = np.asarray(x)
    return float(np.count_nonzero(x)) / max(1, x.size)


def _as_2d(mat):
    return mat.reshape(mat.shape[0], -1) if mat.dim() > 1 \
        else mat.reshape(1, -1)


def _groups(mat2d, m):
    """Columns padded with zeros to a multiple of m, viewed as rows of m
    (utils.py:108); the padded 2-D shape."""
    pad = (-mat2d.shape[1]) % m
    if pad:
        mat2d = F.pad(mat2d, (0, pad))
    return mat2d.reshape(-1, m), mat2d.shape


def _mask_1d(mat, n, m):
    """The bool keep-mask of torch tensor ``mat`` on its device."""
    mat2d = _as_2d(mat)
    groups, padded = _groups(mat2d, m)
    a = groups.abs()
    below = a[:, None, :] < a[:, :, None]           # [g, i, j]: |j| < |i|
    earlier = torch.ones(m, m, dtype=torch.bool, device=a.device).tril(-1)
    below |= (a[:, None, :] == a[:, :, None]) & earlier
    keep = below.sum(-1) >= m - n                   # stable place >= m - n
    return keep.reshape(padded)[:, :mat2d.shape[1]].reshape(mat.shape)


def get_mask_1d(mat, n, m):
    """Keep the n largest |values| in every group of m consecutive
    elements along rows (reference utils.py:180). A torch tensor (or
    Tensor) gives a bool mask on its device; a numpy array the
    reference's mask, in its dtype."""
    if isinstance(mat, (Tensor, torch.Tensor)):
        return _mask_1d(_torch(mat), n, m)
    mat = np.asarray(mat)
    return _mask_1d(_torch(mat), n, m).numpy().astype(mat.dtype)


def check_mask_1d(mat, n, m):
    """True iff every m-group has at most n nonzeros (utils.py:136),
    counted on the tensor's device."""
    groups, _ = _groups(_as_2d(_torch(mat)), m)
    return bool(((groups != 0).sum(1) <= n).all())


def get_mask_2d_greedy(mat, n, m):
    """Greedy m x m block mask keeping n per row and column (reference
    utils.py:313): the reference's host walk; a torch tensor gives a
    bool mask on its device."""
    if isinstance(mat, (Tensor, torch.Tensor)):
        t = _torch(mat)
        mask = get_mask_2d_greedy_plain(
            t.detach().float().cpu().numpy(), n, m)
        return torch.from_numpy(mask).to(device=t.device, dtype=torch.bool)
    return get_mask_2d_greedy_plain(mat, n, m)


# ---- the reference's numpy functions: the plain versions ---------------------

def _reshape_1d_plain(mat, m):
    mat = np.asarray(mat)
    if mat.shape[1] % m != 0:
        pad = m - mat.shape[1] % m
        mat = np.concatenate(
            [mat, np.zeros((mat.shape[0], pad), mat.dtype)], axis=1)
    return mat.reshape(-1, m), mat.shape


def get_mask_1d_plain(mat, n, m):
    """The reference's ``get_mask_1d`` (``np.argsort``'s default sort)."""
    mat = np.asarray(mat)
    orig_shape = mat.shape
    mat2d = mat.reshape(orig_shape[0], -1) if mat.ndim > 1 else \
        mat.reshape(1, -1)
    groups, padded_shape = _reshape_1d_plain(mat2d, m)
    idx = np.argsort(np.abs(groups), axis=1)[:, : m - n]
    mask = np.ones_like(groups)
    np.put_along_axis(mask, idx, 0.0, axis=1)
    mask = mask.reshape(padded_shape)[:, : mat2d.shape[1]]
    return mask.reshape(orig_shape)


def check_mask_1d_plain(mat, n, m):
    mat2d = np.asarray(mat)
    mat2d = mat2d.reshape(mat2d.shape[0], -1) if mat2d.ndim > 1 else \
        mat2d.reshape(1, -1)
    groups, _ = _reshape_1d_plain(mat2d, m)
    return bool(np.all(np.count_nonzero(groups, axis=1) <= n))


def get_mask_2d_greedy_plain(mat, n, m):
    mat = np.asarray(mat)
    h, w = mat.shape
    ph, pw = (-h) % m, (-w) % m
    padded = np.pad(np.abs(mat), ((0, ph), (0, pw)))
    mask = np.zeros_like(padded)
    for bi in range(0, padded.shape[0], m):
        for bj in range(0, padded.shape[1], m):
            block = padded[bi:bi + m, bj:bj + m]
            bmask = np.zeros((m, m))
            order = np.argsort(-block.ravel())
            rows = np.zeros(m, np.int64)
            cols = np.zeros(m, np.int64)
            for f in order:
                r, c = divmod(int(f), m)
                if rows[r] < n and cols[c] < n:
                    bmask[r, c] = 1.0
                    rows[r] += 1
                    cols[c] += 1
            mask[bi:bi + m, bj:bj + m] = bmask
    return mask[:h, :w]


_MASK_ALGOS = {"mask_1d": get_mask_1d, "mask_2d_greedy": get_mask_2d_greedy}

# parameter (as the model holds it) -> its bool mask
_masks = WeakIdKeyDictionary()
_excluded = set()


def set_excluded_layers(param_names, main_program=None):
    _excluded.update(param_names)


def reset_excluded_layers(main_program=None):
    _excluded.clear()


def _reference_view(name, param):
    """The parameter's torch tensor in the reference's layout."""
    leaf = _leaf(param)
    if not isinstance(param, Tensor) and is_transposed(name, leaf.dim()):
        return leaf.t()
    return leaf


def _trainable(param):
    if isinstance(param, Tensor):
        return param.trainable and not param.stop_gradient
    return param.requires_grad


def _supported(name, param, shape):
    """Reference ``_supported`` (asp.py:96) on the reference's shape."""
    if len(shape) < 2:
        return False
    if name in _excluded or getattr(param, "name", None) in _excluded:
        return False
    flat_cols = int(np.prod(shape[1:]))
    return shape[0] % 4 == 0 or flat_cols % 4 == 0


@torch.no_grad()
def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """Prune the supported weights to n:m sparsity and register the
    masks (reference asp.py:95). Returns ``{name: bool mask}`` in the
    port's layout."""
    algo = _MASK_ALGOS[mask_algo]
    lazy.flush()
    masks = {}
    for name, p in model.named_parameters():
        ref = _reference_view(name, p)
        if not _trainable(p) or not _supported(name, p, tuple(ref.shape)):
            continue
        mask = algo(ref.reshape(ref.shape[0], -1), n, m).reshape(ref.shape)
        if ref is not _leaf(p):
            mask = mask.t()
        mask = mask.contiguous()
        _leaf(p).mul_(mask)
        if with_mask:
            masks[name] = mask
            _masks[p] = mask
    return masks


class OptimizerWithSparsityGuarantee(WrappedOptimizer):
    """Reference asp.py decorate:55: after every step of the inner
    optimizer, the masked parameters are multiplied by their masks, so
    pruned weights stay zero."""

    @torch.no_grad()
    def step(self):
        self._inner_opt.step()
        lazy.flush()
        for _, p in self._inner_opt._params:
            mask = _masks.get(p)
            leaf = _leaf(p)
            if mask is not None and mask.shape == leaf.shape:
                leaf.mul_(mask)


def decorate(optimizer):
    return OptimizerWithSparsityGuarantee(optimizer)
