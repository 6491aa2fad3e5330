"""Ops of the port.

Kernels live in ``csrc/`` and are built at first use (``_build``); every
kernel wrapper computes its plain PyTorch version on CPU tensors. The
Paddle-style ops of the eager core (``math``, ``reduction``, ``logic``,
``indexing``, ``creation``, ``manipulation``, ``search``, ``nn_ops``,
``linalg``) take Tensors; importing this package attaches them to the Tensor as its
operators, methods and in-place variants (reference ``ops/__init__.py``'s
patch, for the ops ported so far).
"""
from . import (  # noqa: F401
    creation, indexing, linalg, logic, manipulation, math, nn_ops,
    reduction, search)
from ..core.tensor import Tensor


def _true_div(a, b):
    """The ``/`` operator: int tensors are cast to float32 first (true
    division), while ``divide()`` keeps integer division (reference
    math_op_patch.py:190)."""
    def _c(t):
        if isinstance(t, Tensor) and "int" in t.dtype.name:
            return t.astype("float32")
        return t
    return math.divide(_c(a), _c(b))


def _patch():
    T = Tensor
    m, r, lg, mp, s = math, reduction, logic, manipulation, search

    T.__add__ = lambda self, o: m.add(self, o)
    T.__radd__ = lambda self, o: m.add(o, self)
    T.__sub__ = lambda self, o: m.subtract(self, o)
    T.__rsub__ = lambda self, o: m.subtract(o, self)
    T.__mul__ = lambda self, o: m.multiply(self, o)
    T.__rmul__ = lambda self, o: m.multiply(o, self)
    T.__truediv__ = lambda self, o: _true_div(self, o)
    T.__rtruediv__ = lambda self, o: _true_div(o, self)
    T.__floordiv__ = lambda self, o: m.floor_divide(self, o)
    T.__mod__ = lambda self, o: m.remainder(self, o)
    T.__pow__ = lambda self, o: m.pow(self, o)
    T.__rpow__ = lambda self, o: m.pow(o, self)
    T.__neg__ = lambda self: m.neg(self)
    T.__abs__ = lambda self: m.abs(self)
    T.__matmul__ = lambda self, o: m.matmul(self, o)
    T.__rmatmul__ = lambda self, o: m.matmul(o, self)
    T.__eq__ = lambda self, o: lg.equal(self, o)
    T.__ne__ = lambda self, o: lg.not_equal(self, o)
    T.__lt__ = lambda self, o: lg.less_than(self, o)
    T.__le__ = lambda self, o: lg.less_equal(self, o)
    T.__gt__ = lambda self, o: lg.greater_than(self, o)
    T.__ge__ = lambda self, o: lg.greater_equal(self, o)
    T.__invert__ = lambda self: lg.logical_not(self)
    T.__and__ = lambda self, o: lg.logical_and(self, o)
    T.__or__ = lambda self, o: lg.logical_or(self, o)
    T.__xor__ = lambda self, o: lg.logical_xor(self, o)
    T.__getitem__ = lambda self, idx: indexing.getitem(self, idx)
    T.__setitem__ = lambda self, idx, v: indexing.setitem(self, idx, v)

    def meth(fn):
        def _m(self, *a, **k):
            return fn(self, *a, **k)
        return _m

    methods = {
        # math
        "add": m.add, "subtract": m.subtract, "multiply": m.multiply,
        "divide": m.divide, "matmul": m.matmul, "mm": m.matmul, "bmm": m.bmm,
        "dot": m.dot, "mv": m.mv, "pow": m.pow, "abs": m.abs, "exp": m.exp,
        "log": m.log, "log2": m.log2, "log10": m.log10, "log1p": m.log1p,
        "sqrt": m.sqrt, "rsqrt": m.rsqrt, "square": m.square, "sin": m.sin,
        "cos": m.cos, "tan": m.tan, "asin": m.asin, "acos": m.acos,
        "atan": m.atan, "sinh": m.sinh, "cosh": m.cosh, "tanh": m.tanh,
        "floor": m.floor, "ceil": m.ceil, "round": m.round, "trunc": m.trunc,
        "sign": m.sign, "reciprocal": m.reciprocal, "erf": m.erf,
        "sigmoid": m.sigmoid, "clip": m.clip, "lerp": m.lerp, "scale": m.scale,
        "maximum": m.maximum, "minimum": m.minimum, "remainder": m.remainder,
        "mod": m.mod, "floor_divide": m.floor_divide, "neg": m.neg,
        "cumsum": m.cumsum, "cumprod": m.cumprod, "isnan": m.isnan,
        "isinf": m.isinf, "isfinite": m.isfinite, "addmm": m.addmm,
        "trace": m.trace, "diff": m.diff, "kron": m.kron, "outer": m.outer,
        "inner": m.inner, "atan2": m.atan2, "logit": m.logit,
        "nan_to_num": m.nan_to_num, "increment": m.increment,
        "stanh": m.stanh, "expm1": m.expm1, "angle": m.angle, "conj": m.conj,
        "add_n": m.add_n, "cross": m.cross, "histogram": m.histogram,
        "digamma": m.digamma, "lgamma": m.lgamma, "real": m.real,
        "imag": m.imag, "floor_mod": m.floor_mod, "renorm": m.renorm,
        "logcumsumexp": m.logcumsumexp, "trapezoid": m.trapezoid,
        "vander": m.vander,
        # reduction
        "sum": r.sum, "mean": r.mean, "max": r.max, "min": r.min,
        "prod": r.prod, "all": r.all, "any": r.any, "std": r.std,
        "var": r.var, "median": r.median, "logsumexp": r.logsumexp,
        "norm": r.norm, "dist": r.dist, "amax": r.max, "amin": r.min,
        "count_nonzero": r.count_nonzero, "nansum": r.nansum,
        "nanmean": r.nanmean, "quantile": r.quantile,
        "nanmedian": r.nanmedian, "nanquantile": r.nanquantile,
        # logic
        "equal": lg.equal, "not_equal": lg.not_equal,
        "greater_than": lg.greater_than, "greater_equal": lg.greater_equal,
        "less_than": lg.less_than, "less_equal": lg.less_equal,
        "logical_and": lg.logical_and, "logical_or": lg.logical_or,
        "logical_not": lg.logical_not, "logical_xor": lg.logical_xor,
        "isclose": lg.isclose, "allclose": lg.allclose,
        "equal_all": lg.equal_all, "bitwise_and": lg.bitwise_and,
        "bitwise_or": lg.bitwise_or, "bitwise_xor": lg.bitwise_xor,
        "bitwise_not": lg.bitwise_not, "is_empty": lg.is_empty,
        "is_tensor": lg.is_tensor,
        # manipulation
        "reshape": mp.reshape, "transpose": mp.transpose, "t": mp.t,
        "flatten": mp.flatten, "squeeze": mp.squeeze,
        "unsqueeze": mp.unsqueeze, "tile": mp.tile, "expand": mp.expand,
        "expand_as": mp.expand_as, "broadcast_to": mp.broadcast_to,
        "flip": mp.flip, "roll": mp.roll, "gather": mp.gather,
        "gather_nd": mp.gather_nd, "scatter": mp.scatter,
        "scatter_nd_add": mp.scatter_nd_add,
        "index_select": mp.index_select, "index_sample": mp.index_sample,
        "masked_select": mp.masked_select, "masked_fill": mp.masked_fill,
        "split": mp.split, "chunk": mp.chunk, "unbind": mp.unbind,
        "slice": mp.slice, "take_along_axis": mp.take_along_axis,
        "put_along_axis": mp.put_along_axis, "unstack": mp.unstack,
        "repeat_interleave": mp.repeat_interleave, "pad": mp.pad,
        "where": mp.where, "rot90": mp.rot90, "concat": mp.concat,
        "stack": mp.stack, "strided_slice": mp.strided_slice,
        "shard_index": mp.shard_index, "multiplex": mp.multiplex,
        "reverse": mp.reverse, "broadcast_tensors": mp.broadcast_tensors,
        "moveaxis": mp.moveaxis, "index_add": mp.index_add,
        "index_fill": mp.index_fill, "tensordot": mp.tensordot,
        "as_real": mp.as_real, "as_complex": mp.as_complex,
        "broadcast_shape": mp.broadcast_shape,
        # search
        "argmax": s.argmax, "argmin": s.argmin, "argsort": s.argsort,
        "sort": s.sort, "topk": s.topk, "nonzero": s.nonzero,
        "unique": s.unique, "kthvalue": s.kthvalue, "mode": s.mode,
        "searchsorted": s.searchsorted, "bincount": s.bincount,
        "bucketize": s.bucketize,
        # nn and creation
        "softmax": nn_ops.softmax, "tril": creation.tril,
        "triu": creation.triu, "diag": creation.diag,
        "zeros_like": creation.zeros_like, "ones_like": creation.ones_like,
        "full_like": creation.full_like,
    }
    for name, fn in methods.items():
        setattr(T, name, meth(fn))
    T.T = property(lambda self: mp.t(self))
    T.scatter_nd = staticmethod(mp.scatter_nd)

    def rank(self):
        return creation.to_tensor(self.ndim)
    T.rank = rank

    # in-place variants: the result written into the tensor's value
    def inplace(fn):
        def _m(self, *a, **k):
            self.set_value(fn(self, *a, **k)._value)
            return self
        return _m

    for name, fn in {
        "add_": m.add, "subtract_": m.subtract, "ceil_": m.ceil,
        "floor_": m.floor, "clip_": m.clip, "exp_": m.exp,
        "reciprocal_": m.reciprocal, "round_": m.round,
        "rsqrt_": m.rsqrt, "sqrt_": m.sqrt, "scale_": m.scale,
        "tanh_": m.tanh,
    }.items():
        setattr(T, name, inplace(fn))

    # in-place variants that change the shape: the value swapped
    for name, fn in {
        "reshape_": mp.reshape_, "squeeze_": mp.squeeze_,
        "unsqueeze_": mp.unsqueeze_, "flatten_": mp.flatten_,
        "scatter_": mp.scatter_, "index_add_": mp.index_add_,
        "index_fill_": mp.index_fill_,
    }.items():
        setattr(T, name, meth(fn))


_patch()
