"""``paddle_tpu_torch.fluid.layers`` against the JAX package's
``fluid.layers`` on the CPU: one case for every public name of the
reference module.

Each case runs the same code in both packages on seeded numpy inputs.
Float inputs take grads; the outputs are compared, then the sum of each
float output times a seeded cotangent is backpropagated in both and the
inputs' grads compared. A layer function that makes parameters (``fc``,
``conv2d``, ``batch_norm``, ...) runs twice: the reference's parameters
after its first call are carried into the port's cache through
``fluid.convert`` (``layer_cache_state`` / ``load_layer_cache``), then
the second call is compared, with the parameters' grads and every
cached value after it (the batch norms' moving statistics). A module a
case builds itself (``GRUCell``, a decoder's cell) takes the
reference's state dict. Random ops are held to their shapes and dtype kinds
(the port draws from torch generators, not ``jax.random``); the
descoped stubs raise ``UnimplementedError`` in both; the namespace
modules are each package's own. ``dir()`` of the two modules has the
same public names.

``mean_iou``: the reference's imports a ``metric.mean_iou`` its
package does not have and raises ImportError; the port's is held to a
numpy count of the same definition (ROADMAP divergence).

Tolerances, f32 without TF32: outputs and grads rtol 1e-4, atol 1e-5;
integer and boolean outputs equal.
"""
import contextlib
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as R
import paddle_tpu.fluid.layers as RL
import paddle_tpu_torch as P
import paddle_tpu_torch.fluid.layers as PL
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.fluid import convert

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    P.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


class Env:
    """One package's side of a case: ``P`` the package, ``L`` its
    fluid.layers; tensors made from seeded numpy."""

    def __init__(self, pkg, layers, mods=None):
        self.P, self.L = pkg, layers
        self.ref = pkg is R
        self.leaves = []
        self.mods = mods if mods is not None else []
        self._mod_i = 0

    def f(self, *shape, seed=0, scale=1.0, shift=0.0, grad=True):
        a = (np.random.RandomState(seed).randn(*shape) * scale
             + shift).astype(np.float32)
        return self.t(a, grad)

    def pos(self, *shape, seed=0, grad=True):
        a = np.random.RandomState(seed).uniform(
            0.5, 1.5, shape).astype(np.float32)
        return self.t(a, grad)

    def t(self, arr, grad=None):
        arr = np.asarray(arr)
        if grad is None:
            grad = arr.dtype.kind == "f"
        x = self.P.to_tensor(arr, stop_gradient=not grad)
        if grad:
            self.leaves.append(x)
        return x

    def i(self, arr, dtype="int64"):
        return self.P.to_tensor(np.asarray(arr, dtype))

    def mod(self, layer):
        """A module the case builds: the reference's state recorded, the
        port's set to it."""
        if self.ref:
            self.mods.append({k: np.asarray(v.numpy())
                              for k, v in layer.state_dict().items()})
        else:
            assert layer.set_state_dict(self.mods[self._mod_i]) == []
            self._mod_i += 1
        return layer

    @property
    def nn(self):
        return self.P.nn


def _arr(x):
    if x is None or isinstance(x, (bool, int, float, str, np.generic)):
        return x
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return x


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [y for o in out for y in _flat(o)]
    return [out]


def _float_outs(out):
    return [o for o in _flat(out) if hasattr(o, "numpy")
            and not getattr(o, "stop_gradient", True)
            and np.asarray(o.numpy()).dtype.kind == "f"]


def _cached_params(L):
    out = []
    for v in L._layer_cache.values():
        if hasattr(v, "parameters"):
            out += list(v.parameters())
        elif isinstance(v, tuple):
            out += list(v)
        elif not getattr(v, "stop_gradient", True):
            out.append(v)
    return out


def _grads(E, out):
    outs = _float_outs(out)
    if not outs:
        return []
    total = None
    for k, o in enumerate(outs):
        cot = np.asarray(np.random.RandomState(100 + k).randn(
            *np.asarray(o.numpy()).shape), np.float32)
        term = (o * E.P.to_tensor(cot)).sum()
        total = term if total is None else total + term
    total.backward()
    got = []
    for x in E.leaves + _cached_params(E.L):
        g = x.grad
        got.append(None if g is None else np.asarray(g.numpy()))
    return got


def _close(a, b, what):
    a, b = _arr(a), _arr(b)
    if a is None or b is None or isinstance(a, (str, bool, int, float)):
        assert a == b if not isinstance(a, float) \
            else np.isclose(a, b, rtol=RTOL, atol=ATOL), (what, a, b)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind in "fc":
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def _reset(L):
    L.clear_layer_cache()
    L._step_counters.clear()


# ---- the cases --------------------------------------------------------------
# name -> fn(E) returning the outputs; PARAMS run twice with the cache
# carried across; RANDOM compare shapes and dtypes only.

def _x(E, *shape, seed=0, scale=1.0):
    return E.f(*shape, seed=seed, scale=scale)


def _cond_case(E):
    x = _x(E, 3)
    return (E.L.cond(E.t(np.asarray(True)), lambda: x * 2.0,
                     lambda: x - 1.0),
            E.L.cond(E.t(np.asarray(False)), lambda: x * 2.0,
                     lambda: x - 1.0))


def _while_case(E):
    i = E.i([0])
    n = E.i([4])
    s = _x(E, 2)
    out = E.L.while_loop(lambda i, s: i < n,
                         lambda i, s: [i + 1, s * 1.5], [i, s])
    return out


def _py_func_case(E):
    x = _x(E, 3, 4)

    def fwd(a):
        return a * a

    def bwd(a, out, g):
        return g * 2.0 * a
    return (E.L.py_func(fwd, x, None),
            E.L.py_func(fwd, E.f(3, 4, seed=1), None, backward_func=bwd))


def _array_case(E):
    arr = E.L.create_array("float32")
    x, y = _x(E, 2), E.f(2, seed=1)
    E.L.array_write(x, E.i([0]), arr)
    E.L.array_write(y, E.i([1]), arr)
    return (E.L.array_read(arr, E.i([1])), E.L.array_length(arr),
            E.L.tensor_array_to_tensor(arr, axis=0))


def _static_rnn_case(E):
    E.P.enable_static()
    try:
        main = E.P.static.Program()
        with E.P.static.program_guard(main):
            x = E.P.static.data("x", [3, 2, 2], "float32")
            rnn = E.L.StaticRNN()
            with rnn.step():
                xt = rnn.step_input(x)
                prev = rnn.memory(shape=[-1, 2], batch_ref=xt)
                h = prev * 0.5 + xt
                rnn.update_memory(prev, h)
                rnn.step_output(h)
            out = rnn()
        xp = np.random.RandomState(0).randn(3, 2, 2).astype("float32")
        exe = E.P.static.Executor(E.P.CPUPlace())
        return exe.run(main, feed={"x": xp}, fetch_list=[out])
    finally:
        E.P.disable_static()


def _while_class_case(E):
    E.P.enable_static()
    try:
        main = E.P.static.Program()
        with E.P.static.program_guard(main):
            x = E.P.static.data("x", [2], "float32")
            i = E.L.fill_constant([1], "int64", 0)
            n = E.L.fill_constant([1], "int64", 3)
            acc = E.L.fill_constant([2], "float32", 1.0)
            cond = E.L.less_than(i, n)
            w = E.L.While(cond)
            with w.block():
                E.L.assign(acc * x, output=acc)
                i = E.L.increment(i, in_place=True)
                E.L.less_than(i, n, cond=cond)
            out = acc * 1.0
        exe = E.P.static.Executor(E.P.CPUPlace())
        return exe.run(main, feed={"x": np.asarray([1.5, 2.0], np.float32)},
                       fetch_list=[out])
    finally:
        E.P.disable_static()


def _data_case(E):
    E.P.enable_static()
    try:
        with E.P.static.program_guard(E.P.static.Program()):
            v = E.L.data("x", [None, 3], "float32")
            return list(v.shape), str(v.dtype).split(".")[-1]
    finally:
        E.P.disable_static()


def _load_case(E):
    import tempfile
    arr = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    out = E.t(np.zeros((2, 3), np.float32), grad=False)
    with tempfile.TemporaryDirectory() as d:
        E.P.save(arr, d + "/t.pdtensor")
        return E.L.load(out, d + "/t.pdtensor")


def _decoder_case(E):
    d = E.L.Decoder()
    raised = []
    for call in (lambda: d.initialize(None), lambda: d.step(0, None, None),
                 lambda: d.finalize(None, None, None)):
        try:
            call()
        except NotImplementedError:
            raised.append(True)
    return raised


def _cell_case(name):
    def case(E):
        cell = E.mod(getattr(E.L, name)(4))
        x = _x(E, 2, 4)
        h = E.f(2, 4, seed=1)
        state = h if name == "GRUCell" else (h, E.f(2, 4, seed=2))
        out = cell(x, state)
        return out, isinstance(cell, E.L.RNNCell)
    return case


def _rnn_case(E):
    cell = E.mod(E.nn.SimpleRNNCell(4, 6))
    return E.L.rnn(cell, _x(E, 3, 5, 4))


def _birnn_case(E):
    fw = E.mod(E.nn.GRUCell(4, 6))
    bw = E.mod(E.nn.GRUCell(4, 6))
    return E.L.birnn(fw, bw, _x(E, 3, 5, 4))


def _beam_case(E):
    cell = E.mod(E.nn.GRUCell(8, 8))
    emb = E.mod(E.nn.Embedding(10, 8))
    head = E.mod(E.nn.Linear(8, 10))
    dec = E.L.BeamSearchDecoder(cell, 0, 1, 3, embedding_fn=emb,
                                output_fn=head)
    inits = E.P.zeros([2, 8])
    out, _ = E.L.dynamic_decode(dec, inits=inits, max_step_num=5)
    return out


def _dist_case(name):
    def case(E):
        if name == "Uniform":
            d = E.L.Uniform(E.t(np.float32([0.0, 1.0]), False),
                            E.t(np.float32([2.0, 3.0]), False))
            return d.log_prob(E.t(np.float32([1.0, 2.0]), False)), \
                d.entropy()
        if name == "Normal":
            d = E.L.Normal(E.t(np.float32([0.0, 1.0]), False),
                           E.t(np.float32([1.0, 2.0]), False))
            return d.log_prob(E.t(np.float32([0.5, 0.5]), False)), \
                d.entropy()
        if name == "Categorical":
            d = E.L.Categorical(E.t(np.float32([[1.0, 2.0, 0.5]]), False))
            return d.entropy()
        d = E.L.MultivariateNormalDiag(
            E.t(np.float32([0.0, 1.0]), False),
            E.t(np.diag(np.float32([1.0, 2.0])), False))
        return d.entropy()
    return case


def _seq_lod(E):
    return E.P.create_lod_tensor(
        np.arange(12, dtype=np.float32).reshape(6, 2), [[2, 4]], None) \
        if hasattr(E.P, "create_lod_tensor") else None


def _center_case(E):
    x = _x(E, 4, 3)
    lab = E.i([[0], [1], [0], [2]])
    a = E.L.center_loss(x, lab, 3, 0.5)
    b = E.L.center_loss(x, lab, 3, 0.5)
    return a, b


def _crf_case(E):
    em = _x(E, 2, 4, 3)
    lab = E.i(np.random.RandomState(1).randint(0, 3, (2, 4)))
    ln = E.i([4, 3])
    nll, _ = E.L.linear_chain_crf(em, lab, length=ln)
    return nll, E.L.crf_decoding(em, length=ln)


def _nms_case(E):
    boxes = np.asarray([[[0, 0, 1, 1], [0, 0, 1.05, 1.05], [2, 2, 3, 3]]],
                       np.float32)
    scores = np.asarray([[[0.1, 0.2, 0.3], [0.9, 0.8, 0.7]]], np.float32)
    return E.L.multiclass_nms(E.t(boxes, False), E.t(scores, False), 0.05,
                              10, 10)


def _counter_case(E):
    a = E.L.autoincreased_step_counter()
    b = E.L.autoincreased_step_counter()
    return _arr(a).copy(), _arr(b)


def _sel_rows_case(name):
    def case(E):
        return getattr(E.L, name)(_x(E, 3, 2))
    return case


def _print_case(E):
    with contextlib.redirect_stdout(None):
        return E.L.Print(_x(E, 2, 3), message="m")


def _increment_case(E):
    x = E.t(np.float32([1.0]), False)
    y = E.L.increment(x, 2.0, in_place=False)
    E.L.increment(x, 3.0)
    return x, y


def _cmp_cond_case(name):
    def case(E):
        a, b = E.t(np.float32([1.0, 3.0]), False), \
            E.t(np.float32([2.0, 3.0]), False)
        c = E.t(np.asarray([False, False]), False)
        r = getattr(E.L, name)(a, b)
        getattr(E.L, name)(a, b, cond=c)
        return r, c
    return case


def _lr_case(name, *args, **kw):
    def case(E):
        E.L._global_step().value = E.i([5]).value \
            if not E.ref else E.i([5]).value
        return getattr(E.L, name)(*args, **kw)
    return case


def _im(E, seed=0):
    return _x(E, 2, 4, 6, 6, seed=seed)


CASES = {
    # -- basics
    "fc": lambda E: E.L.fc(_x(E, 4, 3, 2), 5, num_flatten_dims=1,
                           act="tanh"),
    "relu": lambda E: E.L.relu(_x(E, 3, 4)),
    "softmax": lambda E: E.L.softmax(_x(E, 3, 4)),
    "matmul": lambda E: E.L.matmul(_x(E, 3, 4), E.f(5, 4, seed=1),
                                   transpose_y=True, alpha=0.5),
    "reduce_mean": lambda E: E.L.reduce_mean(_x(E, 3, 4), dim=1),
    "reduce_sum": lambda E: E.L.reduce_sum(_x(E, 3, 4), dim=0,
                                           keep_dim=True),
    "reduce_max": lambda E: E.L.reduce_max(_x(E, 3, 4), dim=1),
    "reduce_min": lambda E: E.L.reduce_min(_x(E, 3, 4), dim=1),
    "reduce_prod": lambda E: E.L.reduce_prod(E.pos(3, 4), dim=1),
    "reduce_all": lambda E: E.L.reduce_all(E.t(np.asarray(
        [[True, False], [True, True]])), dim=1),
    "reduce_any": lambda E: E.L.reduce_any(E.t(np.asarray(
        [[True, False], [False, False]])), dim=1),
    "cross_entropy": lambda E: E.L.cross_entropy(
        E.L.softmax(_x(E, 4, 5)), E.i([[1], [0], [4], [2]])),
    "softmax_with_cross_entropy": lambda E: E.L.softmax_with_cross_entropy(
        _x(E, 4, 5), E.i([[1], [0], [4], [2]]), return_softmax=True),
    "mean": lambda E: E.L.mean(_x(E, 3, 4)),
    "concat": lambda E: E.L.concat([_x(E, 2, 3), E.f(2, 2, seed=1)],
                                   axis=1),
    "reshape": lambda E: E.L.reshape(_x(E, 2, 6), [3, 4]),
    "transpose": lambda E: E.L.transpose(_x(E, 2, 3, 4), [2, 0, 1]),
    "fill_constant": lambda E: E.L.fill_constant([2, 3], "float32", 1.5),
    "zeros": lambda E: E.L.zeros([2, 3], "int64"),
    "ones": lambda E: E.L.ones([2, 3]),
    "assign": lambda E: (E.L.assign(np.float32([1.0, 2.0])),
                         E.L.assign(_x(E, 3))),
    "cast": lambda E: E.L.cast(_x(E, 3), "float64"),
    "embedding": lambda E: E.L.embedding(E.i([[1, 3], [0, 2]]), [5, 4]),
    "dropout": lambda E: E.L.dropout(_x(E, 3, 4), 0.3, is_test=True),
    "accuracy": lambda E: E.L.accuracy(_x(E, 6, 4), E.i(
        [[0], [1], [2], [3], [0], [1]]), k=2),
    # -- logic
    "logical_and": lambda E: E.L.logical_and(
        E.t(np.asarray([True, False])), E.t(np.asarray([True, True]))),
    "logical_or": lambda E: E.L.logical_or(
        E.t(np.asarray([True, False])), E.t(np.asarray([False, False]))),
    "logical_xor": lambda E: E.L.logical_xor(
        E.t(np.asarray([True, False])), E.t(np.asarray([True, True]))),
    "logical_not": lambda E: E.L.logical_not(
        E.t(np.asarray([True, False]))),
    # -- elementwise
    **{f"elementwise_{k}": (lambda k: lambda E: getattr(
        E.L, f"elementwise_{k}")(E.pos(2, 3, 4), E.pos(3, seed=1),
                                 axis=1))(k)
       for k in ("add", "sub", "mul", "div", "max", "min", "pow")},
    "elementwise_mod": lambda E: E.L.elementwise_mod(
        E.i([[7, 8], [9, 10]]), E.i([3, 4])),
    "elementwise_floordiv": lambda E: E.L.elementwise_floordiv(
        E.i([[7, 8], [9, 10]]), E.i([3, 4])),
    # -- activations
    "log": lambda E: E.L.log(E.pos(3, 4)),
    "pow": lambda E: E.L.pow(E.pos(3, 4), 2.5),
    "selu": lambda E: E.L.selu(_x(E, 3, 4)),
    "elu": lambda E: E.L.elu(_x(E, 3, 4), 0.7),
    "relu6": lambda E: E.L.relu6(_x(E, 3, 4, scale=5.0)),
    "leaky_relu": lambda E: E.L.leaky_relu(_x(E, 3, 4), 0.1),
    "hard_sigmoid": lambda E: E.L.hard_sigmoid(_x(E, 3, 4, scale=3.0)),
    "swish": lambda E: E.L.swish(_x(E, 3, 4), 1.5),
    "hard_swish": lambda E: E.L.hard_swish(_x(E, 3, 4, scale=4.0)),
    "mish": lambda E: E.L.mish(_x(E, 3, 4)),
    "stanh": lambda E: E.L.stanh(_x(E, 3, 4)),
    "brelu": lambda E: E.L.brelu(_x(E, 3, 4, scale=20.0), 1.0, 10.0),
    "soft_relu": lambda E: E.L.soft_relu(_x(E, 3, 4), 2.0),
    "sign": lambda E: E.L.sign(_x(E, 3, 4)),
    "scale": lambda E: (E.L.scale(_x(E, 3), 2.0, 1.0),
                        E.L.scale(E.f(3, seed=1), 2.0, 1.0,
                                  bias_after_scale=False, act="relu")),
    "clip": lambda E: E.L.clip(_x(E, 3, 4), -0.5, 0.5),
    "clip_by_norm": lambda E: E.L.clip_by_norm(_x(E, 3, 4), 1.0),
    "mul": lambda E: E.L.mul(_x(E, 2, 3, 4), E.f(12, 5, seed=1),
                             x_num_col_dims=1),
    # -- shapes
    "split": lambda E: E.L.split(_x(E, 4, 6), [2, 4], dim=1),
    "squeeze": lambda E: E.L.squeeze(_x(E, 3, 1, 4), [1]),
    "unsqueeze": lambda E: E.L.unsqueeze(_x(E, 3, 4), [1]),
    "flatten": lambda E: E.L.flatten(_x(E, 2, 3, 4), axis=2),
    "stack": lambda E: E.L.stack([_x(E, 2, 3), E.f(2, 3, seed=1)], 1),
    "unstack": lambda E: E.L.unstack(_x(E, 2, 3), axis=1),
    "unbind": lambda E: E.L.unbind(_x(E, 2, 3), axis=0),
    "expand": lambda E: E.L.expand(_x(E, 2, 3), [2, 1]),
    "expand_as": lambda E: E.L.expand_as(_x(E, 1, 3),
                                         E.f(4, 3, seed=1, grad=False)),
    "slice": lambda E: E.L.slice(_x(E, 4, 5), [0, 1], [1, 0], [3, 4]),
    "strided_slice": lambda E: E.L.strided_slice(
        _x(E, 4, 6), [0, 1], [0, 1], [4, 6], [2, 2]),
    "shape": lambda E: E.L.shape(_x(E, 2, 3)),
    "rank": lambda E: E.L.rank(_x(E, 2, 3, 4)),
    "size": lambda E: E.L.size(_x(E, 2, 3)),
    "gather": lambda E: E.L.gather(_x(E, 4, 3), E.i([2, 0, 2])),
    "gather_nd": lambda E: E.L.gather_nd(_x(E, 3, 4), E.i([[0, 1],
                                                            [2, 3]])),
    "scatter": lambda E: E.L.scatter(_x(E, 4, 3), E.i([1, 3]),
                                     E.f(2, 3, seed=1)),
    "scatter_nd_add": lambda E: E.L.scatter_nd_add(
        _x(E, 4, 3), E.i([[1], [3], [1]]), E.f(3, 3, seed=1)),
    "scatter_nd": lambda E: E.L.scatter_nd(E.i([[1], [3]]),
                                           _x(E, 2, 3), [4, 3]),
    "where": lambda E: E.L.where(E.t(np.asarray([[True, False],
                                                 [False, True]]))),
    "one_hot": lambda E: E.L.one_hot(E.i([[1], [0], [3]]), 4),
    "topk": lambda E: E.L.topk(_x(E, 3, 5), 2),
    "unique": lambda E: E.L.unique(E.i([2, 3, 3, 1, 5, 3])),
    "unique_with_counts": lambda E: E.L.unique_with_counts(
        E.i([2, 3, 3, 1, 5, 3])),
    "pad": lambda E: E.L.pad(_x(E, 2, 3), [1, 0, 0, 2], 0.5),
    "pad2d": lambda E: E.L.pad2d(_x(E, 1, 2, 3, 3), [1, 0, 2, 1],
                                 pad_value=0.5),
    "pad_constant_like": lambda E: E.L.pad_constant_like(
        E.f(3, 4, grad=False), E.f(2, 3, seed=1), 0.25),
    "crop_tensor": lambda E: E.L.crop_tensor(_x(E, 4, 5), [2, 3], [1, 1]),
    "crop": lambda E: E.L.crop(_x(E, 4, 5), [2, 3], [1, 2]),
    "shard_index": lambda E: E.L.shard_index(E.i([[1], [6], [12]]), 16, 2,
                                             0),
    "sum": lambda E: (E.L.sum([_x(E, 2, 3), E.f(2, 3, seed=1)]),
                      E.L.sum(E.f(2, 3, seed=2))),
    "sums": lambda E: E.L.sums([_x(E, 2, 3), E.f(2, 3, seed=1)]),
    # -- norms, similarity, losses
    "l2_normalize": lambda E: E.L.l2_normalize(_x(E, 3, 4), 1),
    "cos_sim": lambda E: E.L.cos_sim(_x(E, 3, 4), E.f(3, 4, seed=1)),
    "lrn": lambda E: E.L.lrn(_x(E, 2, 6, 3, 3), n=3),
    "smooth_l1": lambda E: E.L.smooth_l1(_x(E, 3, 4), E.f(3, 4, seed=1),
                                         sigma=2.0),
    "label_smooth": lambda E: E.L.label_smooth(
        E.t(np.eye(4, dtype=np.float32)[[0, 2, 1]]), epsilon=0.2),
    "log_loss": lambda E: E.L.log_loss(E.t(np.float32([[0.2], [0.7]])),
                                       E.t(np.float32([[0.0], [1.0]]),
                                           False)),
    "dice_loss": lambda E: E.L.dice_loss(
        E.L.softmax(_x(E, 3, 4)), E.i([[1], [0], [3]])),
    "mean_iou": None,   # see test_mean_iou_counts
    "square_error_cost": lambda E: E.L.square_error_cost(
        _x(E, 3, 2), E.f(3, 2, seed=1)),
    "mse_loss": lambda E: E.L.mse_loss(_x(E, 3, 2), E.f(3, 2, seed=1)),
    "kldiv_loss": lambda E: E.L.kldiv_loss(
        E.L.log(E.L.softmax(_x(E, 3, 4))),
        E.L.softmax(E.f(3, 4, seed=1, grad=False))),
    "huber_loss": lambda E: E.L.huber_loss(_x(E, 3, 2),
                                           E.f(3, 2, seed=1), 0.5),
    "sigmoid_cross_entropy_with_logits":
        lambda E: E.L.sigmoid_cross_entropy_with_logits(
            _x(E, 3, 4), E.t(np.float32([[0, 1, -100, 1]] * 3)),
            normalize=True),
    "rank_loss": lambda E: E.L.rank_loss(E.t(np.float32([[1], [0]])),
                                         _x(E, 2, 1), E.f(2, 1, seed=1)),
    "margin_rank_loss": lambda E: E.L.margin_rank_loss(
        E.t(np.float32([[1], [-1]]), False), _x(E, 2, 1),
        E.f(2, 1, seed=1), 0.2),
    "bpr_loss": lambda E: E.L.bpr_loss(_x(E, 3, 5), E.i([[1], [4], [0]])),
    "hsigmoid": lambda E: E.L.hsigmoid(_x(E, 4, 3), E.i([[0], [2], [5],
                                                          [1]]), 6),
    "warpctc": lambda E: E.L.warpctc(
        E.L.softmax(_x(E, 6, 2, 5)), E.i([[1, 2], [3, 3]], "int32"),
        input_length=E.i([6, 5]), label_length=E.i([2, 2])),
    "edit_distance": lambda E: E.L.edit_distance(
        E.i([[1, 2, 3, 4], [1, 1, 2, 0]]), E.i([[1, 3, 4, 0], [1, 2, 2, 2]]),
        input_length=E.i([4, 3]), label_length=E.i([3, 4])),
    "center_loss": _center_case,
    "npair_loss": lambda E: E.L.npair_loss(_x(E, 4, 3), E.f(4, 3, seed=1),
                                           E.t(np.float32([0, 1, 0, 2]),
                                               False)),
    "sigmoid_focal_loss": lambda E: E.L.sigmoid_focal_loss(
        _x(E, 4, 3), E.i([[0], [1], [3], [2]], "int32"),
        E.i([3], "int32")),
    # -- vision
    "image_resize": lambda E: E.L.image_resize(_im(E), out_shape=[3, 4]),
    "resize_bilinear": lambda E: E.L.resize_bilinear(_im(E),
                                                     out_shape=[4, 4]),
    "resize_nearest": lambda E: E.L.resize_nearest(_im(E),
                                                   out_shape=[3, 3]),
    "resize_trilinear": lambda E: E.L.resize_trilinear(
        _x(E, 1, 2, 3, 4, 4), out_shape=[2, 3, 3]),
    "resize_linear": lambda E: E.L.resize_linear(_x(E, 1, 2, 6),
                                                 out_shape=[4]),
    "image_resize_short": lambda E: E.L.image_resize_short(_im(E), 3),
    "roi_align": lambda E: E.L.roi_align(
        _im(E), E.t(np.float32([[0, 0, 4, 4], [1, 1, 5, 5]]), False), 2, 2,
        rois_num=E.i([1, 1], "int32")),
    "roi_pool": lambda E: E.L.roi_pool(
        _im(E), E.t(np.float32([[0, 0, 4, 4], [1, 1, 5, 5]]), False), 2, 2,
        rois_num=E.i([1, 1], "int32")),
    "grid_sampler": lambda E: E.L.grid_sampler(
        _im(E), E.f(2, 3, 3, 2, seed=1, scale=0.5)),
    "affine_grid": lambda E: E.L.affine_grid(_x(E, 2, 2, 3), [2, 1, 3, 4]),
    "affine_channel": lambda E: E.L.affine_channel(
        _im(E), E.f(4, seed=1), E.f(4, seed=2), act="relu"),
    "pixel_shuffle": lambda E: E.L.pixel_shuffle(_im(E), 2),
    "space_to_depth": lambda E: E.L.space_to_depth(_im(E), 2),
    "shuffle_channel": lambda E: E.L.shuffle_channel(_im(E), 2),
    "temporal_shift": lambda E: E.L.temporal_shift(_x(E, 4, 8, 2, 2), 2),
    "maxout": lambda E: E.L.maxout(_im(E), 2),
    "fsp_matrix": lambda E: E.L.fsp_matrix(_im(E), E.f(2, 3, 6, 6,
                                                        seed=1)),
    "add_position_encoding": lambda E: E.L.add_position_encoding(
        _x(E, 2, 5, 8), 0.5, 2.0),
    "unfold": lambda E: E.L.unfold(_im(E), [2, 2], 2),
    "multiplex": lambda E: E.L.multiplex(
        [_x(E, 3, 4), E.f(3, 4, seed=1)], E.i([[1], [0], [1]], "int32")),
    "deformable_conv": lambda E: E.L.deformable_conv(
        _im(E), E.f(2, 18, 6, 6, seed=1, scale=0.5),
        E.pos(2, 9, 6, 6, seed=2), 3, 3, padding=1),
    "iou_similarity": lambda E: E.L.iou_similarity(
        E.t(np.float32([[0, 0, 2, 2], [1, 1, 3, 3]])),
        E.t(np.float32([[0, 0, 1, 1], [1, 0, 3, 2], [2, 2, 4, 4]]))),
    "box_clip": lambda E: E.L.box_clip(
        E.t(np.float32([[-1, 2, 30, 9], [3, -4, 5, 50]])),
        E.t(np.float32([[20, 25, 2]]), False)),
    "box_coder": lambda E: (
        E.L.box_coder(E.t(np.float32([[0, 0, 2, 2], [1, 1, 4, 3]]), False),
                      [0.1, 0.1, 0.2, 0.2],
                      E.t(np.float32([[0.5, 0.5, 2, 3]]))),
        E.L.box_coder(E.t(np.float32([[0, 0, 2, 2], [1, 1, 4, 3]]), False),
                      E.t(np.float32([[0.1, 0.1, 0.2, 0.2]] * 2), False),
                      _x(E, 3, 2, 4, seed=3), code_type="decode_center_size")),
    "multiclass_nms": _nms_case,
    "prior_box": lambda E: E.L.prior_box(
        _x(E, 1, 2, 3, 3), _x(E, 1, 3, 12, 12, seed=1), [2.0, 4.0], [6.0],
        aspect_ratios=[1.0, 2.0], flip=True, clip=True),
    "anchor_generator": lambda E: E.L.anchor_generator(
        _x(E, 1, 2, 2, 3), [8.0, 16.0], [0.5, 1.0], stride=[4.0, 4.0]),
    "yolo_box": lambda E: E.L.yolo_box(
        _x(E, 1, 14, 2, 2), E.i([[32, 32]], "int32"), [10, 13, 16, 30], 2,
        0.01, 16),
    "yolov3_loss": lambda E: E.L.yolov3_loss(
        _x(E, 2, 14, 2, 2), E.t(np.float32([[[0.3, 0.4, 0.2, 0.3]]] * 2),
                                False),
        E.i([[1], [0]], "int32"), [10, 13, 16, 30], [0, 1], 2, 0.7, 16),
    # -- random: shapes and dtypes
    "uniform_random": lambda E: E.L.uniform_random([3, 4], min=-2.0,
                                                   max=2.0),
    "gaussian_random": lambda E: E.L.gaussian_random([3, 4]),
    "uniform_random_batch_size_like":
        lambda E: E.L.uniform_random_batch_size_like(_x(E, 5, 2), [1, 3]),
    "gaussian_random_batch_size_like":
        lambda E: E.L.gaussian_random_batch_size_like(_x(E, 5, 2), [1, 3]),
    "sampling_id": lambda E: E.L.sampling_id(E.L.softmax(_x(E, 4, 3))),
    "random_crop": lambda E: E.L.random_crop(_x(E, 2, 5, 5), [3, 3]),
    # -- sequence / CRF / decoding
    "linear_chain_crf": _crf_case,
    "crf_decoding": _crf_case,
    "ctc_greedy_decoder": lambda E: E.L.ctc_greedy_decoder(
        _x(E, 2, 7, 4), 3, input_length=E.i([7, 5])),
    "chunk_eval": lambda E: E.L.chunk_eval(
        E.i([[0, 1, 2, 0, 2, 2]]), E.i([[0, 1, 2, 0, 1, 1]]), "IOB", 1),
    "gather_tree": lambda E: E.L.gather_tree(
        E.i([[[2, 5]], [[3, 6]], [[4, 7]]]),
        E.i([[[0, 0]], [[0, 0]], [[1, 0]]])),
    "sequence_pad": lambda E: E.L.sequence_pad(_x(E, 2, 3, 4), 0.0),
    "sequence_unpad": lambda E: E.L.sequence_unpad(_x(E, 2, 4, 3),
                                                   E.i([2, 4])),
    "sequence_pool": lambda E: (E.L.sequence_pool(_x(E, 2, 3, 4), "sum"),
                                E.L.sequence_pool(E.f(2, 3, 4, seed=1),
                                                  "max")),
    "sequence_softmax": lambda E: E.L.sequence_softmax(_x(E, 2, 5)),
    "sequence_first_step": lambda E: E.L.sequence_first_step(
        _x(E, 2, 3, 4)),
    "sequence_last_step": lambda E: E.L.sequence_last_step(
        _x(E, 2, 3, 4)),
    "sequence_reverse": lambda E: E.L.sequence_reverse(_x(E, 2, 3, 4)),
    "sequence_expand": lambda E: E.L.sequence_expand(
        _x(E, 2, 4), E.f(2, 3, 4, seed=1, grad=False)),
    "sequence_expand_as": lambda E: E.L.sequence_expand_as(
        _x(E, 2, 4), E.f(2, 3, 4, seed=1, grad=False)),
    "sequence_concat": lambda E: E.L.sequence_concat(
        [_x(E, 2, 3, 4), E.f(2, 2, 4, seed=1)]),
    "sequence_mask": lambda E: E.L.sequence_mask(E.i([1, 3, 2]), maxlen=4),
    "sequence_reshape": lambda E: E.L.sequence_reshape(_x(E, 2, 4, 6), 3),
    "sequence_enumerate": lambda E: E.L.sequence_enumerate(
        E.i([[1, 2, 3, 4], [5, 6, 7, 8]]), 3),
    "sequence_slice": lambda E: E.L.sequence_slice(
        _x(E, 2, 5, 3), E.i([[1], [0]]), E.i([[2], [3]])),
    "sequence_scatter": lambda E: E.L.sequence_scatter(
        _x(E, 4, 3), E.i([1, 3]), E.f(2, 3, seed=1)),
    "sequence_conv": lambda E: E.L.sequence_conv(_x(E, 2, 5, 4), 3, 3,
                                                 act="tanh"),
    # -- param-creating
    "conv2d": lambda E: E.L.conv2d(_im(E), 3, 3, padding=1, act="relu"),
    "conv3d": lambda E: E.L.conv3d(_x(E, 1, 2, 4, 4, 4), 3, 3, padding=1),
    "conv2d_transpose": lambda E: E.L.conv2d_transpose(
        _im(E), 3, filter_size=3, stride=2),
    "conv3d_transpose": lambda E: E.L.conv3d_transpose(
        _x(E, 1, 2, 3, 3, 3), 2, filter_size=2, stride=2),
    "batch_norm": lambda E: E.L.batch_norm(_im(E), act="relu"),
    "inplace_abn": lambda E: E.L.inplace_abn(_im(E)),
    "instance_norm": lambda E: E.L.instance_norm(_im(E)),
    "layer_norm": lambda E: E.L.layer_norm(_x(E, 3, 4, 5),
                                           begin_norm_axis=2),
    "group_norm": lambda E: E.L.group_norm(_im(E), 2, act="tanh"),
    "spectral_norm": lambda E: E.L.spectral_norm(_x(E, 4, 6), 0, 2),
    "prelu": lambda E: (E.L.prelu(_x(E, 2, 3, 4), "channel"),
                        E.L.prelu(E.f(2, 3, seed=1), "all")),
    "bilinear_tensor_product": lambda E: E.L.bilinear_tensor_product(
        _x(E, 5, 3), E.f(5, 4, seed=1), 6, act="tanh"),
    "create_parameter": lambda E: E.L.create_parameter([3, 4], "float32",
                                                       name="cp") * 2.0,
    "create_global_var": lambda E: E.L.create_global_var(
        [2, 3], 1.5, "float32", name="gv"),
    "lstm": lambda E: E.L.lstm(_x(E, 2, 5, 4), E.P.zeros([1, 2, 6]),
                               E.P.zeros([1, 2, 6]), 5, 6, 1),
    "dynamic_gru": lambda E: E.L.dynamic_gru(_x(E, 2, 5, 4), 6),
    "gru_unit": lambda E: E.L.gru_unit(_x(E, 2, 4), E.f(2, 6, seed=1), 18),
    "lstm_unit": lambda E: E.L.lstm_unit(_x(E, 2, 4), E.f(2, 6, seed=1),
                                         E.f(2, 6, seed=2)),
    # -- pooling
    "pool2d": lambda E: (E.L.pool2d(_im(E), 2, "max", 2),
                         E.L.pool2d(E.f(2, 3, 5, 5, seed=1), 3, "avg", 2,
                                    1, ceil_mode=True),
                         E.L.pool2d(E.f(2, 3, 4, 4, seed=2),
                                    global_pooling=True)),
    "pool3d": lambda E: (E.L.pool3d(_x(E, 1, 2, 4, 4, 4), 2, "max", 2),
                         E.L.pool3d(E.f(1, 2, 4, 4, 4, seed=1), 2, "avg",
                                    2)),
    "adaptive_pool2d": lambda E: (E.L.adaptive_pool2d(_im(E), 3),
                                  E.L.adaptive_pool2d(E.f(2, 3, 6, 6,
                                                          seed=1), 2,
                                                      "avg")),
    "adaptive_pool3d": lambda E: E.L.adaptive_pool3d(
        _x(E, 1, 2, 4, 4, 4), 2, "avg"),
    # -- misc
    "autoincreased_step_counter": _counter_case,
    "lod_reset": lambda E: E.L.lod_reset(_x(E, 2, 3)),
    "lod_append": lambda E: E.L.lod_append(_x(E, 2, 3), 1),
    "py_func": _py_func_case,
    "merge_selected_rows": _sel_rows_case("merge_selected_rows"),
    "get_tensor_from_selected_rows":
        _sel_rows_case("get_tensor_from_selected_rows"),
    "create_tensor": lambda E: E.L.create_tensor("float32"),
    "tensor_array_to_tensor": lambda E: E.L.tensor_array_to_tensor(
        [_x(E, 2, 3), E.f(2, 3, seed=1)], axis=1, use_stack=True),
    "fill_constant_batch_size_like":
        lambda E: E.L.fill_constant_batch_size_like(_x(E, 5, 2), [1, 3],
                                                    "float32", 2.5),
    "argmin": lambda E: E.L.argmin(_x(E, 3, 4), axis=1),
    "argmax": lambda E: E.L.argmax(_x(E, 3, 4), axis=1),
    "argsort": lambda E: E.L.argsort(_x(E, 3, 4), descending=True),
    "reverse": lambda E: E.L.reverse(_x(E, 3, 4), [1]),
    "has_inf": lambda E: E.L.has_inf(E.t(np.float32([1.0, np.inf]))),
    "has_nan": lambda E: E.L.has_nan(E.t(np.float32([1.0, 2.0]))),
    "isfinite": lambda E: E.L.isfinite(E.t(np.float32([1.0, np.nan]))),
    "range": lambda E: E.L.range(1, 10, 3, "int64"),
    "linspace": lambda E: E.L.linspace(0.0, 1.0, 5),
    "zeros_like": lambda E: E.L.zeros_like(_x(E, 2, 3)),
    "ones_like": lambda E: E.L.ones_like(_x(E, 2, 3)),
    "diag": lambda E: E.L.diag(E.t(np.float32([1.0, 2.0, 3.0]))),
    "eye": lambda E: E.L.eye(3, 2, batch_shape=[2]),
    "triu": lambda E: E.L.triu(_x(E, 3, 4), 1),
    # -- control flow (eager) and arrays
    "cond": _cond_case,
    "while_loop": _while_case,
    "case": lambda E: E.L.case(
        [(E.t(np.asarray(False)), lambda: E.L.fill_constant([1], "float32",
                                                             1.0)),
         (E.t(np.asarray(True)), lambda: E.L.fill_constant([1], "float32",
                                                            2.0))],
        default=lambda: E.L.fill_constant([1], "float32", 3.0)),
    "switch_case": lambda E: E.L.switch_case(
        E.i([1]), {0: lambda: E.L.fill_constant([1], "float32", 1.0),
                   1: lambda: E.L.fill_constant([1], "float32", 2.0)},
        default=lambda: E.L.fill_constant([1], "float32", 3.0)),
    "increment": _increment_case,
    **{k: _cmp_cond_case(k) for k in ("less_than", "less_equal",
                                      "greater_than", "greater_equal",
                                      "equal", "not_equal")},
    "create_array": _array_case,
    "array_write": _array_case,
    "array_read": _array_case,
    "array_length": _array_case,
    "is_empty": lambda E: (E.L.is_empty(_x(E, 2, 3)),
                           E.L.is_empty(E.t(np.zeros((0, 3),
                                                     np.float32)))),
    "Print": _print_case,
    "Assert": lambda E: E.L.Assert(E.t(np.asarray([True, True]))),
    "While": _while_class_case,
    "StaticRNN": _static_rnn_case,
    "data": _data_case,
    "load": _load_case,
    "clear_layer_cache": lambda E: (E.L.fc(_x(E, 2, 3), 2) is not None,
                                    E.L.clear_layer_cache(),
                                    len(E.L._layer_cache)),
    # -- rnn
    "RNNCell": _cell_case("GRUCell"),
    "GRUCell": _cell_case("GRUCell"),
    "LSTMCell": _cell_case("LSTMCell"),
    "rnn": _rnn_case,
    "birnn": _birnn_case,
    "Decoder": _decoder_case,
    "BeamSearchDecoder": _beam_case,
    "dynamic_decode": _beam_case,
    # -- metrics
    "auc": lambda E: E.L.auc(
        E.t(np.float32([[0.2, 0.8], [0.9, 0.1], [0.3, 0.7], [0.6, 0.4]])),
        E.i([[1], [0], [0], [1]])),
    # -- learning-rate decays at global step 5
    "exponential_decay": _lr_case("exponential_decay", 0.1, 2, 0.5,
                                  staircase=True),
    "natural_exp_decay": _lr_case("natural_exp_decay", 0.1, 2, 0.5),
    "inverse_time_decay": _lr_case("inverse_time_decay", 0.1, 2, 0.5),
    "polynomial_decay": _lr_case("polynomial_decay", 0.1, 8, 0.01, 2.0,
                                 cycle=True),
    "piecewise_decay": _lr_case("piecewise_decay", [3, 8], [0.1, 0.05,
                                                            0.01]),
    "noam_decay": _lr_case("noam_decay", 64, 10),
    "cosine_decay": _lr_case("cosine_decay", 0.1, 2, 10),
    "linear_lr_warmup": _lr_case("linear_lr_warmup", 0.1, 10, 0.0, 0.1),
    # -- distributions
    **{k: _dist_case(k) for k in ("Uniform", "Normal", "Categorical",
                                  "MultivariateNormalDiag")},
    "Tensor": lambda E: E.L.Tensor(np.float32([1.0, 2.0])),
}

PARAMS = {"fc", "embedding", "conv2d", "conv3d", "conv2d_transpose",
          "conv3d_transpose", "batch_norm", "inplace_abn", "instance_norm",
          "layer_norm", "group_norm", "spectral_norm", "prelu",
          "bilinear_tensor_product", "deformable_conv", "linear_chain_crf",
          "crf_decoding", "create_parameter", "create_global_var",
          "hsigmoid", "sequence_conv", "lstm", "dynamic_gru", "gru_unit",
          "lstm_unit"}
RANDOM = {"uniform_random", "gaussian_random",
          "uniform_random_batch_size_like",
          "gaussian_random_batch_size_like", "sampling_id", "random_crop"}
MODULES = {"np": np, "creation": "ops.creation", "linalg": "ops.linalg",
           "manipulation": "ops.manipulation", "math_ops": "ops.math",
           "nn_ops": "ops.nn_ops", "reduction": "ops.reduction"}


def _public(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_"))


def _stubs():
    return [n for n in _public(RL)
            if "stub" in getattr(getattr(RL, n), "__qualname__", "")]


def test_same_public_names():
    assert _public(PL) == _public(RL)


def test_every_public_name_has_a_case():
    covered = set(CASES) | set(MODULES) | set(_stubs())
    assert sorted(set(_public(RL)) - covered) == []


# Where the reference raises TypeError the port works (ROADMAP
# divergences) and is held to numpy or to the reference's own op called
# as it should have been: its crop_tensor and random_crop call ``range``,
# which the module's ``range`` layer shadows; its ``paddle.slice`` (under
# slice, strided_slice and the crops) calls ``slice``, which its
# manipulation module's ``slice`` shadows; its roi_align passes
# ``rois_num=`` to a vision.ops.roi_align that does not take it.
def _ref_roi(x, pool):
    x = R.to_tensor(x)
    boxes = R.to_tensor(np.float32([[0, 0, 4, 4], [1, 1, 5, 5]]))
    num = R.to_tensor(np.asarray([1, 1], np.int32))
    return np.asarray(R.vision.ops.roi_align(x, boxes, num, (2, 2)).numpy())


_X45 = np.random.RandomState(0).randn(4, 5).astype(np.float32)
REF_RAISES = {
    "crop_tensor": lambda: _X45[1:3, 1:4],
    "crop": lambda: _X45[1:3, 2:5],
    "random_crop": None,
    "slice": lambda: _X45[1:3, 0:4],
    "strided_slice": lambda: np.random.RandomState(0).randn(4, 6).astype(
        np.float32)[0:4:2, 1:6:2],
    "roi_align": lambda: _ref_roi(
        np.random.RandomState(0).randn(2, 4, 6, 6).astype(np.float32), 0),
    "roi_pool": lambda: _ref_roi(
        np.random.RandomState(0).randn(2, 4, 6, 6).astype(np.float32), 1),
}
# the reference's warpctc loss takes no grad (its ctc_loss stops it); the
# port's does, and the port's grads are only checked to be finite
NO_REF_GRAD = {"warpctc"}


def _steps(name):
    """The runs of a case, in order: with parameters, one call in each
    package to make them, then the compared calls."""
    first = [(R, RL, "make"), (P, PL, "make")] if name in PARAMS else []
    return first + [(R, RL, "ref"), (P, PL, "port")]


@pytest.mark.parametrize("name", sorted(n for n in CASES
                                        if CASES[n] is not None))
def test_layer_matches_reference(name):
    fn = CASES[name]
    mods = []
    R.seed(0)
    P.seed(0)
    _reset(RL)
    _reset(PL)
    envs, outs, state = {}, {}, None
    for pkg, layers, tag in _steps(name):
        E = Env(pkg, layers, mods if tag != "make" else [])
        if tag == "ref" and name in REF_RAISES:
            with pytest.raises(TypeError):
                fn(E)
            continue
        out = fn(E)     # one line: the same call site for every run
        if tag == "make":
            if pkg is R:
                state = convert.layer_cache_state(RL._layer_cache)
            else:
                convert.load_layer_cache(state)
            continue
        envs[tag], outs[tag] = E, out
    if name in REF_RAISES:
        got = outs["port"]
        if REF_RAISES[name] is None:
            assert tuple(got.shape) == (2, 3, 3)
        else:
            _close(got, REF_RAISES[name](), name)
        return
    want, got = outs["ref"], outs["port"]
    wf, gf = _flat(want), _flat(got)
    assert len(wf) == len(gf), (name, len(wf), len(gf))
    for k, (w, g) in enumerate(zip(wf, gf)):
        if name in RANDOM:
            w, g = np.asarray(_arr(w)), np.asarray(_arr(g))
            assert w.shape == g.shape and w.dtype.kind == g.dtype.kind
        else:
            _close(g, w, f"{name} output {k}")
    if name in RANDOM:
        return
    if name in NO_REF_GRAD:
        assert all(np.isfinite(g).all() for g in _grads(envs["port"], got)
                   if g is not None)
        return
    wg, gg = _grads(envs["ref"], want), _grads(envs["port"], got)
    assert len(wg) == len(gg), (name, len(wg), len(gg))
    for k, (w, g) in enumerate(zip(wg, gg)):
        _close(g, w, f"{name} grad {k}")
    if name in PARAMS:
        ws = convert.layer_cache_state(RL._layer_cache)
        gs = convert.layer_cache_state(PL._layer_cache)
        assert list(ws) == list(gs)
        for key in ws:
            for pn, arr in ws[key].items():
                _close(gs[key][pn], arr, f"{name} cache {key} {pn}")


@pytest.mark.parametrize("name", _stubs())
def test_descoped_stub_raises(name):
    from paddle_tpu.core.errors import UnimplementedError as RefErr
    from paddle_tpu_torch.core.errors import UnimplementedError as PortErr
    with pytest.raises(RefErr):
        getattr(RL, name)()
    with pytest.raises(PortErr) as e:
        getattr(PL, name)()
    assert name in str(e.value) and "TPU" not in str(e.value)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_namespace_module_is_the_packages_own(name):
    want = MODULES[name]
    got = getattr(PL, name)
    if want is np:
        assert got is np
    else:
        assert inspect.ismodule(got)
        assert got.__name__ == f"paddle_tpu_torch.{want}"


def test_mean_iou_counts():
    pred = np.asarray([0, 1, 1, 2, 2, 0], np.int64)
    lab = np.asarray([0, 1, 2, 2, 1, 1], np.int64)
    miou, wrong, correct = PL.mean_iou(P.to_tensor(pred),
                                       P.to_tensor(lab), 3)
    want_c = np.asarray([1, 1, 1])
    want_w = np.asarray([1, 3, 2])   # pred-side plus label-side misses
    np.testing.assert_array_equal(correct.numpy(), want_c)
    np.testing.assert_array_equal(wrong.numpy(), want_w)
    np.testing.assert_allclose(float(miou.numpy()),
                               np.mean(want_c / (want_c + want_w)),
                               rtol=1e-6)
    with pytest.raises(ImportError):
        RL.mean_iou(R.to_tensor(pred), R.to_tensor(lab), 3)


def test_reuse_key_skips_every_framework_frame():
    """A layer made through a call that passes the framework's own
    frames (jit/, core/lazy.py and the rest of the package) keys on the
    user's frames only: the same user line reuses its parameters."""
    x = P.to_tensor(np.ones((2, 3), np.float32))
    PL.clear_layer_cache()
    outs = [PL.fc(x, 2) for _ in range(2)]
    assert len(PL._layer_cache) == 1
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())
    assert PL._PHASE_DIRS[0].endswith("jit/")
    assert PL._PHASE_DIRS[1].endswith("core/lazy.py")


def test_fluid_namespace():
    """fluid's top level: the places (``CUDAPlace(0)`` is ``cuda:0``), the
    static names, ``CompiledProgram`` an identity wrapper, dygraph's
    guard and to_variable; ``is_compiled_with_cuda`` the port's own
    (True where torch sees a card; the reference's says False)."""
    from paddle_tpu_torch.core.device import resolve_device
    assert repr(P.fluid.CUDAPlace(0)) == "Place(gpu:0)"
    if torch.cuda.is_available():
        assert str(resolve_device(P.fluid.CUDAPlace(0))) == "cuda:0"
    assert str(resolve_device(P.fluid.CPUPlace())) == "cpu"
    assert P.fluid.is_compiled_with_cuda() == torch.cuda.is_available()
    assert R.fluid.is_compiled_with_cuda() is False
    assert P.fluid.Executor is P.static.Executor
    assert P.fluid.layers is PL and P.fluid.optimizer is P.optimizer
    prog = P.static.Program()
    assert P.fluid.CompiledProgram(prog).with_data_parallel() \
        ._program is prog
    with P.fluid.dygraph.guard(P.fluid.CPUPlace()):
        v = P.fluid.dygraph.to_variable(np.ones(3, np.float32))
    assert isinstance(v, P.Tensor) and v.shape == [3]
    assert P.fluid.dygraph.enabled()
    mine = {n for n in dir(P.fluid) if not n.startswith("_")}
    assert mine - {"convert"} \
        == {n for n in dir(R.fluid) if not n.startswith("_")}


@pytest.mark.parametrize("name", ["temporal_shift", "fsp_matrix",
                                  "add_position_encoding", "multiplex",
                                  "bpr_loss"])
def test_registered_ops_record_into_a_program(name):
    """The ops the reference registers with ``register_op`` are the
    port's registered ops too: on a static Variable each appends one
    record of its name, and the program's run gives the eager value."""
    rs = np.random.RandomState(4)
    arrays = {
        "temporal_shift": [rs.randn(4, 8, 2, 2)],
        "fsp_matrix": [rs.randn(2, 3, 4, 4), rs.randn(2, 5, 4, 4)],
        "add_position_encoding": [rs.randn(2, 5, 8)],
        "multiplex": [rs.randn(3, 4), rs.randn(3, 4)],
        "bpr_loss": [rs.randn(3, 5)],
    }[name]
    arrays = [a.astype(np.float32) for a in arrays]
    extra = {"multiplex": np.asarray([[1], [0], [1]], np.int32),
             "bpr_loss": np.asarray([[1], [4], [0]], np.int64)}.get(name)

    def call(xs, ex):
        if name == "temporal_shift":
            return PL.temporal_shift(xs[0], 2)
        if name == "fsp_matrix":
            return PL.fsp_matrix(*xs)
        if name == "add_position_encoding":
            return PL.add_position_encoding(xs[0], 0.5, 2.0)
        if name == "multiplex":
            return PL.multiplex(list(xs), ex)
        return PL.bpr_loss(xs[0], ex)

    want = call([P.to_tensor(a) for a in arrays],
                None if extra is None else P.to_tensor(extra)).numpy()
    P.enable_static()
    try:
        main = P.static.Program()
        with P.static.program_guard(main):
            xs = [P.static.data(f"x{i}", list(a.shape), "float32")
                  for i, a in enumerate(arrays)]
            ex = None if extra is None else P.static.data(
                "ex", list(extra.shape), str(extra.dtype))
            out = call(xs, ex)
    finally:
        P.disable_static()
    assert [r.type for r in main.ops] == [name]
    feed = {f"x{i}": a for i, a in enumerate(arrays)}
    if extra is not None:
        feed["ex"] = extra
    got, = P.static.Executor(P.CPUPlace()).run(main, feed=feed,
                                                fetch_list=[out])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
