"""paddle_tpu_torch's static graph (``static/program.py``, ``static/nn.py``,
``Optimizer.minimize`` of a Variable) against the JAX package's on the
CPU: ``tests/test_static_graph.py``'s scenarios and
``test_book_e2e.py::TestFitALine::test_static_mode_matches``, each built
and run through both packages with the reference's initial weights
carried into the port's program (its persistables, in the order both
programs register them) and the same seeded feeds.

Also: a small GPT as a static program (the reference's
``GPTForCausalLM``, 2 layers, hidden 64, dropout 0, logits into
``F.cross_entropy``, against the port's surface GPT of
``tests/test_torch_paddle_lm.py``, weights carried by name) over three
``AdamW.minimize`` steps; and program files across the packages, both
ways (``save_inference_model`` in one, ``load_inference_model`` and
``Executor.run`` in the other), with the reference's "unknown op" error
for an op the port does not register.

Losses, fetches and grads within rtol 1e-5 (atol 1e-6 where they cross
zero); the fluid.layers forwards (``static.nn.conv2d`` and the others)
resolve to ``fluid.layers`` (their values are held to the reference's
in tests/test_torch_fluid_layers.py).
"""
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod

RTOL = 1e-5
PACKAGES = (ref, paddle)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


class _Static:
    """``enable_static()`` and a fresh ``Program`` under
    ``program_guard`` in package ``P``, for a ``with`` block."""

    def __init__(self, P):
        self.P = P

    def __enter__(self):
        self.P.enable_static()
        self.prog = self.P.static.Program()
        self.guard = self.P.static.program_guard(self.prog)
        self.guard.__enter__()
        return self.prog

    def __exit__(self, *exc):
        self.guard.__exit__(*exc)
        self.P.disable_static()
        return False


def _trainable(prog):
    """A program's trainable persistables, in order (the reference's also
    hold its optimizer's recorded state; the port's optimizer keeps its
    own)."""
    return [t for t in prog.persist.values() if not t.stop_gradient]


def _carry(ref_prog, port_prog):
    """The reference program's parameters into the port's, in order."""
    src = [np.asarray(t.numpy()) for t in _trainable(ref_prog)]
    dst = _trainable(port_prog)
    assert len(src) == len(dst)
    for a, t in zip(src, dst):
        assert tuple(a.shape) == tuple(t.shape)
        t.set_value(a)


def _both(build, run):
    """``build(P)`` in each package's static mode -> (prog, handles);
    the port's persistables take the reference's values; ``run(P, prog,
    handles)`` in each -> outputs, which must agree."""
    built = []
    for P in PACKAGES:
        with _Static(P) as prog:
            handles = build(P)
        built.append((prog, handles))
    _carry(built[0][0], built[1][0])
    outs = [run(P, prog, h) for P, (prog, h) in zip(PACKAGES, built)]
    for a, b in zip(*outs):
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64), rtol=RTOL,
                                   atol=1e-6)
    return outs, built


def test_static_linear_regression_trains():
    def build(P):
        x = P.static.data("x", [None, 13], "float32")
        y = P.static.data("y", [None, 1], "float32")
        pred = P.static.nn.fc(x, 1, name="lr_fc")
        loss = P.mean(P.square(pred - y))
        P.optimizer.SGD(learning_rate=0.05).minimize(loss)
        return loss

    def run(P, prog, loss):
        exe = P.static.Executor()
        exe.run(P.static.default_startup_program())
        rs = np.random.RandomState(0)
        w_true = rs.randn(13, 1).astype("float32")
        losses = []
        for _ in range(30):
            xb = rs.randn(32, 13).astype("float32")
            out, = exe.run(prog, feed={"x": xb, "y": xb @ w_true},
                           fetch_list=[loss])
            losses.append(float(out))
        return losses
    (_, losses), _ = _both(build, run)
    assert losses[-1] < losses[0] * 0.5


def test_static_mlp_adam_and_intermediate_fetch():
    def build(P):
        x = P.static.data("x", [None, 8], "float32")
        y = P.static.data("y", [None], "int64")
        h = P.static.nn.fc(x, 16, activation="relu", name="h")
        logits = P.static.nn.fc(h, 4, name="out")
        loss = P.mean(P.nn.functional.cross_entropy(logits, y))
        P.optimizer.Adam(learning_rate=0.05).minimize(loss)
        return loss, h

    def run(P, prog, hs):
        exe = P.static.Executor()
        rs = np.random.RandomState(1)
        xb = rs.randn(16, 8).astype("float32")
        yb = rs.randint(0, 4, (16,)).astype("int64")
        out = []
        for _ in range(10):
            lv, hv = exe.run(prog, feed={"x": xb, "y": yb},
                             fetch_list=list(hs))
            out.append(float(lv))
        assert hv.shape == (16, 16)
        hidden.append(hv)
        return out

    hidden = []
    (_, got), _ = _both(build, run)
    assert got[9] < got[0]
    # the fetched hidden layer after 10 Adam steps: Adam divides each
    # grad by its own size, so float-order noise in a near-zero grad
    # moves a weight a full step either way; held within 1e-5 of the
    # largest activation
    top = np.abs(hidden[0]).max()
    assert np.abs(hidden[1] - hidden[0]).max() <= 1e-5 * top


@pytest.mark.parametrize("P", PACKAGES, ids=["reference", "port"])
def test_program_is_introspectable_and_editable(P):
    with _Static(P) as prog:
        x = P.static.data("x", [None, 4], "float32")
        a = P.scale(x, 2.0)
        P.add(a, a)
        ops = prog.global_block().ops
        assert len(ops) == 2
        assert ops[0].type == "scale" and ops[1].type == "elementwise_add"
        assert a.name in ops[0].output_names()
        assert "x" in ops[0].input_names()
        assert "scale" in prog.to_string()
        del prog.ops[1]
        out, = P.static.Executor().run(
            prog, feed={"x": np.ones((2, 4), np.float32)}, fetch_list=[a])
    np.testing.assert_allclose(out, 2 * np.ones((2, 4)), rtol=RTOL)


def test_append_backward_explicit():
    def build(P):
        x = P.static.data("x", [None, 3], "float32")
        loss = P.mean(P.nn.Linear(3, 1)(x))
        pg = P.static.append_backward(loss)
        assert len(pg) == 2
        assert all(g.name.endswith("@GRAD") for _, g in pg)
        return [g for _, g in pg]

    def run(P, prog, grads):
        return P.static.Executor().run(
            prog, feed={"x": np.arange(12, dtype=np.float32).reshape(4, 3)},
            fetch_list=grads)
    (_, got), _ = _both(build, run)
    np.testing.assert_allclose(got[0].ravel(), [4.5, 5.5, 6.5], rtol=RTOL)
    np.testing.assert_allclose(got[1], [1.0], rtol=RTOL)


def test_clone_for_test_drops_updates():
    def build(P):
        x = P.static.data("x", [None, 2], "float32")
        pred = P.static.nn.fc(x, 1, name="c")
        loss = P.mean(P.square(pred))
        test_prog = P.static.default_main_program()  # replaced below
        test_prog = P.static.program.building_program().clone(
            for_test=True)
        P.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return test_prog, pred, loss

    def run(P, prog, h):
        test_prog, pred, loss = h
        assert len(prog.ops) > len(test_prog.ops)
        exe = P.static.Executor()
        xb = np.ones((4, 2), np.float32)
        before, = exe.run(test_prog, feed={"x": xb}, fetch_list=[pred])
        again, = exe.run(test_prog, feed={"x": xb}, fetch_list=[pred])
        np.testing.assert_allclose(before, again)
        l1, = exe.run(prog, feed={"x": xb}, fetch_list=[loss])
        l2, = exe.run(prog, feed={"x": xb}, fetch_list=[loss])
        assert float(l2) < float(l1)
        return [before, l1, l2]
    _both(build, run)


def test_static_grad_clip_records():
    def build(P):
        x = P.static.data("x", [None, 4], "float32")
        pred = P.static.nn.fc(x, 1, name="clip_fc")
        loss = P.mean(P.square(pred))
        P.optimizer.SGD(learning_rate=0.1,
                        grad_clip=P.nn.ClipGradByGlobalNorm(0.01)
                        ).minimize(loss)
        return loss

    def run(P, prog, loss):
        exe = P.static.Executor()
        xb = np.full((4, 4), 10.0, np.float32)
        return [float(exe.run(prog, feed={"x": xb}, fetch_list=[loss])[0])
                for _ in range(3)]
    (_, got), _ = _both(build, run)
    assert got[0] > got[1] > 0.5 * got[0]


@pytest.mark.parametrize("P", PACKAGES, ids=["reference", "port"])
def test_eager_unaffected_after_static_session(P):
    P.enable_static()
    P.disable_static()
    t = P.to_tensor(np.ones((2, 2), np.float32))
    np.testing.assert_allclose((t * 3).numpy(), 3 * np.ones((2, 2)))


def test_static_sparse_embedding_records_dense():
    def build(P):
        ids = P.static.data("ids", [None, 4], "int64")
        out = P.nn.Embedding(10, 4, sparse=True)(ids)
        loss = P.mean(P.square(out))
        P.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return loss

    def run(P, prog, loss):
        exe = P.static.Executor()
        xb = np.random.RandomState(0).randint(0, 10, (8, 4)).astype("int64")
        return [float(exe.run(prog, feed={"ids": xb}, fetch_list=[loss])[0])
                for _ in range(3)]
    (_, got), _ = _both(build, run)
    assert got[1] < got[0]


@pytest.mark.parametrize("P", PACKAGES, ids=["reference", "port"])
def test_unnamed_fc_creates_fresh_params(P):
    with _Static(P) as prog:
        x = P.static.data("x", [None, 8], "float32")
        P.static.nn.fc(P.static.nn.fc(x, 8), 8)
    assert len(prog.persist) == 4


@pytest.mark.parametrize("P", PACKAGES, ids=["reference", "port"])
def test_named_fc_not_shared_across_programs(P):
    P.enable_static()
    try:
        p1, p2 = P.static.Program(), P.static.Program()
        for p in (p1, p2):
            with P.static.program_guard(p):
                x = P.static.data("x", [None, 3], "float32")
                P.static.nn.fc(x, 1, name="shared")
        assert not ({id(t) for t in p1.persist.values()}
                    & {id(t) for t in p2.persist.values()})
    finally:
        P.disable_static()


@pytest.mark.parametrize("P", PACKAGES, ids=["reference", "port"])
def test_clone_for_test_keeps_writeback_op_outputs(P):
    with _Static(P) as prog:
        x = P.static.data("x", [None, 4], "float32")
        stat = P.Tensor(np.zeros((), np.float32), name="running_stat",
                        persistable=True)
        m = P.mean(x)
        stat.value = m.value   # records the write-back
        out = x - m
        test_prog = prog.clone(for_test=True)
        exe = P.static.Executor()
        o, = exe.run(test_prog, feed={"x": np.ones((2, 4), np.float32)},
                     fetch_list=[out])
        np.testing.assert_allclose(o, np.zeros((2, 4)), atol=1e-6)
        np.testing.assert_allclose(np.asarray(stat.numpy()), 0.0)
        # the training program does write it
        exe.run(prog, feed={"x": np.full((2, 4), 3.0, np.float32)},
                fetch_list=[out])
        np.testing.assert_allclose(np.asarray(stat.numpy()), 3.0)


@pytest.mark.parametrize("P", PACKAGES, ids=["reference", "port"])
def test_executor_cache_invalidated_on_attr_edit(P):
    with _Static(P) as prog:
        x = P.static.data("x", [None, 2], "float32")
        a = P.scale(x, 2.0)
        exe = P.static.Executor()
        xb = np.ones((1, 2), np.float32)
        o1, = exe.run(prog, feed={"x": xb}, fetch_list=[a])
        prog.ops[0].attrs["scale"] = 5.0
        o2, = exe.run(prog, feed={"x": xb}, fetch_list=[a])
    np.testing.assert_allclose(o1, 2.0 * xb)
    np.testing.assert_allclose(o2, 5.0 * xb)


def _served(P):
    x = P.static.data("x", [None, 6], "float32")
    h = P.static.nn.fc(x, 12, activation="relu", name="s1")
    pred = P.static.nn.fc(h, 3, name="s2")
    loss = P.mean(P.square(pred))
    P.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return x, pred, loss


def test_save_load_inference_model(tmp_path):
    xb = np.random.RandomState(0).randn(4, 6).astype("float32")

    def run(P, prog, h):
        x, pred, loss = h
        exe = P.static.Executor()
        for _ in range(3):
            exe.run(prog, feed={"x": xb}, fetch_list=[loss])
        expect, = exe.run(prog.clone(for_test=True), feed={"x": xb},
                          fetch_list=[pred])
        path = str(tmp_path / f"served_{P.__name__}")
        P.static.save_inference_model(path, [x], [pred], exe, program=prog)
        prog2, feeds, fetches = P.static.load_inference_model(path, exe)
        assert feeds == ["x"] and [f.name for f in fetches] == [pred.name]
        assert not ({id(t) for t in prog2.persist.values()}
                    & {id(t) for t in prog.persist.values()})
        got, = P.static.Executor().run(prog2, feed={"x": xb},
                                       fetch_list=fetches)
        again, = P.static.Executor().run(prog2, feed={"x": xb},
                                         fetch_list=fetches)
        np.testing.assert_allclose(got, expect, rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(got, again)
        return [expect]
    _both(_served, run)


def test_static_amp_autocast_records():
    def build(P):
        x = P.static.data("x", [None, 8], "float32")
        with P.amp.auto_cast(level="O1", dtype="bfloat16"):
            h = P.static.nn.fc(x, 16, name="amp_fc")
        loss = P.mean(P.square(h))
        P.optimizer.SGD(learning_rate=0.05).minimize(loss)
        prog = P.static.program.building_program()
        casts = {r.type: getattr(r, "cast", None) for r in prog.ops
                 if hasattr(r, "cast")}
        assert any(c is not None for c in casts.values()), casts
        assert casts.get("reduce_mean") is None
        return h, loss

    def run(P, prog, h):
        exe = P.static.Executor()
        xb = np.random.RandomState(0).randn(8, 8).astype("float32")
        hv, l1 = exe.run(prog, feed={"x": xb}, fetch_list=list(h),
                         return_numpy=False)
        assert hv.dtype.name == "bfloat16"
        l2, = exe.run(prog, feed={"x": xb}, fetch_list=[h[1]])
        assert float(l2) < float(l1.numpy())
        return [np.asarray(hv.numpy(), np.float32), float(l1.numpy()),
                float(l2)]
    _both(build, run)


def test_static_nn_fc_flattens_conv_output():
    """The reference's fc over a conv2d's feature map, in both packages
    (static.nn.conv2d forwards to fluid.layers)."""
    ref.enable_static()
    try:
        main = ref.static.Program()
        with ref.static.program_guard(main):
            x = ref.static.data("x", [None, 3, 8, 8], "float32")
            h = ref.static.nn.conv2d(x, 4, 3, padding=1, act="relu")
            out = ref.static.nn.fc(h, 2)
        (o,) = ref.static.Executor().run(
            main, feed={"x": np.ones((5, 3, 8, 8), np.float32)},
            fetch_list=[out])
        assert o.shape == (5, 2)
    finally:
        ref.disable_static()
    paddle.enable_static()
    try:
        main = paddle.static.Program()
        with paddle.static.program_guard(main):
            x = paddle.static.data("x", [None, 3, 8, 8], "float32")
            h = paddle.static.nn.conv2d(x, 4, 3, padding=1, act="relu")
            out = paddle.static.nn.fc(h, 2)
            assert out.shape[-1] == 2
            (o,) = paddle.static.Executor(paddle.CPUPlace()).run(
                main,
                feed={"x": np.ones((5, 3, 8, 8), np.float32)},
                fetch_list=[out])
        assert o.shape == (5, 2)
    finally:
        paddle.disable_static()


@pytest.mark.parametrize("name", ["batch_norm", "conv2d", "sequence_pool",
                                  "crf_decoding", "sparse_embedding",
                                  "deform_conv2d"])
def test_static_nn_fluid_forwards_resolve(name):
    assert callable(getattr(ref.static.nn, name))
    fn = getattr(paddle.static.nn, name)
    assert callable(fn)
    target = {"deform_conv2d": "deformable_conv",
              "sparse_embedding": None}.get(name, name)
    if target is not None:
        assert fn is getattr(paddle.fluid.layers, target)
    else:
        assert fn.__name__ == "sparse_embedding"


def test_fit_a_line_static_mode_matches():
    """test_book_e2e.py::TestFitALine::test_static_mode_matches in both
    packages on carried weights."""
    rs = np.random.RandomState(0)
    w_true = rs.randn(8, 1).astype(np.float32)
    x_np = rs.randn(64, 8).astype(np.float32)
    y_np = x_np @ w_true + 0.5

    def build(P):
        x = P.static.data("x", [None, 8], "float32")
        y = P.static.data("y", [None, 1], "float32")
        loss = P.nn.functional.mse_loss(P.static.nn.fc(x, 1), y)
        P.optimizer.SGD(0.1).minimize(loss)
        return loss

    def run(P, prog, loss):
        exe = P.static.Executor()
        exe.run(P.static.default_startup_program())
        out = []
        for i in range(150):
            (lv,) = exe.run(prog, feed={"x": x_np, "y": y_np},
                            fetch_list=[loss])
            if i % 30 == 0 or i == 149:
                out.append(float(lv))
        return out
    (_, got), _ = _both(build, run)
    assert got[-1] < 1e-3


# -- a small GPT as a static program -----------------------------------------

def test_small_static_gpt_three_adamw_minimize_steps():
    from paddle_tpu.text.models import GPTForCausalLM, TransformerLMConfig
    from test_torch_paddle_lm import (BATCH, HEADS, HIDDEN, LAYERS, SEQ,
                                      VOCAB, _data, _weights, paddle_lm)
    cfg = TransformerLMConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                              num_layers=LAYERS, num_heads=HEADS,
                              max_seq_len=SEQ, dropout=0.0,
                              tie_embeddings=False)
    gpt = GPTForCausalLM(cfg)
    lm = paddle_lm(paddle)
    w = _weights(gpt)
    assert gpt.set_state_dict(w) == [] and lm.set_state_dict(w) == []
    ids, labels = _data()
    runs = []
    for P, model in ((ref, gpt), (paddle, lm)):
        with _Static(P) as prog:
            i = P.static.data("ids", [BATCH, SEQ], "int64")
            lab = P.static.data("labels", [BATCH, SEQ], "int64")
            if P is ref:
                logits = model(i)
                loss = P.nn.functional.cross_entropy(
                    P.reshape(logits, [-1, VOCAB]), P.reshape(lab, [-1]))
            else:
                loss = model(i, lab)
            P.optimizer.AdamW(1e-3, parameters=model.parameters(),
                              weight_decay=0.01,
                              grad_clip=P.nn.ClipGradByGlobalNorm(1.0)
                              ).minimize(loss)
        exe = P.static.Executor()
        runs.append([float(exe.run(prog, feed={"ids": ids,
                                               "labels": labels},
                                   fetch_list=[loss])[0])
                     for _ in range(3)])
        if P is paddle:
            assert "flash_attention" in {r.type for r in prog.ops}
    np.testing.assert_allclose(runs[1], runs[0], rtol=RTOL)
    assert runs[1][-1] < runs[1][0]


# -- program files across the packages ----------------------------------------

def _saved_by(P, tmp_path, xb):
    with _Static(P) as prog:
        x, pred, loss = _served(P)
    exe = P.static.Executor()
    for _ in range(2):
        exe.run(prog, feed={"x": xb}, fetch_list=[loss])
    want, = exe.run(prog.clone(for_test=True), feed={"x": xb},
                    fetch_list=[pred])
    path = str(tmp_path / f"by_{P.__name__}")
    P.static.save_inference_model(path, [x], [pred], exe, program=prog)
    return path, want


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_program_file_crosses_packages(writer, tmp_path):
    xb = np.random.RandomState(3).randn(5, 6).astype(np.float32)
    W, R = (ref, paddle) if writer == "reference" else (paddle, ref)
    path, want = _saved_by(W, tmp_path, xb)
    prog, feeds, fetches = R.static.load_inference_model(path)
    assert feeds == ["x"]
    got, = R.static.Executor().run(prog, feed={"x": xb},
                                   fetch_list=fetches)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_unknown_op_raises_the_references_error(tmp_path):
    xb = np.ones((2, 6), np.float32)
    path, _ = _saved_by(ref, tmp_path, xb)
    with open(path + ".pdmodel", "rb") as f:
        blob = pickle.load(f)
    for r in blob["records"]:
        if r["kind"] == "op":
            r["type"] = "no_such_op"
            break
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump(blob, f, protocol=4)
    for P in PACKAGES:
        with pytest.raises(ValueError, match="unknown op 'no_such_op'"):
            P.static.load_inference_model(path)


# -- the rest of static/__init__.py --------------------------------------------

def test_gradients_match():
    def build(P):
        x = P.static.data("x", [None, 3], "float32")
        lin = P.nn.Linear(3, 2)
        loss = P.mean(P.square(lin(x)))
        return P.static.gradients(loss, [lin.weight])

    def run(P, prog, grads):
        return P.static.Executor().run(
            prog, feed={"x": np.arange(12, dtype=np.float32).reshape(4, 3)
                        / 10.0}, fetch_list=grads)
    _both(build, run)


def test_save_load_and_program_state(tmp_path):
    def build(P):
        x = P.static.data("x", [None, 4], "float32")
        loss = P.mean(P.square(P.static.nn.fc(x, 2, name="st")))
        P.optimizer.SGD(0.1).minimize(loss)
        return loss

    def run(P, prog, loss):
        exe = P.static.Executor()
        xb = np.ones((3, 4), np.float32)
        exe.run(prog, feed={"x": xb}, fetch_list=[loss])
        path = str(tmp_path / f"state_{P.__name__}")
        P.static.save(prog, path)
        trained = {k: np.asarray(v) for k, v in
                   P.static.save_program_state(prog).items()}
        exe.run(prog, feed={"x": xb}, fetch_list=[loss])   # move on
        P.static.load(prog, path)
        back = P.static.save_program_state(prog)
        for k in trained:
            np.testing.assert_array_equal(np.asarray(back[k]), trained[k])
        state = P.static.load_program_state(path)
        P.static.set_program_state(prog, state)
        l2, = exe.run(prog, feed={"x": xb}, fetch_list=[loss])
        return [l2]
    _both(build, run)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_serialize_program_crosses_packages(writer):
    xb = np.random.RandomState(5).randn(2, 6).astype(np.float32)
    W, R = (ref, paddle) if writer == "reference" else (paddle, ref)
    with _Static(W) as prog:
        x, pred, loss = _served(W)
    want, = W.static.Executor().run(prog.clone(for_test=True),
                                    feed={"x": xb}, fetch_list=[pred])
    blob = W.static.serialize_program([x], [pred], program=prog)
    params = W.static.serialize_persistables([x], [pred], program=prog)
    prog2 = R.static.deserialize_program(blob)
    R.static.deserialize_persistables(prog2, params)
    got, = R.static.Executor().run(prog2, feed={"x": xb},
                                   fetch_list=[pred.name])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("P", PACKAGES, ids=["reference", "port"])
def test_static_surface(P):
    S = P.static
    assert S.default_main_program() is not S.default_startup_program()
    assert isinstance(S.data("x", [None, 3]), S.InputSpec)  # not static
    assert S.BuildStrategy().memory_optimize
    assert S.ExecutionStrategy().num_threads == 1
    assert len(S.cpu_places(2)) == 2
    assert S.global_scope().find_var("nothing") is None
    with S.scope_guard(S.global_scope()), S.name_scope("a"), \
            S.device_guard("cpu"):
        pass
    assert S.WeightNormParamAttr(dim=0).dim == 0
    P.enable_static()
    try:
        with S.program_guard(S.Program()) as g:
            v = S.create_global_var([2], 3.0, "float32", name="gv")
            w = S.create_parameter([3, 2], "float32", name="cp")
            assert "gv" in g.main.persist and "cp" in g.main.persist
            assert tuple(w.shape) == (3, 2) and not w.stop_gradient
            np.testing.assert_array_equal(np.asarray(v.numpy()), [3, 3])
    finally:
        P.disable_static()


def test_py_func_auc_and_print(capsys):
    outs = []
    for P in PACKAGES:
        x = P.to_tensor(np.array([[0.1, 0.9], [0.8, 0.2], [0.3, 0.7],
                                  [0.6, 0.4]], np.float32))
        lab = P.to_tensor(np.array([1, 0, 1, 1], np.int64))
        a = P.static.auc(x, lab)
        out = P.static.py_func(lambda t: np.asarray(t) * 2.0, x,
                               P.to_tensor(np.zeros((4, 2), np.float32)))
        assert P.static.Print(x, message="x:") is x
        outs.append((float(np.asarray(a.numpy())),
                     np.asarray(out.numpy())))
    assert "x:" in capsys.readouterr().out
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=RTOL)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=RTOL)


def test_variable_surface_records_and_refuses_in_place():
    paddle.enable_static()
    try:
        with paddle.static.program_guard(paddle.static.Program()) as g:
            x = paddle.static.data("x", [None, 4], "float32")
            assert x.shape == [-1, 4] and x.dtype.name == "float32"
            y = (x * 2.0 + 1.0).mean(axis=1)   # the method surface records
            assert [r.type for r in g.main.ops] == [
                "elementwise_mul", "elementwise_add", "reduce_mean"]
            assert not hasattr(x, "add_") and not hasattr(x, "scale_")
            with pytest.raises(TypeError):
                x < 1.0      # no comparison operators on a Variable
            assert x == x and hash(x) == hash(x)
            with pytest.raises(RuntimeError, match="symbolic"):
                y.numpy()
    finally:
        paddle.disable_static()


# -- fluid's While and StaticRNN records, built by the reference -------------

def _fluid_program(kind):
    from paddle_tpu.fluid import layers
    ref.enable_static()
    try:
        main = ref.static.Program()
        with ref.static.program_guard(main):
            if kind == "while":
                n = ref.static.data("n", [1], "int64")
                i = layers.fill_constant([1], "int64", 0)
                s = layers.fill_constant([1], "float32", 0.0)
                cond = layers.less_than(i, n)
                w = layers.While(cond)
                with w.block():
                    layers.assign(s + 2.0, output=s)
                    i = layers.increment(i, in_place=True)
                    layers.less_than(i, n, cond=cond)
                feed, out = n, s
            else:
                x = ref.static.data("x", [4, 2, 3], "float32")
                rnn = layers.StaticRNN()
                with rnn.step():
                    word = rnn.step_input(x)
                    prev = rnn.memory(shape=[-1, 3], batch_ref=word)
                    hidden = prev + word
                    rnn.update_memory(prev, hidden)
                    rnn.step_output(hidden)
                feed, out = x, rnn()
    finally:
        ref.disable_static()
    return main, feed, out


@pytest.mark.parametrize("kind", ["while", "recurrent"])
def test_fluid_control_flow_records_run_in_the_port(kind, tmp_path):
    """The reference's fluid.layers.While (a WhileRecord over aliases and
    constants) and StaticRNN (a ScanRecord) saved as a program file, run
    by the port's Executor: the reference's values (fluid itself is not
    ported yet, so the programs come from the reference)."""
    main, feed, out = _fluid_program(kind)
    path = str(tmp_path / kind)
    ref.static.save_inference_model(path, [feed], [out], program=main)
    prog, feeds, fetches = paddle.static.load_inference_model(path)
    assert [r.type for r in prog.ops if r.type in ("while", "recurrent")]
    if kind == "while":
        inputs = [np.array([k], np.int64) for k in (3, 7, 0)]
    else:
        inputs = [np.random.RandomState(0).randn(4, 2, 3).astype(
            np.float32)]
    for v in inputs:
        want, = ref.static.Executor().run(main, feed={feeds[0]: v},
                                          fetch_list=[out])
        got, = paddle.static.Executor().run(prog, feed={feeds[0]: v},
                                            fetch_list=fetches)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_host_state_refused_in_a_warmed_branch():
    """A branch the record call did not take is warmed in a capture that
    never runs: an optimizer's first state made there would keep no
    values, so it is refused as under the capture, and nothing is left
    behind."""
    from paddle_tpu_torch.core import trace
    from paddle_tpu_torch.jit import ToStaticError
    lin = paddle.nn.Linear(2, 2)
    opt = paddle.optimizer.Adam(1e-3, parameters=lin.parameters())
    param = opt._parameter_list()[0]
    with trace.trace_guard(trace.TraceContext("record")):
        trace._warming = True
        try:
            with pytest.raises(ToStaticError, match="did not take"):
                opt._acc("moment1", param)
            with pytest.raises(ToStaticError, match="did not take"):
                opt.set_lr(0.5)
        finally:
            trace._warming = False
        opt._acc("moment1", param)   # the record call's own branch
    assert opt.get_lr() == np.float32(1e-3)
    assert list(opt._accumulators["moment1"]) == [id(param)]
