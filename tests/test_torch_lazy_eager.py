"""The port's lazy eager executor (``paddle_tpu_torch/core/lazy.py``)
against the reference's (``paddle_tpu/core/lazy.py``), on the CPU: every
case of ``tests/test_lazy_eager.py`` through both packages with
``FLAGS_lazy_eager`` on, and the port's own cases.

* Training parity: the same 4 Adam steps of a small MLP (weights carried
  across by ``set_state_dict``) and 3 AdamW steps of the surface GPT of
  ``test_torch_paddle_lm.py`` (weights from the port's torch GPT through
  ``text.convert``) give the reference's lazy losses at rtol 1e-5, and
  the port's immediate losses and weights bit for bit.
* A deferred op's output is a placeholder whose shape, dtype and
  ``stop_gradient`` read without running it, until a host read.
* Six steps add at most 3 replay-cache entries; a ``float()`` in
  control flow flushes; grads accumulated over two backwards without a
  clear match immediate's and the reference's at rtol 1e-6; lazy and
  flushed inputs mix.
* GradScaler under O1 bf16 (the inf check's read ends the first of a
  step's two graphs) gives immediate's losses; an inf step is skipped
  and the scale backs off.
* The port's: an op that cannot defer (``masked_select``) falls back
  after the pending graph; a write through a view reaches its source;
  ``to_static`` entered with a graph pending runs it first and defers
  nothing inside; two threads keep their own graphs; ``create_graph``
  runs at once; a released graph raises when the second backward is
  deferred; ``set_value`` of a pending value is a deferred write; a
  scheduler stepped between steps acts on the next one; an index write
  after a deferred read leaves the read's value as immediate and the
  reference compute it; ids interned from many threads are unique and
  lazy graphs flushed from many threads give their immediate values; a
  loop that changes a scalar every step keeps the metadata and interned
  key caches within their bounds; each optimizer keys its own step node
  and its replay entry dies with it, and a fresh optimizer over trained
  parameters gives immediate's bits.
"""
import gc
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu.core import lazy as ref_lazy
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.core import lazy

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _lazy_on():
    """The flag on in both packages, the port on the CPU."""
    prev = {P: P.get_flags(["FLAGS_lazy_eager"])["FLAGS_lazy_eager"]
            for P in (ref, paddle)}
    for P in (ref, paddle):
        P.set_flags({"FLAGS_lazy_eager": True})
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    lazy.flush()
    ref_lazy.flush()
    for P, v in prev.items():
        P.set_flags({"FLAGS_lazy_eager": v})
    device_mod._current_place = None
    torch.set_num_threads(before)


def _mlp(P, state=None):
    net = P.nn.Sequential(P.nn.Linear(16, 32), P.nn.ReLU(),
                          P.nn.Linear(32, 4))
    if state is not None:
        assert net.set_state_dict(state) == []
    return net


def _state(net):
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


def _train_losses(P, flag, state, steps=4):
    P.set_flags({"FLAGS_lazy_eager": flag})
    try:
        net = _mlp(P, state)
        opt = P.optimizer.Adam(1e-2, parameters=net.parameters())
        loss_fn = P.nn.CrossEntropyLoss()
        rs = np.random.RandomState(7)
        x = P.to_tensor(rs.randn(8, 16).astype("float32"))
        y = P.to_tensor(rs.randint(0, 4, (8,)).astype("int64"))
        losses = []
        for _ in range(steps):
            loss = loss_fn(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        return losses, _state(net)
    finally:
        P.set_flags({"FLAGS_lazy_eager": True})


class TestLazyNumerics:
    def test_training_parity_with_immediate_mode(self):
        ref.seed(7)
        state = _state(_mlp(ref))
        want, _ = _train_losses(ref, True, state)
        got, w_lazy = _train_losses(paddle, True, state)
        imm, w_imm = _train_losses(paddle, False, state)
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert got == imm
        for k in w_imm:
            np.testing.assert_array_equal(w_lazy[k], w_imm[k])
        assert got[0] > got[-1]

    def test_surface_gpt_parity(self):
        """The surface GPT of test_torch_paddle_lm (2 layers, hidden 64)
        with the torch GPT's weights through text.convert, 3 AdamW steps
        with the global-norm clip: the reference's lazy losses at rtol
        1e-5, the port's immediate losses and weights bit for bit, one
        graph a step (each flushed at clear_grad)."""
        from test_torch_paddle_lm import (BATCH, HEADS, HIDDEN, LAYERS,
                                          SEQ, VOCAB, paddle_lm)
        from paddle_tpu_torch.text import convert
        from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                                  TransformerLMConfig)
        cfg = TransformerLMConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                                  num_layers=LAYERS, num_heads=HEADS,
                                  intermediate_size=4 * HIDDEN,
                                  max_seq_len=SEQ, dropout=0.0,
                                  tie_embeddings=False)
        tg = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(3),
                            device="cpu")
        init = convert.state_dict_to_paddle_tpu(tg.state_dict())
        ids = np.random.RandomState(4).randint(
            0, VOCAB, (BATCH, SEQ)).astype(np.int64)

        def run(P, flag):
            P.set_flags({"FLAGS_lazy_eager": flag})
            try:
                model = paddle_lm(P)
                assert model.set_state_dict(init) == []
                opt = P.optimizer.AdamW(
                    1e-3, parameters=model.parameters(), weight_decay=0.01,
                    grad_clip=P.nn.ClipGradByGlobalNorm(1.0))
                t = P.to_tensor(ids)
                losses = []
                for _ in range(3):
                    loss = model(t, t)
                    loss.backward()
                    opt.step()
                    opt.clear_grad()
                    losses.append(float(loss))
                return losses, _state(model)
            finally:
                P.set_flags({"FLAGS_lazy_eager": True})

        want, _ = run(ref, True)
        before = lazy.stats["cpu"]
        got, w_lazy = run(paddle, True)
        assert lazy.stats["cpu"] - before == 3
        imm, w_imm = run(paddle, False)
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert got == imm
        for k in w_imm:
            np.testing.assert_array_equal(w_lazy[k], w_imm[k])

    def test_deferred_until_materialization(self):
        a = paddle.to_tensor(np.ones((4, 4), np.float32))
        b = a * 3.0 + 1.0
        assert isinstance(b._v, lazy.LazyArray)
        assert b.shape == [4, 4] and b.dtype == paddle.float32
        assert b.stop_gradient and b.ndim == 2 and b.size == 16
        la = b._v
        assert la._concrete is None
        np.testing.assert_allclose(b.numpy(), 4.0 * np.ones((4, 4)))
        assert la._concrete is not None and b._v is la._concrete
        rb = ref.to_tensor(np.ones((4, 4), np.float32)) * 3.0 + 1.0
        assert isinstance(rb._value, ref_lazy.LazyArray)
        np.testing.assert_array_equal(b.numpy(), rb.numpy())

    def test_replay_cache_hits_across_steps(self):
        state = _state(_mlp(paddle))
        before = len(lazy._replay_cache)
        _train_losses(paddle, True, state, steps=6)
        assert len(lazy._replay_cache) - before <= 3

    def test_control_flow_flushes(self):
        for P in (ref, paddle):
            t = P.to_tensor(np.asarray([2.0], np.float32))
            out = t * 2
            ok = False
            if float(out) > 3.0:
                ok = True
            assert ok
        assert not lazy.pending()

    def test_grad_accumulation_without_clear(self):
        paddle.seed(0)
        state = _state(paddle.nn.Linear(4, 4))
        x_np = np.ones((2, 4), np.float32)

        def grads(P, flag):
            P.set_flags({"FLAGS_lazy_eager": flag})
            try:
                lin = P.nn.Linear(4, 4)
                assert lin.set_state_dict(state) == []
                x = P.to_tensor(x_np)
                for _ in range(2):
                    lin(x).sum().backward()
                return lin.weight.grad.numpy()
            finally:
                P.set_flags({"FLAGS_lazy_eager": True})

        g_lazy = grads(paddle, True)
        np.testing.assert_allclose(g_lazy, grads(paddle, False), rtol=1e-6)
        np.testing.assert_allclose(g_lazy, grads(ref, True), rtol=1e-6)

    def test_mixed_lazy_concrete_inputs(self):
        for P, L in ((ref, ref_lazy), (paddle, lazy)):
            a = P.to_tensor(np.ones((3,), np.float32))
            b = a + 1.0
            L.flush()
            c = b * 2.0 + a
            np.testing.assert_allclose(c.numpy(), [5.0, 5.0, 5.0])


class TestLazyWithAmp:
    def _scaled(self, P, flag, state, steps=6):
        P.set_flags({"FLAGS_lazy_eager": flag})
        try:
            net = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                                  P.nn.Linear(16, 4))
            assert net.set_state_dict(state) == []
            opt = P.optimizer.Adam(1e-2, parameters=net.parameters())
            scaler = P.amp.GradScaler(init_loss_scaling=2.0 ** 10)
            loss_fn = P.nn.CrossEntropyLoss()
            rs = np.random.RandomState(0)
            x = P.to_tensor(rs.randn(8, 8).astype("float32"))
            y = P.to_tensor(rs.randint(0, 4, (8,)).astype("int64"))
            losses = []
            for _ in range(steps):
                with P.amp.auto_cast(level="O1", dtype="bfloat16"):
                    loss = loss_fn(net(x), y)
                scaler.scale(loss).backward()
                scaler.step(opt)
                scaler.update()
                opt.clear_grad()
                losses.append(float(loss.numpy()))
            return losses
        finally:
            P.set_flags({"FLAGS_lazy_eager": True})

    def test_grad_scaler_training_under_lazy(self):
        """O1 bf16 + GradScaler: the inf check's host read ends the
        forward-and-backward graph, the update is a second one; the
        losses are immediate's bits and the reference's at bf16's
        rounding."""
        ref.seed(0)
        state = _state(ref.nn.Sequential(ref.nn.Linear(8, 16),
                                         ref.nn.ReLU(),
                                         ref.nn.Linear(16, 4)))
        before = lazy.stats["cpu"]
        got = self._scaled(paddle, True, state)
        assert lazy.stats["cpu"] - before == 12
        assert got == self._scaled(paddle, False, state)
        assert np.isfinite(got).all() and got[-1] < got[0]
        np.testing.assert_allclose(got, self._scaled(ref, True, state),
                                   rtol=2e-2)

    def test_inf_step_is_skipped_under_lazy(self):
        for P in (ref, paddle):
            P.seed(0)
            lin = P.nn.Linear(4, 4)
            opt = P.optimizer.SGD(0.1, parameters=lin.parameters())
            scaler = P.amp.GradScaler(init_loss_scaling=8.0)
            w0 = lin.weight.numpy().copy()
            x = P.to_tensor(
                np.full((2, 4), np.finfo(np.float32).max / 4, np.float32))
            loss = (lin(x) * 1e30).sum()
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            np.testing.assert_allclose(lin.weight.numpy(), w0)
            assert float(np.asarray(scaler._scale.numpy())) < 8.0


class TestPortCases:
    def test_fallback_op_runs_after_the_pending_graph(self):
        """An op whose output shape depends on values cannot run on meta
        tensors: it falls back (counted), after the pending graph, and
        runs at once; masked_select, which reads its input's values
        outside the dispatcher, runs the pending graph the same way."""
        from paddle_tpu_torch.core.dispatch import _REGISTRY, register_op
        name = "test_lazy_rows_above"
        op = _REGISTRY.get(name) or register_op(name, differentiable=False)(
            lambda x, *, above: torch.nonzero(x > above).reshape(-1))
        x = paddle.to_tensor(np.arange(6, dtype=np.float32))
        y = x * 2.0
        pending = y._v
        assert lazy.pending()
        before = lazy.stats["fallback"]
        rows = op(y, above=4.0)
        assert lazy.stats["fallback"] == before + 1
        assert not lazy.pending() and pending._concrete is not None
        assert not isinstance(rows._v, lazy.LazyArray)
        np.testing.assert_array_equal(rows.numpy(), [3, 4, 5])
        y = x * 2.0
        z = paddle.masked_select(y, y > 4.0)
        assert not lazy.pending()
        np.testing.assert_array_equal(z.numpy(), [6.0, 8.0, 10.0])

    def test_write_through_a_view_reaches_its_source(self):
        base = paddle.to_tensor(np.zeros((2, 3), np.float32))
        view = base.reshape([6])
        assert isinstance(view._v, lazy.LazyArray)
        view[2] = 5.0
        np.testing.assert_array_equal(
            base.numpy(), [[0, 0, 5], [0, 0, 0]])
        paddle.set_flags({"FLAGS_lazy_eager": False})
        b2 = paddle.to_tensor(np.zeros((2, 3), np.float32))
        v2 = b2.reshape([6])
        v2[2] = 5.0
        np.testing.assert_array_equal(b2.numpy(), base.numpy())

    def test_to_static_with_a_graph_pending(self):
        x = paddle.to_tensor(np.ones((2, 2), np.float32))
        y = x + 1.0
        assert lazy.pending()
        seen = []

        @paddle.jit.to_static
        def step(t):
            out = t * 3.0
            seen.append(isinstance(out._v, lazy.LazyArray))
            return out

        pending = y._v
        z = step(x)
        assert not lazy.pending() and pending._concrete is not None
        assert seen == [False]
        np.testing.assert_array_equal(z.numpy(), 3 * np.ones((2, 2)))
        np.testing.assert_array_equal(y.numpy(), 2 * np.ones((2, 2)))

    def test_two_threads_have_their_own_graphs(self):
        out, graphs = {}, {}

        def work(k):
            t = paddle.to_tensor(np.full((3,), float(k), np.float32))
            r = t * 2.0 + 1.0
            graphs[k] = lazy.current()
            out[k] = r.numpy()

        threads = [threading.Thread(target=work, args=(k,))
                   for k in (1, 2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert graphs[1] is not graphs[2]
        np.testing.assert_array_equal(out[1], [3.0] * 3)
        np.testing.assert_array_equal(out[2], [5.0] * 3)

    def test_create_graph_runs_at_once(self):
        x = paddle.to_tensor(np.asarray([3.0], np.float32),
                             stop_gradient=False)
        y = x * x * x
        (g,) = paddle.grad(y, x, create_graph=True)
        assert not lazy.pending()
        assert not isinstance(g._v, lazy.LazyArray)
        np.testing.assert_allclose(g.numpy(), [27.0])
        (gg,) = paddle.grad(g, x)
        np.testing.assert_allclose(gg.numpy(), [18.0])
        rx = ref.to_tensor(np.asarray([3.0], np.float32),
                           stop_gradient=False)
        (rg,) = ref.grad(rx * rx * rx, rx, create_graph=True)
        np.testing.assert_allclose(ref.grad(rg, rx)[0].numpy(), gg.numpy())

    def test_released_graph_raises_when_deferred(self):
        x = paddle.to_tensor([1.0], stop_gradient=False)
        z = x * 2.0
        z.backward()
        assert lazy.pending()
        with pytest.raises(RuntimeError, match="released graph"):
            z.backward()
        assert x.grad.numpy().tolist() == [2.0]

    def test_set_value_of_a_pending_value_is_a_deferred_write(self):
        acc = paddle.to_tensor(np.zeros((3,), np.float32))
        x = paddle.to_tensor(np.ones((3,), np.float32))
        before = acc * 1.0
        acc.set_value(acc + x * 2.0)
        after = acc * 1.0
        assert lazy.pending()
        np.testing.assert_array_equal(before.numpy(), [0.0] * 3)
        np.testing.assert_array_equal(after.numpy(), [2.0] * 3)
        np.testing.assert_array_equal(acc.numpy(), [2.0] * 3)

    def test_scheduler_between_steps_acts_on_the_next(self):
        state = _state(_mlp(paddle))

        def run(flag):
            paddle.set_flags({"FLAGS_lazy_eager": flag})
            try:
                net = _mlp(paddle, state)
                sched = paddle.optimizer.lr.StepDecay(0.1, step_size=1,
                                                      gamma=0.5)
                opt = paddle.optimizer.SGD(sched,
                                           parameters=net.parameters())
                x = paddle.to_tensor(np.ones((2, 16), np.float32))
                for _ in range(4):
                    net(x).sum().backward()
                    opt.step()
                    sched.step()
                    opt.clear_grad()
                return _state(net)
            finally:
                paddle.set_flags({"FLAGS_lazy_eager": True})

        got, want = run(True), run(False)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])

    def test_setitem_after_a_deferred_read(self):
        """``x[i] = v`` writes in place: the ops deferred before it read
        the value before the write, as immediate mode and the
        reference's immutable arrays do."""
        def run(P, flag):
            P.set_flags({"FLAGS_lazy_eager": flag})
            try:
                x = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
                y = x * 2.0
                x[0] = 5.0
                z = x + 1.0
                w = z * 1.0
                z[1, 2] = -1.0
                return [t.numpy() for t in (x, y, z, w)]
            finally:
                P.set_flags({"FLAGS_lazy_eager": True})

        got, imm, want = run(paddle, True), run(paddle, False), run(ref, True)
        np.testing.assert_array_equal(got[1], [[0, 2, 4], [6, 8, 10]])
        for g, i, w in zip(got, imm, want):
            np.testing.assert_array_equal(g, i)
            np.testing.assert_array_equal(g, w)

    def test_interned_ids_are_unique_across_threads(self):
        ids, out = {}, {}

        def work(k):
            ids[k] = [lazy._intern(("test-thread", k, i))
                      for i in range(2000)]
            t = paddle.to_tensor(np.full((k + 1,), float(k), np.float32))
            vals = []
            for i in range(20):
                t = t * 2.0 + float(i)
                vals.append(t.numpy().copy())
            out[k] = vals

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        every = [i for v in ids.values() for i in v]
        assert len(set(every)) == len(every) == 8 * 2000
        for k in range(8):
            want = np.full((k + 1,), float(k), np.float32)
            for i, got in enumerate(out[k]):
                want = want * np.float32(2.0) + np.float32(i)
                np.testing.assert_array_equal(got, want)

    def test_changing_scalar_keeps_caches_bounded(self, monkeypatch):
        """A per-step Python float (an argument and an attribute) is in
        the metadata and interned keys: both caches stay within their
        bounds over 300 steps, and the values are immediate's."""
        monkeypatch.setattr(lazy, "_MAX_META", 64)
        monkeypatch.setattr(lazy, "_MAX_INTERNED", 256)

        def run(flag):
            paddle.set_flags({"FLAGS_lazy_eager": flag})
            try:
                x = paddle.to_tensor(np.linspace(-1, 1, 8, dtype=np.float32))
                vals, sizes = [], []
                for step in range(1, 301):
                    y = paddle.scale(x * (1.0 + 1.0 / step), scale=0.5 + step)
                    vals.append(y.numpy().copy())
                    sizes.append((len(lazy._meta_cache),
                                  len(lazy._intern_ids)))
                return vals, sizes
            finally:
                paddle.set_flags({"FLAGS_lazy_eager": True})

        got, sizes = run(True)
        want, _ = run(False)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert max(m for m, _ in sizes) <= 64
        assert max(i for _, i in sizes) <= 256
        assert sizes[-1] == sizes[149]

    def test_each_optimizer_keys_its_own_step(self):
        """A freed optimizer's id() is given to the next one: each
        optimizer's step node has a key no other optimizer gets, and the
        replay entry of its steps dies with it (a new optimizer over the
        same parameters never reaches the old one's captured step)."""
        net = _mlp(paddle, _state(_mlp(paddle)))
        loss_fn = paddle.nn.CrossEntropyLoss()
        rs = np.random.RandomState(7)
        x = paddle.to_tensor(rs.randn(8, 16).astype("float32"))
        y = paddle.to_tensor(rs.randint(0, 4, (8,)).astype("int64"))
        keys = []
        for _ in range(4):
            opt = paddle.optimizer.Adam(1e-2, parameters=net.parameters())
            loss = loss_fn(net(x), y)
            loss.backward()
            opt.step()
            keys.append(lazy.current().nodes[-1].cache_key)
            opt.clear_grad()
            entries = [e for e in lazy._replay_cache.values()
                       if any(o() is opt for o in e.owners)]
            assert len(entries) == 1 and entries[0].alive()
            del opt
            gc.collect()
            assert not entries[0].alive()
        assert len(set(keys)) == len(keys)

    def test_a_new_optimizer_trains_as_immediate(self):
        """Two steps of one Adam, then a fresh Adam over the same
        parameters for four: lazy gives immediate's losses and weights
        bit for bit (the fresh optimizer's state starts at zero)."""
        def run(flag):
            paddle.set_flags({"FLAGS_lazy_eager": flag})
            try:
                net = _mlp(paddle, state)
                loss_fn = paddle.nn.CrossEntropyLoss()
                rs = np.random.RandomState(7)
                x = paddle.to_tensor(rs.randn(8, 16).astype("float32"))
                y = paddle.to_tensor(rs.randint(0, 4, (8,)).astype("int64"))
                losses = []
                for steps in (2, 4):
                    opt = paddle.optimizer.Adam(1e-2,
                                                parameters=net.parameters())
                    for _ in range(steps):
                        loss = loss_fn(net(x), y)
                        loss.backward()
                        opt.step()
                        opt.clear_grad()
                        losses.append(float(loss.numpy()))
                    del opt
                    gc.collect()
                return losses, _state(net)
            finally:
                paddle.set_flags({"FLAGS_lazy_eager": True})

        state = _state(_mlp(paddle))
        (got, w_got), (want, w_want) = run(True), run(False)
        assert got == want
        for k in w_want:
            np.testing.assert_array_equal(w_got[k], w_want[k])
