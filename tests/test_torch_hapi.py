"""paddle_tpu_torch's ``hapi`` (``Model``, callbacks, ``summary``/``flops``)
and ``metric`` against the JAX package's on the CPU.

* ``Model`` over LeNet and FakeData (``test_models.py``'s fit, evaluate
  and predict), gradient accumulation against a manual loop, the
  ``hapi/*`` spans, ``save``/``load`` across the packages both ways, an
  Adam state carried from the reference through
  ``text.convert.optimizer_state_from_paddle_tpu``.
* The encoder-decoder of ``chip_smoke.py`` phase 23 at a small width
  (embeddings, a 2-layer ``nn.LSTM`` encoder, a decoder cell of two
  ``LSTMCell``s with flat states run by ``nn.RNN``, a ``Linear`` head,
  PaddleNLP's masked cross-entropy criterion with the mask taken from
  the padded label, Adam with ``ClipGradByGlobalNorm(5.0)``) over
  ``WMT16`` through ``DataLoader`` and ``fit``, 2 steps in both packages
  from carried weights: the losses, one batch's grads and the weights
  after the steps; then its beam decode gives the reference's ids.
* The callbacks: ``VisualDL`` (a readable TensorBoard file,
  ``test_visualdl_callback.py``), ``ModelCheckpoint``, ``EarlyStopping``,
  ``LRScheduler``, ``ProgBarLogger``; ``summary`` and ``flops`` equal to
  the reference's; ``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and
  ``accuracy`` on the same inputs.

Losses within rtol 1e-5, grads within 1e-4 of each tensor's largest,
weights after 2 Adam steps within 1e-5; ids exactly.
"""
import glob
import os

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _carry(r, t):
    assert t.set_state_dict({k: np.asarray(v.numpy())
                             for k, v in r.state_dict().items()}) == []


def _lenet_models():
    ref.seed(0)
    models = []
    for P in (ref, paddle):
        net = P.vision.models.LeNet()
        models.append((P, net))
    _carry(models[0][1], models[1][1])
    return models


def test_fit_evaluate_predict_lenet():
    """``test_models.py``'s LeNet scenario in both packages on the same
    weights and data: the per-step losses, the evaluation and the
    predictions."""
    results = []
    for P, net in _lenet_models():
        model = P.Model(net)
        model.prepare(P.optimizer.Adam(1e-3, parameters=net.parameters()),
                      P.nn.CrossEntropyLoss(), P.metric.Accuracy())
        data = P.vision.datasets.FakeData(num_samples=32)
        seen = []

        class Rec(P.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                seen.append(logs["loss"])
        model.fit(data, batch_size=8, epochs=1, verbose=0, shuffle=False,
                  callbacks=[Rec()])
        res = model.evaluate(data, batch_size=8, verbose=0)
        preds = model.predict(data, batch_size=8, stack_outputs=True)
        results.append((seen, res, preds))
    (rl, rres, rp), (tl, tres, tp) = results
    assert len(tl) == 4 and "loss" in tres and "acc" in tres
    np.testing.assert_allclose(tl, rl, rtol=1e-5)
    np.testing.assert_allclose(tres["loss"], rres["loss"], rtol=1e-5)
    assert tres["acc"] == rres["acc"]
    assert tp[0].shape == (32, 10)
    np.testing.assert_allclose(tp[0], np.asarray(rp[0]), rtol=1e-4,
                               atol=1e-5)


def test_fit_accumulate_grad_batches():
    """``accumulate_grad_batches=2`` equals a manual accumulate-then-step
    loop, and the reference's fit."""
    xs = np.random.RandomState(0).randn(8, 4).astype("float32")
    ys = np.random.RandomState(1).randint(0, 3, (8, 1)).astype("int64")

    def ds(P):
        class Ds(P.io.Dataset):
            def __len__(self):
                return 8

            def __getitem__(self, i):
                return xs[i], ys[i]
        return Ds()

    def make(P, init=None):
        P.seed(5)
        net = P.nn.Linear(4, 3)
        if init is not None:
            _carry(init, net)
        return net, P.optimizer.SGD(0.1, parameters=net.parameters())

    net_r, opt_r = make(ref)
    m = ref.Model(net_r)
    m.prepare(opt_r, ref.nn.CrossEntropyLoss())
    start, _ = make(ref)
    net_a, opt_a = make(paddle, start)
    net_b, opt_b = make(paddle, start)
    _carry(start, net_r)
    m.fit(ds(ref), batch_size=2, epochs=1, shuffle=False, verbose=0,
          accumulate_grad_batches=2)
    loss_fn = paddle.nn.CrossEntropyLoss()
    for i in range(4):
        loss_fn(net_b(paddle.to_tensor(xs[2 * i:2 * i + 2])),
                paddle.to_tensor(ys[2 * i:2 * i + 2])).backward()
        if (i + 1) % 2 == 0:
            opt_b.step()
            opt_b.clear_grad()
    model = paddle.Model(net_a)
    model.prepare(opt_a, paddle.nn.CrossEntropyLoss())
    model.fit(ds(paddle), batch_size=2, epochs=1, shuffle=False, verbose=0,
              accumulate_grad_batches=2)
    np.testing.assert_allclose(net_a.weight.numpy(), net_b.weight.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(net_a.weight.numpy(),
                               np.asarray(net_r.weight.numpy()), rtol=1e-5)


def test_hapi_spans_recorded():
    from paddle_tpu_torch.observability.tracing import default_recorder
    net = paddle.nn.Linear(4, 2)
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.SGD(0.1, parameters=net.parameters()),
                  paddle.nn.MSELoss())
    x = np.ones((2, 4), np.float32)
    y = np.zeros((2, 2), np.float32)
    model.train_batch([x], [y])
    model.eval_batch([x], [y])
    model.predict_batch([x])
    names = {s.name for s in default_recorder().spans()}
    assert {"hapi/train_batch", "hapi/eval_batch",
            "hapi/predict_batch"} <= names


# ---- the encoder-decoder ------------------------------------------------------

def seq2seq(P, src_vocab, trg_vocab, hidden, layers=2, dropout=0.0):
    """PaddleNLP's seq2seq without attention, written against package
    ``P``: every parameter Uniform(-0.1, 0.1) (the global initializer)."""
    nn = P.nn

    class DecoderCell(nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.hidden_size = hidden
            self.cells = nn.LayerList([nn.LSTMCell(hidden, hidden)
                                       for _ in range(layers)])
            self.drop = nn.Dropout(dropout)

        def forward(self, x, states):
            new = []
            for i, cell in enumerate(self.cells):
                out, (h, c) = cell(x, (states[2 * i], states[2 * i + 1]))
                x = self.drop(out) if dropout else out
                new += [h, c]
            return x, tuple(new)

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_emb = nn.Embedding(src_vocab, hidden)
            self.trg_emb = nn.Embedding(trg_vocab, hidden)
            self.encoder = nn.LSTM(hidden, hidden, num_layers=layers,
                                   dropout=dropout)
            self.decoder = nn.RNN(DecoderCell())
            self.head = nn.Linear(hidden, trg_vocab)

        def encode(self, src, src_len=None):
            _, (h, c) = self.encoder(self.src_emb(src),
                                     sequence_length=src_len)
            return tuple(s for i in range(layers) for s in (h[i], c[i]))

        def forward(self, src, src_len, trg):
            out, _ = self.decoder(self.trg_emb(trg),
                                  self.encode(src, src_len))
            return self.head(out)

    init = nn.initializer.Uniform(-0.1, 0.1)
    nn.initializer.set_global_initializer(init, init)
    try:
        return Seq2Seq()
    finally:
        nn.initializer.set_global_initializer(None)


def criterion(P):
    class CrossEntropyCriterion(P.nn.Layer):
        """Per-token CE times the target mask, mean over the batch, sum
        over time; the mask is the padded label's (-100 past the end)."""

        def forward(self, logits, label):
            cost = P.nn.functional.cross_entropy(logits, label,
                                                 reduction="none")
            cost = P.reshape(cost, label.shape)
            mask = P.cast(P.greater_equal(label, P.zeros_like(label)),
                          "float32")
            return P.sum(P.mean(cost * mask, axis=0))
    return CrossEntropyCriterion()


def pad_collate(batch, length=None):
    """``(src, src_len, trg, label)``, each padded to the batch's longest
    (or cut and padded to ``length``, which keeps one shape, so that the
    reference compiles its step once); the label (``trg_next``) with
    -100."""
    batch = [tuple(x[:length] for x in sample) for sample in batch]
    b = len(batch)
    s_max = length or max(len(x[0]) for x in batch)
    t_max = length or max(len(x[1]) for x in batch)
    src = np.zeros((b, s_max), "int64")
    trg = np.zeros((b, t_max), "int64")
    label = np.full((b, t_max), -100, "int64")
    for i, (s, t, n) in enumerate(batch):
        src[i, :len(s)] = s
        trg[i, :len(t)] = t
        label[i, :len(n)] = n
    return src, np.array([len(x[0]) for x in batch], "int64"), trg, label


def short_collate(batch):
    return pad_collate(batch, length=8)


VOCAB = dict(src_dict_size=60, trg_dict_size=50)


def _s2s_pair(hidden=16):
    ref.seed(3)
    r = seq2seq(ref, VOCAB["src_dict_size"], VOCAB["trg_dict_size"], hidden)
    paddle.seed(3)
    t = seq2seq(paddle, VOCAB["src_dict_size"], VOCAB["trg_dict_size"],
                hidden)
    assert list(t.state_dict()) == list(r.state_dict())
    _carry(r, t)
    return r, t


def _opt(P, net):
    return P.optimizer.Adam(1e-3, parameters=net.parameters(),
                            grad_clip=P.nn.ClipGradByGlobalNorm(5.0))


def test_seq2seq_fit_two_steps_matches_reference():
    r, t = _s2s_pair()
    runs = []
    for P, net in ((ref, r), (paddle, t)):
        loader = P.io.DataLoader(P.text.datasets.WMT16(mode="train",
                                                       **VOCAB),
                                 batch_size=16, shuffle=False,
                                 collate_fn=short_collate)
        batch = next(iter(loader))
        model = P.Model(net)
        model.prepare(_opt(P, net), criterion(P))
        model.train_batch(batch[:3], [batch[3]], update=False)
        grads = {n: np.asarray(p.grad.numpy())
                 for n, p in net.named_parameters()}
        net.clear_gradients()
        losses = []

        class Rec(P.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                losses.append(logs["loss"])
        model.fit(loader, epochs=1, verbose=0, num_iters=2,
                  callbacks=[Rec()])
        ev = model.evaluate(P.io.DataLoader(
            P.io.Subset(P.text.datasets.WMT16(mode="test", **VOCAB),
                        list(range(32))), batch_size=16,
            collate_fn=short_collate), verbose=0)
        runs.append((losses, grads, {n: np.asarray(p.numpy()) for n, p in
                                     net.named_parameters()}, ev["loss"]))
    (rl, rg, rw, re), (tl, tg, tw, te) = runs
    assert len(tl) == 2 and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, rl, rtol=1e-5)
    np.testing.assert_allclose(te, re, rtol=1e-5)
    for n in rg:
        np.testing.assert_allclose(tg[n], rg[n], rtol=0,
                                   atol=1e-4 * np.abs(rg[n]).max(),
                                   err_msg=n)
        np.testing.assert_allclose(tw[n], rw[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def test_seq2seq_beam_decode_matches_reference():
    r, t = _s2s_pair()
    src = short_collate([paddle.text.datasets.WMT16(mode="test", **VOCAB)[i]
                         for i in range(4)])[0]
    ids = []
    for P, net in ((ref, r), (paddle, t)):
        net.eval()
        with P.no_grad():
            inits = net.encode(P.to_tensor(src))
            dec = P.nn.BeamSearchDecoder(net.decoder.cell, start_token=0,
                                         end_token=1, beam_size=4,
                                         embedding_fn=net.trg_emb,
                                         output_fn=net.head)
            out, _ = P.nn.dynamic_decode(dec, inits=inits, max_step_num=10)
        ids.append(np.asarray(out.numpy()))
    assert ids[1].shape == (4, 10, 4)
    np.testing.assert_array_equal(ids[1], ids[0])


def test_save_load_across_packages(tmp_path):
    """``Model.save`` of one package loads through the other's
    ``Model.load``; an Adam state moves from the reference through
    ``optimizer_state_from_paddle_tpu`` and the next step is the
    reference's."""
    from paddle_tpu_torch.text.convert import optimizer_state_from_paddle_tpu
    r, t = _s2s_pair(hidden=8)
    batch = short_collate([paddle.text.datasets.WMT16(**VOCAB)[i]
                           for i in range(8)])
    rm = ref.Model(r)
    ropt = _opt(ref, r)
    rm.prepare(ropt, criterion(ref))
    rm.train_batch(batch[:3], [batch[3]])
    rm.save(str(tmp_path / "ref"))
    tm = paddle.Model(t)
    topt = paddle.optimizer.Adam(
        1e-3, parameters=t.named_parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(5.0))
    tm.prepare(topt, criterion(paddle))
    tm.load(str(tmp_path / "ref"), reset_optimizer=True)
    for n, p in t.named_parameters():
        np.testing.assert_array_equal(p.numpy(), np.asarray(
            dict(r.named_parameters())[n].numpy()))
    np_state = {k: (v if isinstance(v, dict) else np.asarray(v.numpy()))
                for k, v in ropt.state_dict().items()}
    topt.set_state_dict(optimizer_state_from_paddle_tpu(
        np_state, {p.name: n for n, p in r.named_parameters()},
        same_layout=True))
    losses = [m.train_batch(batch[:3], [batch[3]])[0] for m in (rm, tm)]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for n, p in t.named_parameters():
        np.testing.assert_allclose(p.numpy(), np.asarray(
            dict(r.named_parameters())[n].numpy()), rtol=1e-5, atol=1e-7,
            err_msg=n)
    tm.save(str(tmp_path / "port"))
    r2 = seq2seq(ref, VOCAB["src_dict_size"], VOCAB["trg_dict_size"], 8)
    ref.Model(r2).load(str(tmp_path / "port"), reset_optimizer=True)
    for n, p in r2.named_parameters():
        np.testing.assert_array_equal(np.asarray(p.numpy()),
                                      dict(t.named_parameters())[n].numpy())


# ---- callbacks, summary, metric --------------------------------------------------

def _tiny_fit(P, tmp, callbacks, epochs=2):
    P.seed(0)
    model = P.Model(P.nn.Sequential(P.nn.Flatten(), P.nn.Linear(784, 10)))
    model.prepare(P.optimizer.Adam(1e-3,
                                   parameters=model.network.parameters()),
                  P.nn.CrossEntropyLoss(), P.metric.Accuracy())
    model.fit(P.vision.datasets.FakeData(32, image_shape=(1, 28, 28),
                                         num_classes=10),
              batch_size=16, epochs=epochs, callbacks=callbacks, verbose=0)
    return model


def test_visualdl_writes_a_readable_file(tmp_path):
    from paddle_tpu_torch.utils.tbwriter import SummaryWriter, read_scalars
    from paddle_tpu.utils.tbwriter import read_scalars as ref_read
    cb = paddle.callbacks.VisualDL(log_dir=str(tmp_path / "logs"))
    _tiny_fit(paddle, tmp_path, [cb])
    files = glob.glob(str(tmp_path / "logs" / "events.out.tfevents.*"))
    assert len(files) == 1
    scalars = read_scalars(files[0])
    assert scalars == ref_read(files[0])
    assert any(k.startswith("train/loss") for k in scalars)
    assert sum(len(v) for v in scalars.values()) >= 4
    w = SummaryWriter(str(tmp_path / "w"))
    for i in range(3):
        w.add_scalar("train/loss", 1.0 / (i + 1), i)
    w.close()
    assert [s for s, _ in ref_read(w.path)["train/loss"]] == [0, 1, 2]


def test_checkpoint_earlystopping_lrscheduler_progbar(tmp_path, capsys):
    ck = paddle.callbacks.ModelCheckpoint(save_freq=1,
                                          save_dir=str(tmp_path / "ck"))
    es = paddle.callbacks.EarlyStopping(monitor="acc", mode="max",
                                        patience=0)
    es.best = 2.0      # nothing beats it: stop after the first epoch
    _tiny_fit(paddle, tmp_path, [ck, es, paddle.callbacks.ProgBarLogger(
        log_freq=1, verbose=1)], epochs=3)
    saved = sorted(os.listdir(tmp_path / "ck"))
    assert saved == ["0.pdopt", "0.pdparams", "final.pdopt",
                     "final.pdparams"]
    assert "samples/sec" in capsys.readouterr().out
    net = paddle.nn.Linear(2, 2)
    sched = paddle.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.SGD(sched, parameters=net.parameters()),
                  paddle.nn.MSELoss())
    data = paddle.io.TensorDataset([np.ones((4, 2), np.float32),
                                    np.ones((4, 2), np.float32)])
    model.fit(data, batch_size=2, epochs=1, verbose=0)
    assert sched.last_epoch == 2


def test_summary_and_flops():
    from paddle_tpu_torch.vision.models import LeNet
    info = [P.summary(P.vision.models.LeNet()) for P in (ref, paddle)]
    assert info[1] == info[0] and info[1]["total_params"] > 60000
    assert paddle.flops(LeNet(), [1, 1, 28, 28]) == \
        ref.flops(ref.vision.models.LeNet(), [1, 1, 28, 28])
    net = paddle.nn.Sequential(paddle.nn.Linear(8, 4), paddle.nn.ReLU())
    assert paddle.flops(net, [2, 8], custom_ops={
        paddle.nn.ReLU: lambda layer, i, o: 1000}) == 2 * 4 * 8 * 2 + 1000


def test_metrics():
    rs = np.random.RandomState(0)
    pred = rs.rand(20, 5).astype(np.float32)
    label = rs.randint(0, 5, (20, 1)).astype(np.int64)
    prob = rs.rand(40).astype(np.float32)
    lab2 = rs.randint(0, 2, 40).astype(np.int64)
    got = []
    for P in (ref, paddle):
        acc = P.metric.Accuracy(topk=(1, 3))
        acc.update(acc.compute(P.to_tensor(pred), P.to_tensor(label)))
        res = [acc.accumulate(), acc.name()]
        for cls in (P.metric.Precision, P.metric.Recall, P.metric.Auc):
            m = cls()
            m.update(P.to_tensor(prob), P.to_tensor(lab2))
            res.append(m.accumulate())
        res.append(float(np.asarray(P.metric.accuracy(
            P.to_tensor(pred), P.to_tensor(label), k=2).numpy())))
        got.append(res)
    assert got[1][1] == ["acc_top1", "acc_top3"]
    np.testing.assert_allclose(got[1][0], got[0][0])
    np.testing.assert_allclose(got[1][2:], got[0][2:], rtol=1e-6)
