"""paddle_tpu_torch's BERT (``BertModel``, ``BertForPretraining``,
``bert_base``) against the JAX package's on the CPU.

A 2-layer BERT at width 64 (one head of 64, so the port's attention is
the flash path's plain version; and four heads of 16) built in the
reference, its weights carried into the port through
``text.convert.state_dict_from_paddle_tpu`` (the token-type table, the
pooler, the MLM transform and its LayerNorm, the NSP head and the MLM
head tied to the word embeddings). On ``bench_bert``'s synthetic batch
(``tools/baseline_bench.py:108-115``: ids, zero token types, MLM labels
at 15 % and -1 elsewhere, NSP labels ``[b, 1]``) at 2 x 32: the MLM
logits, the loss and every grad; ``BertModel``'s hidden states and
pooled output with an additive mask; 3 AdamW steps (the losses and every
parameter); and a reference AdamW state carried in through
``text.convert.optimizer_state_from_paddle_tpu`` continuing as the
reference continues. f32, no TF32: forward rtol/atol 1e-5, grads 1e-4
of each tensor's largest grad, each parameter's move within 1e-3 of the
reference's move in L2 and every element within Adam's bound of 2 x lr
a step (``_params_close``). Then ``bert_base``'s config and its
weights from an explicit generator, torch's global RNG untouched.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu.text import models as rmodels
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text import models as tmodels
from paddle_tpu_torch.text.convert import (optimizer_state_from_paddle_tpu,
                                           state_dict_from_paddle_tpu,
                                           state_dict_to_paddle_tpu)

SMALL = dict(vocab_size=97, hidden_size=64, num_layers=2, max_seq_len=32,
             dropout=0.0)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _pair(heads=1, seed=0):
    ref.seed(seed)
    r = rmodels.BertForPretraining(rmodels.TransformerLMConfig(
        num_heads=heads, **SMALL))
    t = tmodels.BertForPretraining(
        tmodels.TransformerLMConfig(num_heads=heads, **SMALL), device="cpu")
    sd = {k: np.asarray(v.numpy()) for k, v in r.state_dict().items()}
    t.load_state_dict(state_dict_from_paddle_tpu(sd))
    return r, t


def _batch(b=2, seq=32, vocab=97, seed=0):
    """bench_bert's data (tools/baseline_bench.py:108-115) at b x seq."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, seq)).astype("int64")
    tok = np.zeros((b, seq), "int64")
    mlm = np.where(rs.rand(b, seq) < 0.15,
                   rs.randint(0, vocab, (b, seq)), -1).astype("int64")
    nsp = rs.randint(0, 2, (b, 1)).astype("int64")
    return ids, tok, mlm, nsp


def _close_rel(got, want, tol, msg):
    top = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * top, f"{msg}: {err} > {tol} x {top}"


def _port_grads(t):
    return state_dict_to_paddle_tpu(
        {n: p.grad for n, p in t.named_parameters() if p.grad is not None})


@pytest.mark.parametrize("heads", [1, 4])
def test_pretraining_loss_logits_and_grads_match_reference(heads):
    r, t = _pair(heads)
    ids, tok, mlm, nsp = _batch()
    rl = r(*(ref.to_tensor(a) for a in (ids, tok)))
    tl = t(*(torch.from_numpy(a) for a in (ids, tok)))
    np.testing.assert_allclose(tl.detach().numpy(), rl.numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)
    rloss = r(*(ref.to_tensor(a) for a in (ids, tok, mlm, nsp)))
    tloss = t(*(torch.from_numpy(a) for a in (ids, tok, mlm, nsp)))
    np.testing.assert_allclose(float(tloss.detach()), float(rloss.numpy()),
                               rtol=FWD_TOL)
    rloss.backward()
    tloss.backward()
    names = {p.name: n for n, p in r.named_parameters()}
    want = {names[p.name]: np.asarray(p.grad.numpy())
            for p in r.parameters() if p.grad is not None}
    got = _port_grads(t)
    # ln_f is kept but not applied by a post-norm core: no grad in either
    assert "bert.ln_f.weight" not in want
    assert t.bert.ln_f.weight.grad is None
    assert set(want) == {n for n, p in t.named_parameters()
                         if p.grad is not None}
    for n, w in want.items():
        _close_rel(got[n], w, GRAD_TOL, n)


def test_bert_model_with_a_mask_matches_reference():
    r, t = _pair(heads=1, seed=2)
    ids, tok, _, _ = _batch(seed=3)
    rs = np.random.RandomState(4)
    mask = np.where(rs.rand(2, 1, 1, 32) < 0.8, 0.0, -1e9).astype("float32")
    rh, rp = r.bert(ref.to_tensor(ids), ref.to_tensor(tok),
                    ref.to_tensor(mask))
    th, tp = t.bert(torch.from_numpy(ids), torch.from_numpy(tok),
                    torch.from_numpy(mask))
    np.testing.assert_allclose(th.detach().numpy(), rh.numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(tp.detach().numpy(), rp.numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)


def _ref_step(r, ropt, batch):
    loss = r(*(ref.to_tensor(a) for a in batch))
    loss.backward()
    ropt.step()
    ropt.clear_grad()
    return float(loss.numpy())


def _port_step(t, topt, batch):
    loss = t(*(torch.from_numpy(a) for a in batch))
    loss.backward()
    topt.step()
    topt.clear_grad()
    return float(loss.detach())


def _params_close(r, t, before, lr, steps):
    """Each parameter's move against the reference's move from
    ``before``: the L2 norm of their difference within 1e-3 of the
    reference move's, and every element within 2 x lr a step. Adam moves
    an element whose grad is rounding noise by up to lr either way (the
    key third of each QKV bias, whose true grad is 0, and a few elements
    of the others), so the elements are held to Adam's bound and the
    tensor to the norm, as chip_smoke.py's phase 12 holds the card to
    the CPU."""
    names = {p.name: n for n, p in r.named_parameters()}
    got = state_dict_to_paddle_tpu(dict(t.named_parameters()))
    h = SMALL["hidden_size"]
    for p in r.parameters():
        name = names[p.name]
        g, w, b = got[name], np.asarray(p.numpy()), before[name]
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr * steps,
                                   err_msg=name)
        if name.endswith("attn.qkv.bias"):
            g, w, b = (np.delete(a, np.s_[h:2 * h]) for a in (g, w, b))
        diff = float(np.linalg.norm(g - w))
        move = float(np.linalg.norm(w - b))
        assert diff <= 1e-3 * move, f"{name}: {diff} > 1e-3 x {move}"


def test_three_adamw_steps_match_reference():
    r, t = _pair(heads=1, seed=5)
    before = {k: np.asarray(v.numpy()) for k, v in r.state_dict().items()}
    ropt = ref.optimizer.AdamW(1e-3, parameters=r.parameters(),
                               weight_decay=0.01)
    topt = AdamW(1e-3, parameters=t.named_parameters(), weight_decay=0.01)
    for i in range(3):
        batch = _batch(seed=10 + i)
        rl, tl = _ref_step(r, ropt, batch), _port_step(t, topt, batch)
        np.testing.assert_allclose(tl, rl, rtol=FWD_TOL * 10)
    _params_close(r, t, before, 1e-3, 3)


def test_reference_adamw_state_carries_into_the_port():
    r, t = _pair(heads=1, seed=6)
    ropt = ref.optimizer.AdamW(1e-3, parameters=r.parameters(),
                               weight_decay=0.01)
    _ref_step(r, ropt, _batch(seed=20))
    sd = {k: np.asarray(v.numpy()) for k, v in r.state_dict().items()}
    t.load_state_dict(state_dict_from_paddle_tpu(sd))
    before = sd
    state = {k: (v if k == "LR_Scheduler" else np.asarray(v.numpy()))
             for k, v in ropt.state_dict().items()}
    names = {p.name: n for n, p in r.named_parameters()}
    topt = AdamW(1e-3, parameters=t.named_parameters(), weight_decay=0.01)
    topt.set_state_dict(optimizer_state_from_paddle_tpu(state, names))
    for i in range(2):
        batch = _batch(seed=21 + i)
        rl, tl = _ref_step(r, ropt, batch), _port_step(t, topt, batch)
        np.testing.assert_allclose(tl, rl, rtol=FWD_TOL * 10)
    _params_close(r, t, before, 1e-3, 2)


def test_bert_base_config_and_explicit_generator():
    before = torch.random.get_rng_state()
    small = dict(vocab_size=97, max_seq_len=16, num_layers=1, dropout=0.0)
    a = tmodels.BertForPretraining(tmodels.TransformerLMConfig(
        hidden_size=64, num_heads=1, **small), device="cpu",
        generator=torch.Generator().manual_seed(1))
    b = tmodels.BertForPretraining(tmodels.TransformerLMConfig(
        hidden_size=64, num_heads=1, **small), device="cpu",
        generator=torch.Generator().manual_seed(1))
    assert torch.equal(torch.random.get_rng_state(), before)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    w = a.bert.blocks[0].attn.qkv.weight
    assert abs(float(w.detach().std()) - 0.02) < 0.002
    assert torch.equal(a.bert.blocks[0].ln1.weight, torch.ones(64))
    assert torch.equal(a.bert.pooler.bias, torch.zeros(64))
    # bert_base's configuration is the reference's (models.py:858-862)
    cfg = tmodels.TransformerLMConfig(vocab_size=30522, hidden_size=768,
                                      num_layers=12, num_heads=12,
                                      max_seq_len=512)
    rcfg = rmodels.TransformerLMConfig(vocab_size=30522, hidden_size=768,
                                       num_layers=12, num_heads=12,
                                       max_seq_len=512)
    for k in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "intermediate_size", "max_seq_len", "initializer_range"):
        assert getattr(cfg, k) == getattr(rcfg, k), k
    import inspect
    sig = inspect.signature(tmodels.bert_base)
    assert sig.parameters["vocab_size"].default == 30522
    assert sig.parameters["max_seq_len"].default == 512


def test_gpt_core_is_unchanged_by_the_bert_options():
    """The GPT core stays pre-norm and causal, ln_f applied, no
    token-type table."""
    cfg = tmodels.TransformerLMConfig(vocab_size=97, hidden_size=32,
                                      num_layers=1, num_heads=4,
                                      max_seq_len=16, dropout=0.0)
    g = tmodels.GPTForCausalLM(cfg, device="cpu")
    assert g.gpt.token_type_embeddings is None and g.gpt.pre_norm
    assert g.gpt.blocks[0].attn.causal and g.gpt.blocks[0].pre_norm
    assert "gpt.token_type_embeddings.weight" not in g.state_dict()


def test_o1_loss_is_f32_as_the_reference():
    """Under ``auto_cast("O1", "bfloat16")`` the MLM logits are bf16 and
    the loss is f32 in both packages: the bf16 sum of the per-token
    losses over an f32 count of the labelled positions (reference
    nn_ops.py:924). Values within bf16's rounding: 2e-2 relative."""
    from paddle_tpu_torch import amp
    r, t = _pair(heads=1, seed=7)
    batch = _batch(seed=30)
    with ref.amp.auto_cast(level="O1", dtype="bfloat16"):
        rloss = r(*(ref.to_tensor(a) for a in batch))
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        tlogits = t(*(torch.from_numpy(a) for a in batch[:2]))
        tloss = t(*(torch.from_numpy(a) for a in batch))
    assert tlogits.dtype == torch.bfloat16
    assert "float32" in str(rloss.dtype) and tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss.detach()), float(rloss.numpy()),
                               rtol=2e-2)
