"""The port's ASP (``paddle_tpu_torch/incubate/asp.py``) against the
reference's (``paddle_tpu/incubate/asp.py``) on the CPU.

* The mask functions: ``get_mask_1d`` (numpy in, and torch in on the
  tensor's device), ``check_mask_1d``, ``calculate_density`` and
  ``get_mask_2d_greedy`` give the reference's values on random weights,
  on small integers full of ties (zero groups among them), with columns
  not a multiple of 4, on 4-D conv weights and 1-D vectors; 2:4 ties
  drop the reference's pair; the port's plain (numpy) versions are the
  reference's. Masks compare exactly.
* ``prune_model`` on a 2-layer port GPT at head dim 128 (hidden 256, 2
  heads) gives, after ``text.convert``, the reference's masks and
  weights bit for bit, the embeddings pruned as there; a Paddle-surface
  Linear keeps the reference's layout; excluded names are skipped.
* ``decorate(LookAhead(AdamW))`` and ``LookAhead(decorate(AdamW))``
  over 6 AdamW steps against the reference's: losses rtol 1e-5; every
  weight's zeros where the reference's are; every weight within twice
  the largest move any element made in the reference's run and each
  tensor's difference within 1e-3 of its move, in L2
  (``tests/test_torch_optimizers.py``'s tolerance for Adam's sign-like
  steps, which turn the packages' rounding differences on a near-zero
  grad into moves of up to lr; the key third of each QKV bias, whose
  true grad is 0, to the elementwise bound alone); LookAhead's slow
  copies (k = 4) within the elementwise bound of the reference's, the
  first order's holding the pruned weights' moves and the second's
  zeros there.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu import incubate as ref_incubate
from paddle_tpu.incubate import asp as ref_asp
from paddle_tpu.text.models import GPTForCausalLM, TransformerLMConfig

import paddle_tpu_torch as paddle
from _torch_port import torch_twin
from paddle_tpu_torch import incubate
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.incubate import asp
from paddle_tpu_torch.text.convert import (is_transposed,
                                           state_dict_to_paddle_tpu)

GPT128 = dict(vocab_size=97, hidden_size=256, num_layers=2, num_heads=2,
              max_seq_len=32, dropout=0.0)


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    asp.reset_excluded_layers()
    ref_asp.reset_excluded_layers()
    yield
    device_mod._current_place = None


def _mats():
    rs = np.random.RandomState(0)
    return {
        "random": rs.randn(8, 16).astype(np.float32),
        # values 0..2: ties everywhere, whole groups of zeros
        "ties": rs.randint(-2, 3, (16, 12)).astype(np.float32),
        "ragged_cols": rs.randn(8, 10).astype(np.float32),
        "conv4d": rs.randn(8, 3, 3, 3).astype(np.float32),
        "vector": rs.randn(10).astype(np.float32),
        "f64_ties": rs.randint(0, 2, (12, 8)).astype(np.float64),
    }


@pytest.mark.parametrize("case", sorted(_mats()))
def test_mask_1d_matches_reference(case):
    mat = _mats()[case]
    want = ref_asp.get_mask_1d(mat, 2, 4)
    got = asp.get_mask_1d(mat, 2, 4)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(asp.get_mask_1d_plain(mat, 2, 4), want)
    dev = asp.get_mask_1d(torch.from_numpy(mat), 2, 4)
    assert dev.dtype == torch.bool
    np.testing.assert_array_equal(dev.numpy(), want > 0)
    for m in (mat, mat * want):
        assert asp.check_mask_1d(m, 2, 4) == ref_asp.check_mask_1d(m, 2, 4)
        assert asp.check_mask_1d(torch.from_numpy(m), 2, 4) == \
            ref_asp.check_mask_1d(m, 2, 4)
        assert asp.check_mask_1d_plain(m, 2, 4) == \
            ref_asp.check_mask_1d(m, 2, 4)
    assert asp.calculate_density(mat * want) == \
        ref_asp.calculate_density(mat * want)
    assert asp.calculate_density(torch.from_numpy(mat * want)) == \
        ref_asp.calculate_density(mat * want)


def test_mask_1d_two_of_four_ties_every_pattern():
    """Every group of 4 values from 0..3 (all 256, each tie pattern):
    the port drops the reference's pair."""
    import itertools
    rows = np.array(list(itertools.product(range(4), repeat=4)),
                    np.float32)
    np.testing.assert_array_equal(asp.get_mask_1d(rows, 2, 4),
                                  ref_asp.get_mask_1d(rows, 2, 4))


@pytest.mark.parametrize("n,m", [(1, 4), (2, 8), (4, 8)])
def test_mask_1d_other_ratios_without_ties(n, m):
    mat = np.random.RandomState(n * 10 + m).randn(8, 24).astype(np.float32)
    np.testing.assert_array_equal(asp.get_mask_1d(mat, n, m),
                                  ref_asp.get_mask_1d(mat, n, m))


@pytest.mark.parametrize("case", ["random", "ties", "ragged_cols"])
def test_mask_2d_greedy_matches_reference(case):
    mat = _mats()[case][:, :10] if case != "random" else _mats()[case]
    want = ref_asp.get_mask_2d_greedy(mat, 2, 4)
    np.testing.assert_array_equal(asp.get_mask_2d_greedy(mat, 2, 4), want)
    dev = asp.get_mask_2d_greedy(torch.from_numpy(mat), 2, 4)
    np.testing.assert_array_equal(dev.numpy(), want > 0)


def _ref_gpt(seed=3, **kw):
    ref.seed(seed)
    m = GPTForCausalLM(TransformerLMConfig(**{**GPT128, **kw}))
    return m


def _ref_layout(port_masks):
    return {n: (m.t() if is_transposed(n, m.dim()) else m).numpy()
            for n, m in port_masks.items()}


def test_prune_model_gpt_head_dim_128_matches_reference():
    jm = _ref_gpt()
    tm = torch_twin(jm)
    want = ref_asp.prune_model(jm, n=2, m=4)
    got = asp.prune_model(tm, n=2, m=4)
    assert set(got) == set(want)
    # the embeddings are pruned, as the reference prunes them
    assert {"gpt.word_embeddings.weight",
            "gpt.position_embeddings.weight"} <= set(got)
    assert all(m.dtype == torch.bool for m in got.values())
    for name, mask in _ref_layout(got).items():
        np.testing.assert_array_equal(mask, want[name] > 0, err_msg=name)
    jsd = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    tsd = state_dict_to_paddle_tpu(dict(tm.named_parameters()))
    for name, v in jsd.items():
        np.testing.assert_array_equal(tsd[name], v, err_msg=name)
        if name in want:
            assert ref_asp.check_mask_1d(tsd[name], 2, 4)


def test_prune_model_surface_linear_and_excluded_layers():
    """A Paddle-surface Linear ([in, out] in both packages) is pruned in
    place, not transposed; an excluded name is skipped."""
    w = np.random.RandomState(1).randn(8, 12).astype(np.float32)
    nets = []
    for P in (ref, paddle):
        net = P.nn.Linear(8, 12)
        net.weight.set_value(w)
        nets.append(net)
    want = ref_asp.prune_model(nets[0])
    got = asp.prune_model(nets[1])
    assert set(got) == set(want) == {"weight"}
    np.testing.assert_array_equal(got["weight"].numpy(), want["weight"] > 0)
    np.testing.assert_array_equal(nets[1].weight.numpy(),
                                  np.asarray(nets[0].weight.numpy()))
    net = paddle.nn.Linear(8, 8)
    asp.set_excluded_layers([net.weight.name])
    assert asp.prune_model(net) == {}
    asp.reset_excluded_layers()
    assert set(asp.prune_model(net)) == {"weight"}


def _ids(step):
    rs = np.random.RandomState(40 + step)
    return rs.randint(0, GPT128["vocab_size"], (2, 16)).astype(np.int64)


def _train(model, opt, is_ref, clear):
    losses = []
    for step in range(6):
        ids = _ids(step)
        x = ref.to_tensor(ids) if is_ref else torch.from_numpy(ids)
        loss = model(x, labels=x)
        loss.backward()
        opt.step()
        clear()
        losses.append(float(loss.numpy() if is_ref else loss.detach()))
    return losses


def _wrapped(order, inc, asp_mod, adamw):
    """(the optimizer to step, its LookAhead)."""
    if order == "decorate(LookAhead)":
        la = inc.LookAhead(adamw, alpha=0.5, k=4)
        return asp_mod.decorate(la), la
    la = inc.LookAhead(asp_mod.decorate(adamw), alpha=0.5, k=4)
    return la, la


def _asp_lookahead_run(order):
    lr = 1e-2
    jm = _ref_gpt()
    tm = torch_twin(jm).train()
    jm.train()
    ref_asp.prune_model(jm)
    asp.prune_model(tm)
    init = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    jinner = ref.optimizer.AdamW(lr, parameters=jm.parameters(),
                                 weight_decay=0.01)
    jopt, jla = _wrapped(order, ref_incubate, ref_asp, jinner)
    topt_, tla = _wrapped(order, incubate, asp, topt.AdamW(
        lr, parameters=tm.named_parameters(), weight_decay=0.01))
    # the reference's decorate(LookAhead).clear_grad() passes set_to_zero
    # to LookAhead.clear_grad(), which takes no argument: its grads are
    # cleared on the inner AdamW (the same effect)
    jl = _train(jm, jopt, True, jinner.clear_grad)
    tl = _train(tm, topt_, False, topt_.clear_grad)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jsd = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    tsd = state_dict_to_paddle_tpu(dict(tm.named_parameters()))
    for name, v in jsd.items():
        t = tsd[name]
        if v.ndim == 2:
            np.testing.assert_array_equal(t == 0, v == 0, err_msg=name)
        # Adam's sign-like steps: every element within twice the largest
        # move, each tensor's difference within 1e-3 of its move (L2)
        move = v - init[name]
        assert np.abs(t - v).max() <= 2 * np.abs(move).max(), name
        if name.endswith("attn.qkv.bias"):
            # the key third: its true grad is 0, all rounding noise (held
            # to the elementwise bound alone, as test_torch_optimizers)
            h = GPT128["hidden_size"]
            t, v, move = (np.delete(a, np.s_[h:2 * h])
                          for a in (t, v, move))
        assert np.linalg.norm(t - v) <= 1e-3 * np.linalg.norm(move), name
    # the slow copies (taken at step 4, k = 4), in the reference's layout
    names = [n for n, _ in tm.named_parameters()]
    slow = state_dict_to_paddle_tpu(dict(zip(names, tla._slow)))
    for name, v in zip(names, jla._slow):
        v = np.asarray(v)
        move = v - init[name]
        assert np.abs(slow[name] - v).max() <= 2 * np.abs(move).max(), name
    return slow


def test_asp_lookahead_both_orders_match_reference():
    """Each wrapping order over 6 AdamW steps (LookAhead k = 4) matches
    the reference's, weights and slow copies. decorate(LookAhead) takes
    its slow copy before the masks are applied again, so it holds the
    pruned weights' AdamW moves; LookAhead(decorate) holds zeros there."""
    a = _asp_lookahead_run("decorate(LookAhead)")
    b = _asp_lookahead_run("LookAhead(decorate)")
    pruned = "gpt.blocks.0.mlp.fc1.weight"
    assert np.count_nonzero(b[pruned]) == b[pruned].size // 2
    assert np.count_nonzero(a[pruned]) > a[pruned].size // 2
