"""chip_smoke.py phase 29's cases on the card at small sizes: two rank
processes started by ``launch_mod.spawn`` share the card over gloo, as
phase 29's do.

* a 4-block GPT (hidden 256, 4 heads, vocab 1024, [8, 256]) at pp = 2
  (4 microbatches, 1F1B), 3 f32 AdamW steps: the stages' losses equal
  and within 1e-5 of one process's on the card, the tied embedding's two
  copies bit-equal, K1-K3 = 2 blocks x 4 microbatches x 3 steps a stage
  and K5-K7 = 12 on the last; each stage's parameters only what it runs
  (at most 0.6 of the model's bytes); then each stage's peak device memory
  (``torch.cuda.max_memory_allocated`` over a step) at 1, 2, 4 and 8
  microbatches of the same size: from 2 to 8 it grows by less than half
  of one microbatch's activations (the first stage's growth from 1 to
  2), where the batch grows 4 times;
* the same GPT under ZeRO os_g at sharding = 2: the mean of the ranks'
  losses within 1e-5 of one process's, each rank's optimizer state and
  the grads it holds after the backward at most 0.6 of one process's,
  the train state saved sharded and loaded in this process bit for bit;
* the MoE layer (d 64, hidden 128, 4 experts, top-2, 512 tokens) at
  ep = 2 against one process's, within 1e-5 of each largest element.

Marked ``cuda``: without a CUDA device every test skips. On a machine
with a card and no JAX, run them without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_dist_cuda.py
"""
import json
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=1024, hidden_size=256, num_layers=4, num_heads=4,
           max_seq_len=256, dropout=0.0)
BATCH, SEQ, STEPS, ACC, LR = 8, 256, 3, 4, 1e-3
MOE = dict(d_model=64, d_hidden=128, num_experts=4, top_k=2)


def _gpt(**knobs):
    from paddle_tpu_torch.text import models
    cfg = models.TransformerLMConfig(**CFG, **knobs)
    return models.GPTForCausalLM(cfg, generator=torch.Generator()
                                 .manual_seed(25)).train()


def _ids(batch=BATCH):
    return torch.from_numpy(np.random.RandomState(0).randint(
        0, CFG["vocab_size"], (batch, SEQ)).astype(np.int64)).cuda()


def _opt(params):
    from paddle_tpu_torch import optimizer
    return optimizer.AdamW(LR, parameters=params, weight_decay=0.01)


def _fleet(**degrees):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = degrees
    s.pipeline_configs = {"accumulate_steps": ACC}
    s.sharding_configs = {"stage": 2}
    fleet.init(is_collective=True, strategy=s)
    return fleet


def _counters():
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import fused_ce as tce
    return (attn.flash_attention_forward, attn.flash_bwd_dq,
            attn.flash_bwd_dkv, tce.fused_ce_forward, tce.fused_ce_bwd_dx,
            tce.fused_ce_bwd_dw)


def rank_main(case, outdir):
    """One rank of a case (started by launch_mod.spawn)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    from paddle_tpu_torch.distributed import (collective, init_parallel_env,
                                              sharding, topology)
    env = init_parallel_env(timeout=120)
    res = {"rank": env.rank}
    ids = _ids()
    if case == "pp":
        fleet = _fleet(pp_degree=2)
        model = fleet.distributed_model(_gpt())
        opt = fleet.distributed_optimizer(_opt(
            model._layers.named_parameters()))
        for fn in _counters():
            fn.launches = 0
        res["losses"] = [float(model.train_batch((ids, ids), opt))
                         for _ in range(STEPS)]
        res["launches"] = [fn.launches for fn in _counters()]
        w = model._layers.gpt.word_embeddings.weight.detach().clone()
        other = w.clone()
        collective.broadcast(other, src=1, group=model._pp)
        res["tied_equal"] = bool(torch.equal(w, other))
        leaves = list(model._layers.parameters())
        res["held"] = sum(p.untyped_storage().nbytes() for p in leaves)
        res["runs"] = sum(p.numel() * p.element_size() for p in model._local)
        res["whole"] = sum(p.numel() * p.element_size() for p in leaves)
        mb = BATCH // ACC
        for m in (1, 2, 4, 8):
            model._acc_steps = m
            batch = _ids(mb * m)
            model.train_batch((batch, batch), opt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            model.train_batch((batch, batch), opt)
            torch.cuda.synchronize()
            res[f"peak{m}"] = torch.cuda.max_memory_allocated() - base
    elif case == "zero":
        fleet = _fleet(sharding_degree=2)
        m = _gpt()
        model = fleet.distributed_model(m)
        opt = fleet.distributed_optimizer(_opt(m.named_parameters()))
        per = BATCH // 2
        mine = ids[env.rank * per:(env.rank + 1) * per]
        losses = []
        for _ in range(STEPS):
            loss = model(mine, labels=mine)
            loss.backward()
            res.setdefault("grad_elems", sum(
                p.grad.numel() for p in m.parameters() if p.grad is not None))
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        res["losses"] = losses
        res["state_bytes"] = sharding.state_bytes(opt)
        from paddle_tpu_torch.incubate.checkpoint import sharded
        sharded.save_sharded_train_state(dict(m.named_parameters()), opt,
                                         os.path.join(outdir, "zero"))
        names = {id(p): n for n, p in m.named_parameters()}
        torch.save({f"{names[pid]}_{kind}": t.cpu()
                    for kind, store in opt._inner_opt._accumulators.items()
                    for pid, t in store.items()},
                   os.path.join(outdir, f"zero_state{env.rank}.pt"))
        torch.save({k: v.detach().cpu() for k, v in m.named_parameters()},
                   os.path.join(outdir, "zero_params.pt"))
    else:
        _fleet(mp_degree=2)
        y, grads = _moe_run()
        torch.save({"y": y, **grads},
                   os.path.join(outdir, f"moe{env.rank}.pt"))
    topology.reset()
    with open(os.path.join(outdir, f"{case}{env.rank}.json"), "w") as f:
        json.dump(res, f)


def _moe_run():
    from paddle_tpu_torch.incubate import moe
    layer = moe.MoELayer(capacity_factor=1.25, device="cuda",
                         generator=torch.Generator().manual_seed(5), **MOE)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(512, MOE["d_model"], generator=g).cuda()
    cot = torch.randn(512, MOE["d_model"], generator=g).cuda()
    x.requires_grad_()
    y = layer(x)
    ((y * cot).sum() + layer.aux_loss).backward()
    grads = {"dx": x.grad.cpu(), "aux": layer.aux_loss.detach().cpu()}
    for k in ("gate", "w1", "b1", "w2", "b2"):
        grads["d" + k] = getattr(layer, k).grad.cpu()
    return y.detach().cpu(), grads


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def spawned(card, tmp_path_factory):
    """Each case's two ranks, run once for the module."""
    from paddle_tpu_torch.distributed import launch_mod
    done = {}

    def get(case):
        if case not in done:
            outdir = str(tmp_path_factory.mktemp(case))
            launch_mod.spawn(rank_main, args=(case, outdir), nprocs=2)
            done[case] = outdir, [json.load(open(os.path.join(
                outdir, f"{case}{r}.json"))) for r in range(2)]
        return done[case]
    return get


def _one_process():
    m = _gpt()
    opt = _opt(m.named_parameters())
    ids = _ids()
    losses = []
    for _ in range(STEPS):
        loss = m(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses


def test_pipeline_two_stages_on_the_card(spawned):
    _, ranks = spawned("pp")
    want = _one_process()
    a, b = (r["losses"] for r in ranks)
    assert a == b
    np.testing.assert_allclose(a, want, rtol=1e-5)
    assert all(r["tied_equal"] for r in ranks)
    blocks = CFG["num_layers"] // 2
    for s, r in enumerate(ranks):
        assert r["launches"] == [blocks * ACC * STEPS] * 3 \
            + [ACC * STEPS * s] * 3


def test_pipeline_stage_holds_its_share_of_the_weights(spawned):
    """Each stage's parameters hold storage for what it runs alone: its 2
    of 4 blocks and its end of the model (the tied embedding on both),
    at most 0.6 of the model's bytes at this shape."""
    _, ranks = spawned("pp")
    for r in ranks:
        assert r["held"] == r["runs"], r
        assert r["held"] <= 0.6 * r["whole"], r


def test_pipeline_peak_memory_flat_in_microbatches(spawned):
    """At a fixed microbatch size, each stage's peak over a step at 1, 2,
    4 and 8 microbatches: the first stage's grows by one microbatch's
    activations from 1 to 2 (1F1B keeps at most pp = 2 alive on it), and
    neither stage's grows by half of that from 2 to 8, where a schedule
    that ran every forward first would hold 6 more."""
    _, ranks = spawned("pp")
    peaks = [[r[f"peak{m}"] for m in (1, 2, 4, 8)] for r in ranks]
    one = peaks[0][1] - peaks[0][0]
    assert one > 0, peaks
    for p in peaks:
        assert p[3] - p[1] <= 0.5 * one, (peaks, one)


def test_zero2_on_the_card_and_its_checkpoint(spawned):
    from paddle_tpu_torch.incubate.checkpoint import sharded
    outdir, ranks = spawned("zero")
    want = _one_process()
    mean = np.mean([r["losses"] for r in ranks], axis=0)
    np.testing.assert_allclose(mean, want, rtol=1e-5)
    m = _gpt()
    whole = sum(2 * p.numel() * 4 + 8 for p in m.parameters())
    assert max(r["state_bytes"] for r in ranks) <= 0.6 * whole
    elems = sum(p.numel() for p in m.parameters())
    assert max(r["grad_elems"] for r in ranks) <= 0.6 * elems
    assert sum(r["grad_elems"] for r in ranks) == elems
    opt = _opt(m.named_parameters())
    sharded.load_sharded_train_state(os.path.join(outdir, "zero"),
                                     dict(m.named_parameters()), opt)
    params = torch.load(os.path.join(outdir, "zero_params.pt"))
    for k, p in m.named_parameters():
        assert torch.equal(p.detach().cpu(), params[k]), k
    names = {id(p): n for n, p in m.named_parameters()}
    got = {f"{names[pid]}_{kind}": t.cpu()
           for kind, store in opt._accumulators.items()
           for pid, t in store.items()}
    state = {}
    for r in range(2):
        state.update(torch.load(os.path.join(outdir, f"zero_state{r}.pt")))
    assert set(got) == set(state)
    for k, v in state.items():
        assert torch.equal(got[k], v), k


def test_moe_ep2_on_the_card(spawned):
    outdir, _ = spawned("moe")
    y, grads = _moe_run()
    want = {"y": y, **grads}
    el = MOE["num_experts"] // 2
    for r in range(2):
        got = torch.load(os.path.join(outdir, f"moe{r}.pt"))
        for k, w in want.items():
            if k in ("dw1", "db1", "dw2", "db2"):
                w = w[r * el:(r + 1) * el]
            err = float((got[k] - w).abs().max())
            assert err <= 1e-5 * max(float(w.abs().max()), 1e-30), (k, err)
