"""One rank of the port's multi-process tests (tests/test_torch_collective.py,
test_torch_tensor_parallel.py, test_torch_sequence_parallel.py).

    python tests/torch_dist_worker.py SUITE RANK WORLD PORT DIR

starts rank RANK of WORLD on a gloo process group at 127.0.0.1:PORT
(``init_parallel_env``, 60 s timeout), runs every case of SUITE on the
CPU, writes its arrays to DIR/rank{RANK}.npz (inputs the test wrote are
in DIR/inputs.npz) and prints one JSON line. It imports torch and the
port only, never JAX: the tests compare what the ranks wrote with the
reference in their own process. Every rank makes its own values from
numpy seeds the tests repeat (rank ``r`` holds what is block ``r`` of the
reference's global arrays).
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

TINY_GPT = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                max_seq_len=32, dropout=0.0)


def rank_values(rank, seed, shape):
    return np.random.RandomState(seed + rank).randn(*shape).astype(
        np.float32)


def gpt_batch(seed=0, b=2, s=32, vocab=256):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, s)).astype(np.int64)
    labels = rs.randint(0, vocab, (b, s)).astype(np.int64)
    labels[rs.rand(b, s) < 0.2] = -100
    return ids, labels


def tp_ce_inputs(t, h, v, seed):
    """x, W, labels of the TP fused CE cases: a label in every shard and
    ignored rows."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(t, h) * 0.3).astype(np.float32)
    w = (rs.randn(v, h) * 0.3).astype(np.float32)
    lab = rs.randint(0, v, (t,)).astype(np.int64)
    lab[::7] = -100
    g = rs.rand(t).astype(np.float32)
    return x, w, lab, g


def attn_inputs(seed, b=2, h=4, s=32, d=8):
    rs = np.random.RandomState(seed)
    q, k, v, cot = (rs.randn(b, h, s, d).astype(np.float32)
                    for _ in range(4))
    return q, k, v, cot


# ----------------------------------------------------------------- suites

def suite_collective(rank, n, out, inputs):
    from paddle_tpu_torch import Tensor
    from paddle_tpu_torch.distributed import collective as C
    res = {}
    for op in ("sum", "max", "min", "prod", "avg"):
        x = torch.from_numpy(rank_values(rank, 10, (4, 3)))
        C.all_reduce(x, op=op)
        out[f"all_reduce_{op}"] = x.numpy()
    t = Tensor(rank_values(rank, 10, (4, 3)))
    C.all_reduce(t)     # a port Tensor, through the lazy flush
    out["all_reduce_tensor"] = t.numpy()
    gl = C.all_gather([], torch.from_numpy(rank_values(rank, 20, (2, 3))))
    out["all_gather"] = torch.stack(gl).numpy()
    x = torch.from_numpy(rank_values(rank, 30, (3,)))
    C.broadcast(x, src=n - 1)
    out["broadcast"] = x.numpy()
    x = torch.from_numpy(rank_values(rank, 40, (2, 2)))
    C.reduce(x, dst=1)
    out["reduce"] = x.numpy()
    y = torch.zeros(2, 3)
    lst = [torch.from_numpy(rank_values(j, 50, (2, 3))) for j in range(n)] \
        if rank == 0 else None
    C.scatter(y, lst, src=0)
    out["scatter"] = y.numpy()
    ins = [torch.from_numpy(rank_values(rank * n + j, 60, (2, 3)))
           for j in range(n)]
    out["alltoall"] = torch.stack(C.alltoall(ins)).numpy()
    for op in ("sum", "max", "min", "avg"):
        y = torch.zeros(2, 2)
        C.reduce_scatter(y, [torch.from_numpy(rank_values(rank * n + j, 70,
                                                          (2, 2)))
                             for j in range(n)], op=op)
        out[f"reduce_scatter_{op}"] = y.numpy()
    out["reduce_scatter_single"] = C.reduce_scatter(
        torch.from_numpy(rank_values(rank, 80, (2 * n,)))).numpy()
    if rank == 0:
        C.send(torch.from_numpy(rank_values(0, 90, (3,))), dst=1)
    elif rank == 1:
        y = torch.zeros(3)
        C.recv(y, src=0)
        out["recv"] = y.numpy()
    C.barrier()
    errors = {}
    for name, fn in (
            ("alltoall_count", lambda: C.alltoall(ins[:-1])),
            ("alltoall_shapes", lambda: C.alltoall(
                [torch.zeros(j + 1) for j in range(n)])),
            ("reduce_dst_range", lambda: C.reduce(torch.zeros(2), dst=n + 3)),
            ("reduce_scatter_indivisible", lambda: C.reduce_scatter(
                torch.zeros(2 * n + 1))),
            ("broadcast_src", lambda: C.broadcast(torch.zeros(2), src=n)),
            ("unknown_op", lambda: C.all_reduce(torch.zeros(2), op="xor"))):
        try:
            fn()
            errors[name] = None
        except ValueError as e:
            errors[name] = type(e).__name__
    sub = C.new_group(list(range(n)))
    res["registry"] = C.get_group(sub.id) is sub and sub.id != 0
    try:
        C.get_group(9999)
        res["unknown_group"] = None
    except Exception as e:  # noqa: BLE001 - the type is what is checked
        res["unknown_group"] = type(e).__name__
    res["errors"] = errors
    from paddle_tpu_torch.core import trace as trace_mod
    try:    # a gloo collective inside a captured step
        with trace_mod.trace_guard(trace_mod.TraceContext("capture")):
            C.all_reduce(torch.ones(2))
        res["capture"] = None
    except trace_mod.ToStaticError:
        res["capture"] = "ToStaticError"
    res["rank"] = C.get_rank(sub)
    res["host_staged"] = dict(C.host_staged)
    if n == 2:
        res.update(_data_parallel(rank, n, out))
    return res


def dp_model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 4))


def dp_batch():
    rs = np.random.RandomState(3)
    return (rs.randn(8, 8).astype(np.float32),
            rs.randn(8, 4).astype(np.float32))


def dp_train(model, xs, ys, steps=3):
    """3 SGD steps of an MSE loss; the losses and the final weights."""
    from paddle_tpu_torch import optimizer
    opt = optimizer.SGD(0.1, parameters=model.parameters())
    losses = []
    for _ in range(steps):
        loss = ((model(torch.from_numpy(xs)) - torch.from_numpy(ys)) ** 2
                ).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def surface_mlp():
    """The same MLP in the Paddle surface (its Layers and Tensors,
    under lazy eager)."""
    import paddle_tpu_torch as paddle
    paddle.seed(0)
    return paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.Tanh(),
                                paddle.nn.Linear(16, 4))


def surface_train(model, xs, ys, steps=3):
    import paddle_tpu_torch as paddle
    opt = paddle.optimizer.SGD(0.1, parameters=model.parameters())
    losses = []
    for _ in range(steps):
        loss = ((model(paddle.to_tensor(xs)) - paddle.to_tensor(ys)) ** 2
                ).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def _data_parallel(rank, n, out):
    from paddle_tpu_torch.distributed import DataParallel
    model = dp_model()
    if rank == 1:   # the broadcast from rank 0 at construction evens it
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    dp = DataParallel(model)
    xs, ys = dp_batch()
    per = 8 // n
    losses = dp_train(dp, xs[rank * per:(rank + 1) * per],
                      ys[rank * per:(rank + 1) * per])
    for i, p in enumerate(model.parameters()):
        out[f"dp_param_{i}"] = p.detach().numpy()
    surface = surface_mlp()
    if rank == 1:
        for p in surface.parameters():
            p.set_value(p.numpy() + 1.0)
    sdp = DataParallel(surface)
    slosses = surface_train(sdp, xs[rank * per:(rank + 1) * per],
                            ys[rank * per:(rank + 1) * per])
    for i, p in enumerate(surface.parameters()):
        out[f"sdp_param_{i}"] = p.numpy()
    return {"dp_losses": losses, "sdp_losses": slosses}


def _fleet(acc=None, stage=None, meta=None, **degrees):
    """fleet.init over ``degrees``; ``meta``: strategy attributes to set
    (the meta-optimizers and their configs)."""
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = degrees
    if acc is not None:
        s.pipeline_configs = {"accumulate_steps": acc}
    if stage is not None:
        s.sharding_configs = {"stage": stage}
    for k, v in (meta or {}).items():
        setattr(s, k, v)
    fleet.init(is_collective=True, strategy=s)
    return fleet


def suite_tp(rank, n, out, inputs):
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers
    fleet = _fleet(mp_degree=n)
    hcg = fleet.get_hybrid_communicate_group()
    g = hcg.get_model_parallel_group()
    res = {"mp_rank": hcg.get_model_parallel_rank(),
           "mp_size": hcg.get_model_parallel_world_size(),
           "dp_size": hcg.get_data_parallel_world_size()}
    _tp_fused_ce(rank, n, g, out, inputs)
    if n != 2:
        return res
    _rng_streams(rank, out)
    _mp_layers(out, inputs, mp_layers)
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.text import convert, models
    ids, labels = gpt_batch()
    for tie in (False, True):
        tag = "tied" if tie else "untied"
        cfg = models.TransformerLMConfig(use_mp=True, tie_embeddings=tie,
                                         **TINY_GPT)
        m = models.GPTForCausalLM(cfg, device="cpu")
        ref = {k[len(tag) + 1:]: inputs[k] for k in inputs.files
               if k.startswith(tag + ".")}
        m.load_state_dict(convert.tp_state_dict_from_paddle_tpu(
            ref, g.rank, g.nranks))
        model = fleet.distributed_model(m)
        opt = fleet.distributed_optimizer(optimizer.AdamW(
            1e-3, parameters=m.named_parameters(),
            grad_clip=ClipGradByGlobalNorm(0.1)))
        res[f"{tag}_clip"] = type(opt._inner_opt._grad_clip).__name__
        losses = []
        for step in range(3):
            loss = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
            loss.backward()
            if step == 0:
                grads = convert.state_dict_to_paddle_tpu(
                    mp_layers.full_tensors(m, grads=True))
                for k, v in grads.items():
                    out[f"{tag}.grad.{k}"] = v
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        res[f"{tag}_losses"] = losses
        for k, v in convert.state_dict_to_paddle_tpu(m.state_dict()).items():
            out[f"{tag}.param.{k}"] = v
        # the shards of a topology-independent state dict, round trip
        shards = []
        for r in range(g.nranks):
            shard = {k: v.clone() for k, v in m.state_dict().items()}
            mine = convert.tp_state_dict_from_paddle_tpu(
                convert.state_dict_to_paddle_tpu(shard), r, g.nranks)
            shards.append(mine)
        local = {k: v for k, v in m.named_parameters()}
        res[f"{tag}_shard_is_mine"] = all(
            torch.equal(shards[g.rank][k], p.detach())
            for k, p in local.items())
    _stacked_meta_clip(fleet, g, inputs, out, res)
    _build_topology_kept(inputs, res)
    C.barrier()
    return res


TP_SGD_LR = 0.1     # SGD: the update is the clipped grad, so the clip shows


def _stacked_meta_clip(fleet, g, inputs, out, res):
    """The tied GPT at mp = 2 (the ``tied`` weights) by SGD with a
    global-norm clip under two meta-optimizers, gradient merge over
    LocalSGD (each the identity at k = 1 on a dp group of one): the clip
    of the optimizer under both must be the hybrid one, its norm summed
    over ``mp``. 3 steps: the losses and the whole weights after."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.text import convert, models
    m = models.GPTForCausalLM(models.TransformerLMConfig(
        use_mp=True, tie_embeddings=True, **TINY_GPT), device="cpu")
    ref = {k[len("tied."):]: inputs[k] for k in inputs.files
           if k.startswith("tied.")}
    m.load_state_dict(convert.tp_state_dict_from_paddle_tpu(
        ref, g.rank, g.nranks))
    model = fleet.distributed_model(m)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": g.nranks}
    strategy.gradient_merge = True
    strategy.gradient_merge_configs = {"k_steps": 1, "avg": True}
    strategy.localsgd = True
    strategy.localsgd_configs = {"k_steps": 1, "begin_step": 1}
    inner = optimizer.SGD(TP_SGD_LR, parameters=m.named_parameters(),
                          grad_clip=ClipGradByGlobalNorm(0.1))
    opt = fleet.distributed_optimizer(inner, strategy=strategy)
    res["stacked_wrappers"] = [type(opt._inner_opt).__name__,
                               type(opt._inner_opt._inner_opt).__name__]
    res["stacked_clip"] = type(inner._grad_clip).__name__
    ids, labels = gpt_batch()
    losses = []
    for _ in range(3):
        loss = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    res["stacked_losses"] = losses
    for k, v in convert.state_dict_to_paddle_tpu(m.state_dict()).items():
        out[f"stacked.param.{k}"] = v


def _build_topology_kept(inputs, res):
    """A model runs on the groups it was built under, whatever the
    topology is when it runs: one built under mp = 2 and run after
    topology.reset(), and one built dense and run under a new mp = 2
    fleet.init, each give the tied model's first loss."""
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.text import convert, models
    ids, labels = (torch.from_numpy(a) for a in gpt_batch())
    ref = {k[len("tied."):]: inputs[k] for k in inputs.files
           if k.startswith("tied.")}
    cfg = models.TransformerLMConfig(use_mp=True, tie_embeddings=True,
                                     **TINY_GPT)
    g = topology.get_hybrid_communicate_group().get_model_parallel_group()
    split = models.GPTForCausalLM(cfg, device="cpu")
    split.load_state_dict(convert.tp_state_dict_from_paddle_tpu(
        ref, g.rank, g.nranks))
    topology.reset()
    dense = models.GPTForCausalLM(cfg, device="cpu")
    dense.load_state_dict(convert.state_dict_from_paddle_tpu(ref))
    res["split_loss_after_reset"] = float(split(ids, labels=labels))
    _fleet(mp_degree=2)
    res["dense_loss_under_mp2"] = float(dense(ids, labels=labels))
    res["dense_is_dense"] = dense.gpt.mp_group is None


def _rng_streams(rank, out):
    """Dropout on replicated activations under the tracker's model-
    parallel stream (the same seed on every rank) draws one mask on every
    rank; the ranks' own streams differ."""
    import paddle_tpu_torch
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        RNGStatesTracker)
    from paddle_tpu_torch.ops import nn_ops
    paddle_tpu_torch.seed(100 + rank)
    own = rng.default_generator(torch.device("cpu"))
    tracker = RNGStatesTracker()
    tracker.add("model_parallel_rng", 1234, device="cpu")
    x = torch.ones(256)
    with tracker.rng_state("model_parallel_rng"):
        out["rng.shared"] = nn_ops.dropout(x, 0.5).numpy()
    out["rng.restored"] = np.array(
        rng.default_generator(torch.device("cpu")) is own)
    out["rng.own"] = nn_ops.dropout(x, 0.5).numpy()


def _mp_layers(out, inputs, mp_layers):
    """Column + Row parallel pair, gather_output / input split forms,
    VocabParallelEmbedding and ParallelCrossEntropy on the reference
    layers' weights (torch layout), with a cotangent."""
    x = torch.from_numpy(inputs["mlp.x"]).requires_grad_(True)
    col = mp_layers.ColumnParallelLinear(8, 16, gather_output=False)
    row = mp_layers.RowParallelLinear(16, 4, input_is_parallel=True)
    col.load_state_dict({"weight": torch.from_numpy(inputs["mlp.w1"]).t(),
                         "bias": torch.from_numpy(inputs["mlp.b1"])})
    row.load_state_dict({"weight": torch.from_numpy(inputs["mlp.w2"]).t(),
                         "bias": torch.from_numpy(inputs["mlp.b2"])})
    y = row(col(x))
    (y * torch.from_numpy(inputs["mlp.cot"])).sum().backward()
    out["mlp.y"] = y.detach().numpy()
    out["mlp.dx"] = x.grad.numpy()
    for name, layer in (("w1", col), ("w2", row)):
        full = mp_layers.full_tensors(layer, grads=True)
        out[f"mlp.d{name}"] = full["weight"].t().numpy()
    out["mlp.db1"] = mp_layers.full_tensors(col, grads=True)["bias"].numpy()
    out["mlp.db2"] = row.bias.grad.numpy()
    col_g = mp_layers.ColumnParallelLinear(8, 16, gather_output=True,
                                           chunks=2)
    col_g.load_state_dict({"weight": torch.from_numpy(inputs["mlp.w1"]).t(),
                           "bias": torch.from_numpy(inputs["mlp.b1"])})
    row_s = mp_layers.RowParallelLinear(16, 4, input_is_parallel=False)
    row_s.load_state_dict({"weight": torch.from_numpy(inputs["mlp.w2"]).t(),
                           "bias": torch.from_numpy(inputs["mlp.b2"])})
    out["mlp.y_gathered"] = row_s(col_g(x)).detach().numpy()
    emb = mp_layers.VocabParallelEmbedding(16, 8)
    emb.load_state_dict({"weight": torch.from_numpy(inputs["emb.w"])})
    ids = torch.from_numpy(inputs["emb.ids"])
    e = emb(ids)
    (e * torch.from_numpy(inputs["emb.cot"])).sum().backward()
    out["emb.y"] = e.detach().numpy()
    out["emb.dw"] = mp_layers.full_tensors(emb, grads=True)["weight"].numpy()
    g = emb.mp_group
    logits = torch.from_numpy(inputs["pce.logits"])
    per = logits.shape[-1] // g.nranks
    local = logits[:, g.rank * per:(g.rank + 1) * per].clone() \
        .requires_grad_(True)
    loss = mp_layers.ParallelCrossEntropy()(
        local, torch.from_numpy(inputs["pce.labels"]))
    loss.sum().backward()
    out["pce.loss"] = loss.detach().numpy()
    out["pce.dlogits"] = local.grad.numpy()


def _tp_fused_ce(rank, n, g, out, inputs):
    from paddle_tpu_torch.ops import fused_ce
    for tag in ("comp", "pallas"):
        x, w, lab, gcot = (inputs[f"ce{n}.{tag}.{k}"] for k in "xwlg")
        per = w.shape[0] // n
        wl = torch.from_numpy(w[g.rank * per:(g.rank + 1) * per].copy())
        xt = torch.from_numpy(x)
        lt = torch.from_numpy(lab)
        loss, lse = fused_ce.tp_forward(xt, wl, lt, g)
        dx, dw = fused_ce.tp_backward(xt, wl, lt, lse,
                                      torch.from_numpy(gcot), g)
        out[f"ce.{tag}.loss"] = loss.numpy()
        out[f"ce.{tag}.lse"] = lse.numpy()
        out[f"ce.{tag}.dx"] = dx.numpy()
        out[f"ce.{tag}.dw"] = dw.numpy()
        # through autograd: per-token loss, grads of sum(loss * g)
        xa = xt.clone().requires_grad_(True)
        wa = wl.clone().requires_grad_(True)
        la = fused_ce.fused_linear_cross_entropy_tp(xa, wa, lt, g)
        (la * torch.from_numpy(gcot)).sum().backward()
        out[f"ce.{tag}.autograd_dx"] = xa.grad.numpy()
        out[f"ce.{tag}.autograd_dw"] = wa.grad.numpy()


def suite_sp(rank, n, out, inputs):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers
    from paddle_tpu_torch.ops import ring_attention as ra
    res = {}
    if n == 4 and "gpt.mpsp" in inputs.files:
        fleet = _fleet(mp_degree=2, sp_degree=2)
        _sp_gpts(fleet, out, inputs, res, mp_layers, [("mpsp", "ring",
                                                        False)])
        from paddle_tpu_torch.distributed import topology
        topology.reset()
    fleet = _fleet(sp_degree=n)
    g = fleet.get_hybrid_communicate_group().get_sequence_parallel_group()
    for causal in (False, True):
        q, k, v, cot = attn_inputs(5)
        blk = q.shape[2] // n
        sl = slice(g.rank * blk, (g.rank + 1) * blk)
        for mode, fn in (("ring", ra.ring_attention),
                         ("ulysses", ra.ulysses_attention)):
            qt, kt, vt = (torch.from_numpy(a[:, :, sl].copy())
                          .requires_grad_(True) for a in (q, k, v))
            o = fn(qt, kt, vt, g, causal=causal)
            (o * torch.from_numpy(cot[:, :, sl])).sum().backward()
            tag = f"{mode}.{int(causal)}"
            out[f"{tag}.o"] = o.detach().numpy()
            out[f"{tag}.dq"] = qt.grad.numpy()
            out[f"{tag}.dk"] = kt.grad.numpy()
            out[f"{tag}.dv"] = vt.grad.numpy()
    # the route of ranks that share a card, on the CPU: every collective
    # gloo takes no CUDA tensor in staged through a host copy
    from paddle_tpu_torch.distributed import collective as C
    real = C._staged
    C._staged = lambda grp, t, op: (grp.backend == "gloo" and (
        grp.backend, op) not in C.CUDA_NATIVE)
    try:
        q, k, v, cot = attn_inputs(5)
        blk = q.shape[2] // n
        sl = slice(g.rank * blk, (g.rank + 1) * blk)
        for mode, fn in (("ring", ra.ring_attention),
                         ("ulysses", ra.ulysses_attention)):
            qt, kt, vt = (torch.from_numpy(a[:, :, sl].copy())
                          .requires_grad_(True) for a in (q, k, v))
            o = fn(qt, kt, vt, g, causal=True)
            (o * torch.from_numpy(cot[:, :, sl])).sum().backward()
            for name, t in (("o", o.detach()), ("dq", qt.grad),
                            ("dk", kt.grad), ("dv", vt.grad)):
                out[f"staged.{mode}.1.{name}"] = t.numpy()
    finally:
        C._staged = real
    res["host_staged"] = dict(C.host_staged)
    if n == 2:
        _sp_gpts(fleet, out, inputs, res, mp_layers,
                 [("ring", "ring", False), ("ring_rc", "ring", True),
                  ("ulysses", "ulysses", False),
                  ("ulysses_rc", "ulysses", True)])
    return res


def _sp_gpts(fleet, out, inputs, res, mp_layers, cases):
    from paddle_tpu_torch.text import convert, models
    ids, labels = gpt_batch(1)
    ref = {k[4:]: inputs[k] for k in inputs.files if k.startswith("ref.")}
    hcg = fleet.get_hybrid_communicate_group()
    mp = hcg.get_model_parallel_group()
    for tag, mode, rc in cases:
        cfg = models.TransformerLMConfig(use_mp=True, use_sp=True,
                                         sp_mode=mode, recompute=rc,
                                         **TINY_GPT)
        m = models.GPTForCausalLM(cfg, device="cpu").train()
        m.load_state_dict(convert.tp_state_dict_from_paddle_tpu(
            ref, mp.rank, mp.nranks))
        model = fleet.distributed_model(m)
        loss = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
        res[f"gpt.{tag}.loss"] = float(loss)
        for k, v in convert.state_dict_to_paddle_tpu(
                mp_layers.full_tensors(m, grads=True)).items():
            out[f"gpt.{tag}.grad.{k}"] = v


# ------------------------------------------------ pipeline, ZeRO, MoE, ...

PP_LR = 0.1       # SGD: the update is the clipped grad, so the clip shows
PP_CLIP = 0.5


def pp_batch(b=8, s=32, vocab=256):
    """ids and labels of the pipeline cases: -100 only in the first of
    the 4 microbatches (rows 0-1), so its share of the kept tokens is not
    a quarter."""
    rs = np.random.RandomState(5)
    ids = rs.randint(0, vocab, (b, s)).astype(np.int64)
    labels = rs.randint(0, vocab, (b, s)).astype(np.int64)
    labels[0:2, ::2] = -100
    return ids, labels


def _port_gpt(inputs, prefix, mp_group=None, **knobs):
    from paddle_tpu_torch.text import convert, models
    cfg = models.TransformerLMConfig(**dict(TINY_GPT, **knobs))
    m = models.GPTForCausalLM(cfg, device="cpu")
    ref = {k[len(prefix) + 1:]: inputs[k] for k in inputs.files
           if k.startswith(prefix + ".")}
    if mp_group is not None:
        sd = convert.tp_state_dict_from_paddle_tpu(ref, mp_group.rank,
                                                   mp_group.nranks)
    else:
        sd = convert.state_dict_from_paddle_tpu(ref)
    m.load_state_dict(sd)
    return m


def _ref_names(named, tag, out, what):
    from paddle_tpu_torch.text import convert
    for k, v in convert.state_dict_to_paddle_tpu(named).items():
        out[f"{tag}.{what}.{k}"] = v


def _pp_train(fleet, inputs, tag, out, steps=3, scaler=None, adam=False,
              name=None, **knobs):
    """The tiny GPT of ``inputs[tag.*]`` through PipelineParallel: its
    eval loss, ``steps`` train_batch steps (SGD, or AdamW, with a
    global-norm clip), the first step's grads as the clip sees them (this
    stage's), the whole state after (full_state_dict), the parameters
    that hold storage on this stage and its copy of the tied embedding
    (where it holds one)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    hcg = fleet.get_hybrid_communicate_group()
    mp = hcg.get_model_parallel_group()
    m = _port_gpt(inputs, tag, mp if mp.nranks > 1 else None,
                  use_mp=mp.nranks > 1, **knobs)
    model = fleet.distributed_model(m)
    clip = ClipGradByGlobalNorm(PP_CLIP)
    inner = optimizer.AdamW(1e-3, parameters=m.named_parameters(),
                            grad_clip=clip) if adam else \
        optimizer.SGD(PP_LR, parameters=m.named_parameters(), grad_clip=clip)
    opt = fleet.distributed_optimizer(inner)
    grads = {}
    step = opt.step

    def first_grads():
        if not grads:
            grads.update({n: p.grad.clone() for n, p in m.named_parameters()
                          if p.grad is not None})
        step()
    opt.step = first_grads
    ids, labels = (torch.from_numpy(inputs[k]) for k in ("pp.ids",
                                                           "pp.labels"))
    tag = name or tag
    res = {f"{tag}_eval": float(model.eval_batch((ids, labels)))}
    gs = amp.GradScaler(init_loss_scaling=1024.0) if scaler else None
    res[f"{tag}_losses"] = [float(model.train_batch((ids, labels), opt,
                                                    scaler=gs))
                            for _ in range(steps)]
    res[f"{tag}_blocks"] = model.stage_blocks
    res[f"{tag}_clip"] = type(inner._grad_clip).__name__
    if mp.nranks == 1:
        _ref_names(grads, tag, out, "grad")
        _ref_names(model.full_state_dict(), tag, out, "param")
        res[f"{tag}_held"] = [k for k, p in m.named_parameters()
                              if p.untyped_storage().size() > 0]
        wemb = m.gpt.word_embeddings.weight
        if wemb.untyped_storage().size():
            out[f"{tag}.wemb"] = wemb.detach().numpy()
    return res


def _surface_pipe(fleet, inputs, tag, layers, steps, name=None,
                  recompute_interval=0):
    """A PipelineLayer of Paddle-surface layers (the reference's
    parameters in order) through PipelineParallel, SGD 0.1."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer
    pipe = PipelineLayer(layers=layers, num_stages=2,
                         loss_fn=paddle.nn.CrossEntropyLoss(),
                         recompute_interval=recompute_interval)
    for i, p in enumerate(pipe.parameters()):
        p.set_value(inputs[f"{tag}.p{i}"])
    model = fleet.distributed_model(pipe)
    opt = fleet.distributed_optimizer(paddle.optimizer.SGD(
        0.1, parameters=pipe.parameters()))
    x = paddle.to_tensor(inputs[f"{tag}.x"])
    y = paddle.to_tensor(inputs[f"{tag}.y"])
    name = name or tag
    return {f"{name}_losses": [float(model.train_batch((x, y), opt))
                               for _ in range(steps)],
            f"{name}_blocks": len(model._segs["blocks"]),
            f"{name}_stage_blocks": model.stage_blocks}


def _masked_linear():
    import paddle_tpu_torch as paddle

    class MaskedLinear(paddle.nn.Layer):
        def __init__(self, d):
            super().__init__()
            self.fc = paddle.nn.Linear(d, d)
            self.register_buffer("keep", paddle.to_tensor(
                np.ones((d,), dtype="int32")))

        def forward(self, x):
            return self.fc(x) * self.keep.astype("float32")
    return MaskedLinear


def suite_pp(rank, n, out, inputs):
    """pp = 2: the tiny GPT (4 blocks, 4 microbatches, -100 in the first
    only) by SGD with a clip, the same with a GradScaler, 5 blocks
    (uneven) by AdamW, and two PipelineLayers of surface layers (an int
    buffer in the second's blocks)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.distributed.fleet.meta_parallel import LayerDesc
    fleet = _fleet(acc=4, pp_degree=n)
    res = {"stage": fleet.get_hybrid_communicate_group().get_stage_id()}
    res.update(_pp_train(fleet, inputs, "pp4l", out, num_layers=4))
    res.update(_pp_train(fleet, inputs, "pp4l", out, steps=2, scaler=True,
                         name="scaled", num_layers=4))
    res.update(_pp_train(fleet, inputs, "pp5l", out, adam=True,
                         num_layers=5))
    # two meta-optimizers over the clipped SGD, each the identity at k = 1
    # on a dp group of one: the clip must still be the hybrid one
    topology.reset()
    fleet = _fleet(acc=4, pp_degree=n, meta=dict(
        gradient_merge=True, gradient_merge_configs={"k_steps": 1},
        localsgd=True, localsgd_configs={"k_steps": 1}))
    res.update(_pp_train(fleet, inputs, "pp4l", out, name="stacked",
                         num_layers=4))
    topology.reset()
    fleet = _fleet(acc=2, pp_degree=n)
    nn = paddle.nn
    descs = [LayerDesc(nn.Linear, 8, 16)] + [LayerDesc(nn.Linear, 16,
                                                       16)] * 4 \
        + [LayerDesc(nn.Linear, 16, 4)]
    res.update(_surface_pipe(fleet, inputs, "layer", descs, 5))
    res.update(_surface_pipe(fleet, inputs, "layer", descs, 5,
                             name="recompute", recompute_interval=1))
    ml = _masked_linear()
    res.update(_surface_pipe(fleet, inputs, "intbuf", [
        LayerDesc(nn.Linear, 8, 16), LayerDesc(ml, 16), LayerDesc(ml, 16),
        LayerDesc(nn.Linear, 16, 4)], 4))
    from paddle_tpu_torch.distributed import collective
    res["staged"] = dict(collective.host_staged)
    return res


def suite_pp4(rank, n, out, inputs):
    """pp = 4 over the 8-block GPT (4 microbatches), then pp = 2 x mp = 2
    (the tied head's vocab-split fused CE on the last stage)."""
    from paddle_tpu_torch.distributed import topology
    fleet = _fleet(acc=4, pp_degree=n)
    res = _pp_train(fleet, inputs, "deep", out, num_layers=8)
    topology.reset()
    fleet = _fleet(acc=4, pp_degree=2, mp_degree=2)
    res.update(_pp_train(fleet, inputs, "pp4l", out, name="ppmp",
                         num_layers=4))
    return res


def _pipe_stage_fn(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


def _pipe_block_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def suite_pipefn(rank, n, out, inputs):
    """distributed.pipeline's functional API at pp = n: pipeline_apply,
    pipeline_loss_and_grad (remat on and off) and pipeline_blocks_apply
    with uneven stages."""
    from paddle_tpu_torch.distributed import pipeline
    _fleet(pp_degree=n)
    t = {k: torch.from_numpy(inputs[k]) for k in inputs.files}
    stacked = pipeline.stack_stage_params(
        [(t[f"fwd.w{s}"], t[f"fwd.b{s}"]) for s in range(n)])
    out["fwd"] = pipeline.pipeline_apply(_pipe_stage_fn, stacked,
                                         t["fwd.x"]).numpy()
    stacked = pipeline.stack_stage_params(
        [(t[f"grad.w{s}"], t[f"grad.b{s}"]) for s in range(n)])
    for remat in (True, False):
        loss, grads = pipeline.pipeline_loss_and_grad(
            _pipe_stage_fn, lambda o, y: ((o - y) ** 2).mean(), stacked,
            t["grad.x"], t["grad.y"], remat=remat)
        out[f"grad.loss.{remat}"] = loss.numpy()
        out[f"grad.dw.{remat}"] = grads[0].numpy()
        out[f"grad.db.{remat}"] = grads[1].numpy()
    blocks = {"w": t["blocks.w"], "b": t["blocks.b"]}
    out["blocks"] = pipeline.pipeline_blocks_apply(
        _pipe_block_fn, blocks, t["blocks.valid"].bool(), t["blocks.h"],
        4).numpy()
    return {}


def suite_pipemem(rank, n, out, inputs):
    """pipeline_loss_and_grad at pp = n over one batch cut into 4 and into
    16 microbatches: the loss, and the most microbatches whose
    activations were alive at once on this stage."""
    from paddle_tpu_torch.distributed import pipeline
    _fleet(pp_degree=n)
    t = {k: torch.from_numpy(inputs[k]) for k in inputs.files}
    mem = {"w": t["mem.w"], "b": t["mem.b"]}
    res = {}
    in_flight = _count_in_flight(pipeline)
    for m in (4, 16):
        x = t["mem.x"].reshape(m, -1, t["mem.x"].shape[-1])
        y = t["mem.y"].reshape(m, -1, t["mem.y"].shape[-1])
        in_flight[:] = [0, 0]
        loss, _ = pipeline.pipeline_loss_and_grad(
            _mem_stage, lambda o, yy: ((o - yy) ** 2).mean(), mem, x, y)
        res[f"loss{m}"] = float(loss)
        res[f"in_flight{m}"] = in_flight[1]
    return res


def _count_in_flight(pipeline):
    """Wrap ``pipeline.run_schedule`` so that its microbatches' forwards
    and backwards are counted: ``[alive now, most alive at once]``, the
    activations a forward made and no backward has consumed yet."""
    seen = [0, 0]
    run = pipeline.run_schedule

    def counted(p2p, m, forward_step, backward_step=None):
        def fwd(i, x):
            seen[0] += 1
            seen[1] = max(seen)
            return forward_step(i, x)

        def bwd(i, out, grad):
            seen[0] -= 1
            return backward_step(i, out, grad)
        return run(p2p, m, fwd, backward_step and bwd)
    pipeline.run_schedule = counted
    return seen


def _mem_stage(params, x):
    for w, b in zip(params["w"], params["b"]):
        x = torch.tanh(x @ w + b)
    return x


ZERO_LR = 1e-3


def zero_batch(b=8, s=32, vocab=256):
    """The ZeRO cases' batch: no ignored labels, so the mean of the two
    ranks' half-batch losses is the whole batch's."""
    rs = np.random.RandomState(9)
    return (rs.randint(0, vocab, (b, s)).astype(np.int64),
            rs.randint(0, vocab, (b, s)).astype(np.int64))


def _zero_run(rank, n, out, inputs, tag, make):
    """3 AdamW steps (decay off for biases, a global-norm clip) of the
    tiny GPT on this rank's half of zero_batch, through ``make(model,
    opt) -> (model, opt)``: the losses, this rank's optimizer-state bytes,
    the elements of the grads it held after the first backward (before
    the step), its partition's elements and the whole weights after."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    m = _port_gpt(inputs, "zero")
    opt = optimizer.AdamW(ZERO_LR, parameters=m.named_parameters(),
                          grad_clip=ClipGradByGlobalNorm(0.1),
                          apply_decay_param_fun=lambda name:
                          not name.endswith("bias"))
    model, opt = make(m, opt)
    ids, labels = (torch.from_numpy(a) for a in zero_batch())
    per = ids.shape[0] // n
    mine = slice(rank * per, (rank + 1) * per)
    losses, held = [], None
    for _ in range(3):
        loss = model(ids[mine], labels=labels[mine])
        loss.backward()
        if held is None:
            held = sum(p.grad.numel() for p in m.parameters()
                       if p.grad is not None)
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    with sharding.gathered(m):
        _ref_names({k: v.detach().clone() for k, v in m.named_parameters()},
                   tag, out, "param")
    return {f"{tag}_losses": losses,
            f"{tag}_state_bytes": sharding.state_bytes(opt),
            f"{tag}_grad_elems": held,
            f"{tag}_mine": opt._sharding.sizes[rank]}


SCALED_LR = 0.1


def scaled_batches():
    """The ZeRO GradScaler case's three batches of 8 rows (each rank takes
    its half): the second has 1e30 in row 5 (rank 1's half), which
    overflows that rank's grads only."""
    rs = np.random.RandomState(17)
    xs = [rs.randn(8, 8).astype(np.float32) for _ in range(3)]
    ys = [rs.randn(8, 4).astype(np.float32) for _ in range(3)]
    xs[1][5, 3] = 1e30
    return xs, ys


def _zero_scaled(rank, n, out, inputs, level):
    """A Linear-ReLU-Linear MLP (the reference's weights) under ZeRO at
    ``level`` (or ``fleet``: sharding_degree = 2, stage 2), 3 SGD steps
    of an MSE loss through a GradScaler(1024) on this rank's half of
    each scaled_batches batch: the losses, the scale after, the
    parameters after each step."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.distributed import sharding, topology
    m = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                            torch.nn.Linear(16, 4))
    with torch.no_grad():
        for i, lin in enumerate((m[0], m[2])):
            lin.weight.copy_(torch.from_numpy(inputs[f"mlp.w{i}"]).T)
            lin.bias.copy_(torch.from_numpy(inputs[f"mlp.b{i}"]))
    opt = optimizer.SGD(SCALED_LR, parameters=m.named_parameters())
    scaler = amp.GradScaler(init_loss_scaling=1024.0)
    if level == "fleet":
        fleet = _fleet(stage=2, sharding_degree=n)
        model = fleet.distributed_model(m)
        opt = fleet.distributed_optimizer(opt)
    else:
        model, opt, scaler = sharding.group_sharded_parallel(
            m, opt, level, scaler)
    xs, ys = scaled_batches()
    per = 8 // n
    mine = slice(rank * per, (rank + 1) * per)
    losses = []
    for step, (x, y) in enumerate(zip(xs, ys)):
        loss = ((model(torch.from_numpy(x[mine]))
                 - torch.from_numpy(y[mine])) ** 2).mean()
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        losses.append(float(loss))
        with sharding.gathered(m):
            # copies (a numpy view would pin the storage p_g_os frees)
            for i, lin in enumerate((m[0], m[2])):
                out[f"scaled.{level}.{step}.w{i}"] = \
                    lin.weight.detach().clone().numpy().T
                out[f"scaled.{level}.{step}.b{i}"] = \
                    lin.bias.detach().clone().numpy()
    if level == "fleet":
        topology.reset()
    return {f"scaled_{level}_losses": losses,
            f"scaled_{level}_scale": float(scaler.get_loss_scaling())}


def suite_zero(rank, n, out, inputs):
    """ZeRO over 2 ranks: group_sharded_parallel at os, os_g and p_g_os,
    then fleet's route (sharding_degree = 2, sharding_configs stage 2:
    ShardingParallel and HybridParallelOptimizer); each also with a
    GradScaler on an MLP (_zero_scaled)."""
    from paddle_tpu_torch.distributed import collective, sharding, topology
    res = {}
    for level in sharding.LEVELS:
        def make(m, opt, level=level):
            model, opt, _ = sharding.group_sharded_parallel(m, opt, level)
            res[f"{level}_sizes"] = opt._sharding.sizes
            res[f"{level}_freed"] = sum(
                int(p.untyped_storage().size() == 0)
                for p in m.parameters())
            return model, opt
        res.update(_zero_run(rank, n, out, inputs, level, make))
        res.update(_zero_scaled(rank, n, out, inputs, level))
    with pytest_raises(ValueError):
        sharding.group_sharded_parallel(None, None, "p_g")
    fleet = _fleet(stage=2, sharding_degree=n)

    def make_fleet(m, opt):
        model = fleet.distributed_model(m)
        opt = fleet.distributed_optimizer(opt)
        res["fleet_kinds"] = [type(model).__name__, opt._zero.level]
        return model, opt
    res.update(_zero_run(rank, n, out, inputs, "fleet", make_fleet))
    topology.reset()
    res.update(_zero_scaled(rank, n, out, inputs, "fleet"))
    collective.barrier()
    return res


class pytest_raises:
    """``pytest.raises`` for a worker (no pytest there)."""

    def __init__(self, exc):
        self.exc = exc

    def __enter__(self):
        return self

    def __exit__(self, typ, val, tb):
        if typ is None:
            raise AssertionError(f"{self.exc.__name__} not raised")
        return issubclass(typ, self.exc)


def suite_meta(rank, n, out, inputs):
    """LocalSGD over the dp group (here the world) at k_steps = 2, each
    rank stepping on its own grads; FP16AllReduceOptimizer over a
    group."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.fleet import meta_optimizers as meta
    p = torch.ones(8, requires_grad=True)
    opt = meta.LocalSGDOptimizer(optimizer.SGD(0.1, parameters=[p]),
                                 k_steps=2)
    sync = opt._sync_params
    step = [0]

    def recorded():
        out[f"pre{step[0]}"] = p.detach().numpy().copy()
        sync()
    opt._sync_params = recorded
    for i in range(1, 5):
        step[0] = i
        p.grad = torch.from_numpy(rank_values(rank, 40 + i, (8,)))
        opt.step()
        out[f"lsgd{i}"] = p.detach().numpy().copy()
    q = torch.zeros(16, requires_grad=True)
    fp = meta.FP16AllReduceOptimizer(optimizer.SGD(1.0, parameters=[q]),
                                     group=collective._default_group())
    q.grad = torch.from_numpy(
        np.random.RandomState(50 + rank).randn(16).astype(np.float32))
    fp.step()
    out["fp16ar"] = q.detach().numpy()
    return {}


MOE_SHAPE = dict(d_model=16, d_hidden=32, num_experts=4, top_k=2)


def _port_moe(inputs, cf, device="cpu"):
    """The port's MoELayer with the reference's weights (each rank keeps
    its experts)."""
    from paddle_tpu_torch.incubate import moe
    layer = moe.MoELayer(capacity_factor=cf, device=device, **MOE_SHAPE)
    lo = layer.local_experts * (0 if layer.ep_group is None
                                else layer.ep_group.rank)
    with torch.no_grad():
        layer.gate.copy_(torch.from_numpy(inputs["moe.gate"]))
        for k in ("w1", "b1", "w2", "b2"):
            full = torch.from_numpy(inputs[f"moe.{k}"])
            getattr(layer, k).copy_(full[lo:lo + layer.local_experts])
    return layer


def suite_moe(rank, n, out, inputs):
    """MoE at dp = 2 x ep (mp) = 2: each dp rank its half of the tokens,
    each ep rank its half of the experts, at capacity factors that bind
    (0.5) and that do not (2.0): the output rows, the aux loss, and the
    grads of mean-over-tokens (y * cot).sum(-1) + aux averaged over dp
    (DataParallel's rule)."""
    from paddle_tpu_torch.distributed import collective
    fleet = _fleet(dp_degree=2, mp_degree=2)
    hcg = fleet.get_hybrid_communicate_group()
    dp = hcg.get_data_parallel_group()
    x_all = torch.from_numpy(inputs["moe.x"])
    cot_all = torch.from_numpy(inputs["moe.cot"])
    per = x_all.shape[0] // dp.nranks
    mine = slice(dp.rank * per, (dp.rank + 1) * per)
    res = {"ep": hcg.get_model_parallel_rank(), "dp": dp.rank}
    for cf in (0.5, 2.0):
        layer = _port_moe(inputs, cf)
        x = x_all[mine].clone().requires_grad_()
        y = layer(x)
        loss = (y * cot_all[mine]).sum() / per + layer.aux_loss
        loss.backward()
        out[f"y{cf}"] = y.detach().numpy()
        out[f"aux{cf}"] = layer.aux_loss.detach().numpy()
        out[f"dx{cf}"] = x.grad.numpy()
        for k in ("gate", "w1", "b1", "w2", "b2"):
            g = getattr(layer, k).grad.clone()
            collective.all_reduce(g, op="avg", group=dp)
            out[f"d{k}{cf}"] = g.numpy()
    res["local_experts"] = layer.local_experts
    return res


def suite_ckpt(rank, n, out, inputs):
    """Sharded checkpoints over 2 ranks: the tiny GPT at mp = 2 saves its
    shards (save_sharded) and loads a whole-model checkpoint the test
    wrote into its shards; then ZeRO os_g (sharding = 2) takes 2 AdamW
    steps and saves its train state (save_sharded_train_state), each rank
    its partition's optimizer state."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import collective, sharding, topology
    from paddle_tpu_torch.incubate.checkpoint import sharded
    root = str(inputs["ckptdir"])
    fleet = _fleet(mp_degree=n)
    g = fleet.get_hybrid_communicate_group().get_model_parallel_group()
    m = _port_gpt(inputs, "ckpt", g, use_mp=True)
    sharded.save_sharded(dict(m.named_parameters()), root + "/tp")
    fresh = _port_gpt(inputs, "ckpt", g, use_mp=True)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    sharded.load_sharded(root + "/dense", dict(fresh.named_parameters()))
    for k, p in fresh.named_parameters():
        out[f"loaded.{k}"] = p.detach().numpy()
    topology.reset()
    fleet = _fleet(stage=2, sharding_degree=n)
    m = _port_gpt(inputs, "ckpt")
    model = fleet.distributed_model(m)
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        1e-3, parameters=m.named_parameters()))
    ids, labels = (torch.from_numpy(a) for a in zero_batch())
    per = ids.shape[0] // n
    for _ in range(2):
        loss = model(ids[rank * per:(rank + 1) * per],
                     labels=labels[rank * per:(rank + 1) * per])
        loss.backward()
        opt.step()
        opt.clear_grad()
    sharded.save_sharded_train_state(dict(m.named_parameters()), opt,
                                     root + "/zero")
    for k, p in m.named_parameters():
        out[f"zero.param.{k}"] = p.detach().numpy()
    base = opt._inner_opt
    names = {id(p): k for k, p in m.named_parameters()}
    for kind, store in base._accumulators.items():
        for pid, t in store.items():
            out[f"zero.opt.{names[pid]}_{kind}"] = t.numpy()
    collective.barrier()
    return {"state_bytes": sharding.state_bytes(opt)}


def suite_emb(rank, n, out, inputs):
    """DistributedEmbedding over an mp = 2 group: each rank its rows, the
    lookup assembled by the all-reduce, the grad of each rank's rows."""
    from paddle_tpu_torch.distributed.fleet.distributed_embedding import (
        DistributedEmbedding)
    _fleet(mp_degree=n)
    emb = DistributedEmbedding(16, 8, device="cpu")
    w = torch.from_numpy(inputs["emb.w"])
    with torch.no_grad():
        emb.weight.copy_(w[emb.start:emb.start + emb.per_rank])
    ids = torch.from_numpy(inputs["emb.ids"])
    y = emb(ids)
    (y * torch.from_numpy(inputs["emb.cot"])).sum().backward()
    out["y"] = y.detach().numpy()
    out["dw"] = emb.weight.grad.numpy()
    return {"start": emb.start, "rows": emb.per_rank}


def suite_tpgen(rank, n, out, inputs):
    """Greedy decoding of a GPT built under ``use_mp`` (mp = n) from the
    reference's weights: ``generate()`` of the prompts in one batch, and
    the ``ServingEngine``'s stream of each prompt."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text import convert, models
    fleet = _fleet(mp_degree=n)
    g = fleet.get_hybrid_communicate_group().get_model_parallel_group()
    cfg = models.TransformerLMConfig(use_mp=True, **TPGEN_GPT)
    m = models.GPTForCausalLM(cfg, device="cpu")
    ref = {k[len("gen."):]: inputs[k] for k in inputs.files
           if k.startswith("gen.")}
    m.load_state_dict(convert.tp_state_dict_from_paddle_tpu(
        ref, g.rank, g.nranks))
    m.eval()
    prompts = inputs["prompts"]
    out["generate"] = m.generate(torch.from_numpy(prompts),
                                 max_new_tokens=TPGEN_NEW,
                                 temperature=0.0).numpy()
    eng = ServingEngine(m, device="cpu", num_slots=2, block_size=4)
    reqs = [eng.add_request(p, max_new_tokens=TPGEN_NEW) for p in prompts]
    eng.run()
    out["engine"] = np.stack([np.asarray(r.generated) for r in reqs])
    return {"mp_rank": g.rank, "split": m.gpt.mp_group is not None}


# the tensor-parallel decoding case: heads and the vocab divide by mp = 2
TPGEN_GPT = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
                 max_seq_len=64, dropout=0.0)
TPGEN_NEW = 12


SUITES = {"tpgen": suite_tpgen, "collective": suite_collective, "tp": suite_tp, "sp": suite_sp,
          "pp": suite_pp, "pp4": suite_pp4, "pipefn": suite_pipefn,
          "pipemem": suite_pipemem, "zero": suite_zero,
          "meta": suite_meta, "moe": suite_moe,
          "ckpt": suite_ckpt, "emb": suite_emb}


def main():
    suite, rank, world, port, outdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(world),
                      PADDLE_TRAINER_ENDPOINTS=f"127.0.0.1:{port}")
    torch.set_num_threads(1)
    import paddle_tpu_torch
    paddle_tpu_torch.set_device("cpu")
    from paddle_tpu_torch.distributed import init_parallel_env
    init_parallel_env(backend="gloo", timeout=60)
    path = os.path.join(outdir, "inputs.npz")
    inputs = np.load(path) if os.path.exists(path) else None
    out = {}
    res = SUITES[suite](rank, world, out, inputs)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    import torch.distributed as dist
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, **res}))


if __name__ == "__main__":
    main()
