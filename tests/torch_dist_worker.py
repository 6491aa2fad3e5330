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


def _fleet(**degrees):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = degrees
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
    _build_topology_kept(inputs, res)
    C.barrier()
    return res


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


SUITES = {"collective": suite_collective, "tp": suite_tp, "sp": suite_sp}


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
