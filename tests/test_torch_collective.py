"""The port's collective layer (paddle_tpu_torch.distributed) against the
reference's eager collectives, over gloo processes on the CPU.

The reference runs one controller over a mesh of devices and treats a
tensor's leading-axis blocks as the ranks' values
(paddle_tpu/distributed/collective.py:14-22); the port runs one process
a rank. So each case builds rank ``r``'s value from a numpy seed, the
ranks of tests/torch_dist_worker.py run the port's collective, and the
reference's eager collective runs here on a mesh of ``n`` CPU devices
over the same values stacked as blocks; rank ``r``'s result is held to
block ``r`` of the reference's (the cases of test_collective_eager.py
and test_distributed.py's test_collective_edge_semantics /
test_reduce_dst_validation). Also: the argument errors, the topology's
coordinates and group sizes, a world of one in this process, and a
DataParallel MLP trained 3 steps on 2 ranks against one process on the
whole batch. Two spawns (2 and 4 ranks), about 10 s each.

Tolerances: the reductions are sums of n f32 values in another order,
rtol 1e-6; DataParallel's losses and weights rtol 1e-5 (the batch's
gradient summed in two halves).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import collective as ref_c
from paddle_tpu.distributed import topology as ref_topology

from _torch_dist import run_ranks
from torch_dist_worker import (dp_batch, dp_model, dp_train, rank_values,
                               surface_mlp, surface_train)
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import fleet, topology


@pytest.fixture(scope="module")
def spawns(tmp_path_factory):
    """The spawn of each world size, run once for the module."""
    done = {}

    def get(n):
        if n not in done:
            done[n] = run_ranks("collective", n,
                                tmp_path_factory.mktemp(f"coll{n}"))
        return done[n]
    return get


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, spawns):
    n = request.param
    return (n, *spawns(n))


def _ref_group(n):
    mesh = ref_topology.build_mesh(dp=n, devices=jax.devices()[:n])
    return ref_c.Group(axis="dp", mesh=mesh)


def _blocks(n, seed, shape):
    """The reference's global array: rank r's values as block r."""
    return np.concatenate([rank_values(r, seed, shape) for r in range(n)])


def _check_blocks(got_by_rank, ref_global, n, rtol=1e-6):
    for r, got in enumerate(got_by_rank):
        want = np.split(np.asarray(ref_global), n)[r]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod", "avg"])
def test_all_reduce_matches_reference(ranks, op):
    n, _, arrays = ranks
    t = paddle.to_tensor(_blocks(n, 10, (4, 3)))
    ref_c.all_reduce(t, op=op, group=_ref_group(n))
    _check_blocks([a[f"all_reduce_{op}"] for a in arrays], t.numpy(), n)


def test_all_reduce_of_a_port_tensor(ranks):
    n, _, arrays = ranks
    t = paddle.to_tensor(_blocks(n, 10, (4, 3)))
    ref_c.all_reduce(t, group=_ref_group(n))
    _check_blocks([a["all_reduce_tensor"] for a in arrays], t.numpy(), n)


def test_all_gather_matches_reference(ranks):
    n, _, arrays = ranks
    outs = ref_c.all_gather([], paddle.to_tensor(_blocks(n, 20, (2, 3))),
                            group=_ref_group(n))
    want = np.stack([o.numpy() for o in outs])
    for a in arrays:
        np.testing.assert_array_equal(a["all_gather"], want)


def test_broadcast_and_reduce_match_reference(ranks):
    n, _, arrays = ranks
    g = _ref_group(n)
    t = paddle.to_tensor(_blocks(n, 30, (3,)))
    ref_c.broadcast(t, src=n - 1, group=g)
    _check_blocks([a["broadcast"] for a in arrays], t.numpy(), n)
    # reduce: only dst gets the sum, the other ranks keep their input
    t = paddle.to_tensor(_blocks(n, 40, (2, 2)))
    ref_c.reduce(t, dst=1, group=g)
    _check_blocks([a["reduce"] for a in arrays], t.numpy(), n)


def test_scatter_matches_reference(ranks):
    n, _, arrays = ranks
    g = _ref_group(n)
    src_list = [paddle.to_tensor(rank_values(j, 50, (2, 3)))
                for j in range(n)]
    t = paddle.to_tensor(np.zeros((2 * n, 3), np.float32))
    ref_c.scatter(t, src_list, src=0, group=g)
    _check_blocks([a["scatter"] for a in arrays], t.numpy(), n)


def test_alltoall_matches_reference(ranks):
    """Rank r's in[j] is block r of the reference's j-th input; rank r's
    out[j] is block r of the reference's j-th output."""
    n, _, arrays = ranks
    ins = [paddle.to_tensor(np.concatenate(
        [rank_values(r * n + j, 60, (2, 3)) for r in range(n)]))
        for j in range(n)]
    outs = ref_c.alltoall(ins, group=_ref_group(n))
    for j in range(n):
        _check_blocks([a["alltoall"][j] for a in arrays], outs[j].numpy(), n)


@pytest.mark.parametrize("op", ["sum", "max", "min", "avg"])
def test_reduce_scatter_matches_reference(ranks, op):
    n, _, arrays = ranks
    lst = [paddle.to_tensor(np.concatenate(
        [rank_values(r * n + j, 70, (2, 2)) for r in range(n)]))
        for j in range(n)]
    out = paddle.to_tensor(np.zeros((2 * n, 2), np.float32))
    ref_c.reduce_scatter(out, lst, op=op, group=_ref_group(n))
    _check_blocks([a[f"reduce_scatter_{op}"] for a in arrays],
                  out.numpy(), n)


def test_reduce_scatter_single_tensor_form(ranks):
    n, _, arrays = ranks
    t = paddle.to_tensor(_blocks(n, 80, (2 * n,)))
    ref_c.reduce_scatter(t, group=_ref_group(n))
    got = [a["reduce_scatter_single"] for a in arrays]
    want = np.split(np.asarray(t.numpy()), n)
    for r in range(n):
        np.testing.assert_allclose(got[r], want[r], rtol=1e-6, atol=1e-6)


def test_send_recv(ranks):
    n, _, arrays = ranks
    np.testing.assert_array_equal(arrays[1]["recv"], rank_values(0, 90,
                                                                 (3,)))


def test_argument_errors_and_registry(ranks):
    """The reference's argument checks raise ValueError on every rank; the
    group registry finds a new group and refuses an unknown id; a gloo
    collective inside a captured step raises ToStaticError."""
    n, lines, _ = ranks
    for r, line in enumerate(lines):
        assert line["rank"] == r
        assert line["registry"] is True
        assert line["unknown_group"] == "InvalidArgumentError"
        assert all(v == "ValueError" for v in line["errors"].values()), \
            line["errors"]
        assert line["host_staged"] == {}      # CPU tensors: nothing staged
        assert line["capture"] == "ToStaticError"   # gloo under capture
    g = _ref_group(2)
    with pytest.raises(ValueError):
        ref_c.reduce(paddle.to_tensor(np.ones((2, 2), "float32")), dst=5,
                     group=g)
    with pytest.raises(ValueError):
        ref_c.alltoall([paddle.to_tensor(np.ones((2, 2), np.float32))],
                       group=g)


def test_data_parallel_matches_one_rank(spawns):
    """2 ranks each on half the batch (rank 1 starting from other weights,
    which DataParallel's broadcast evens) = one process on the whole
    batch: the 3 losses (the ranks' mean) and the weights after."""
    lines, arrays = spawns(2)
    model = dp_model()
    xs, ys = dp_batch()
    want = dp_train(model, xs, ys)
    got = np.mean([line["dp_losses"] for line in lines], axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for i, p in enumerate(model.parameters()):
        for a in arrays:
            np.testing.assert_allclose(a[f"dp_param_{i}"],
                                       p.detach().numpy(), rtol=1e-5,
                                       atol=1e-6)


@pytest.fixture
def on_cpu():
    import paddle_tpu_torch
    from paddle_tpu_torch.core import device as device_mod
    paddle_tpu_torch.set_device("cpu")
    yield
    device_mod._current_place = None


def test_data_parallel_of_a_surface_layer(spawns, on_cpu):
    """The same with the MLP written in the Paddle surface (its Layers,
    Tensors and optimizer, under lazy eager: the grads' all-reduce runs
    inside the deferred backward's flush)."""
    lines, arrays = spawns(2)
    model = surface_mlp()
    xs, ys = dp_batch()
    want = surface_train(model, xs, ys)
    got = np.mean([line["sdp_losses"] for line in lines], axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for i, p in enumerate(model.parameters()):
        for a in arrays:
            np.testing.assert_allclose(a[f"sdp_param_{i}"], p.numpy(),
                                       rtol=1e-5, atol=1e-6)


def test_world_of_one_is_identity():
    """No process group: every collective is the identity, in this
    process (the reference's size-1 group)."""
    topology.reset()
    x = torch.arange(4.0)
    for op in ("sum", "max", "prod", "avg"):
        assert torch.equal(C.all_reduce(x.clone(), op=op), x)
    assert C.all_gather([], x)[0] is x
    assert torch.equal(C.broadcast(x.clone()), x)
    assert torch.equal(C.reduce(x.clone(), dst=0), x)
    assert C.alltoall([x]) == [x]
    y = torch.zeros(4)
    C.scatter(y, [x])
    assert torch.equal(y, x)
    C.send(x, dst=0)
    z = torch.zeros(4)
    C.recv(z, src=0)
    assert torch.equal(z, x)
    t = torch.ones(3)
    assert C._c_identity(t) is t and C._mp_allreduce(t) is t
    C.barrier()
    assert C.get_world_size() == 1 and C.get_rank() == 0
    with pytest.raises(ValueError):
        C.reduce(x, dst=3)


@pytest.mark.parametrize("eps,cur,rank,world,want", [
    # one endpoint a rank, 4 ranks a host on two hosts
    (",".join(f"10.0.0.{1 + r // 4}:{6170 + r % 4}" for r in range(8)),
     None, 5, 8, (1, 4)),
    (",".join(f"10.0.0.{1 + r // 4}:{6170 + r % 4}" for r in range(8)),
     "10.0.0.2:6173", 7, 8, (3, 4)),
    # a single rendezvous address: every rank on this host
    ("127.0.0.1:6170", None, 1, 2, (1, 2)),
    ("", None, 0, 1, (0, 1)),
])
def test_local_ranks_from_the_endpoints(monkeypatch, eps, cur, rank, world,
                                        want):
    """The ranks on this host are those whose endpoint has its host;
    8 ranks on two hosts of 4 cards pick NCCL, and 2 ranks on one card
    gloo."""
    from paddle_tpu_torch.distributed import env, parallel
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", eps)
    if cur is None:
        monkeypatch.delenv("PADDLE_CURRENT_ENDPOINT", raising=False)
    else:
        monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", cur)
    assert env.local_ranks(rank, world) == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert parallel._backend(want[1]) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert parallel._backend(want[1]) == ("nccl" if want[1] == 1
                                         else "gloo")


def test_local_ranks_refuse_an_endpoint_off_the_host(monkeypatch):
    from paddle_tpu_torch.distributed import env
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "10.0.0.1:6170,10.0.0.2:6170")
    monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", "10.0.0.2:6170")
    with pytest.raises(ValueError, match="not on the host"):
        env.local_ranks(0, 2)


def test_communicate_topology_coords():
    """The reference's test_communicate_topology_coords on the port."""
    t = topology.CommunicateTopology(["data", "model"], [2, 4])
    assert t.world_size() == 8
    assert t.get_rank(data=1, model=2) == 6
    assert t.get_coord(6) == (1, 2)
    assert t.get_axis_list("data", 0) == [0, 1, 2, 3]
    assert [0, 1, 2, 3] in t.get_comm_list("model")
    r = ref_topology.CommunicateTopology(["data", "model"], [2, 4])
    assert t.get_comm_list("data") == r.get_comm_list("data")


def test_hybrid_group_sizes_and_mesh():
    """The reference's axis order and degrees: a world of 8 laid out
    dp 2 x mp 2 x sharding 2 (mesh shapes as the reference's), each
    axis's groups; in a world of one every group has one rank."""
    mesh = topology.build_mesh(dp=2, mp=2, sharding=2, world_size=8)
    ref = ref_topology.build_mesh(dp=2, mp=2, sharding=2)
    assert mesh.axis_names == tuple(ref.axis_names)
    assert {k: int(v) for k, v in ref.shape.items()} == mesh.shape
    assert mesh.axis_groups("mp")[0] == [0, 1]
    assert mesh.axis_groups("dp")[0] == [0, 4]
    assert mesh.coord(5) == {"pp": 0, "dp": 1, "sharding": 0, "sp": 0,
                             "mp": 1}
    assert topology.build_mesh(world_size=4).shape["dp"] == 4
    with pytest.raises(ValueError):
        topology.build_mesh(dp=3, world_size=4)
    s = fleet.DistributedStrategy()
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    for axis in ("dp", "mp", "pp", "sharding", "sp"):
        assert getattr(hcg, {"dp": "get_data_parallel_group",
                             "mp": "get_model_parallel_group",
                             "pp": "get_pipe_parallel_group",
                             "sharding": "get_sharding_parallel_group",
                             "sp": "get_sequence_parallel_group"}[axis])(
        ).nranks == 1
    assert topology.get_mesh().shape["dp"] == 1
    assert hcg.get_rank_from_stage(0) == 0
    topology.reset()


def test_strategy_and_fleet_refusals():
    """The reference's strategy validation, and what the port does not
    run yet raises NotImplementedError naming its item."""
    s = fleet.DistributedStrategy()
    with pytest.raises(ValueError, match="unknown hybrid_configs"):
        s.hybrid_configs = {"dp_degre": 2}
    with pytest.raises(AttributeError, match="no field"):
        s.shardng = True
    s.gradient_merge = True
    with pytest.raises(NotImplementedError, match="item 13"):
        fleet.init(is_collective=True, strategy=s)
    with pytest.raises(NotImplementedError, match="item 13"):
        fleet.init(role_maker=fleet.PaddleCloudRoleMaker(
            is_collective=False))
    with pytest.raises(NotImplementedError, match="item 13"):
        fleet.init_worker()
    topology.reset()


def test_recompute_grad_parity_with_reference():
    """fleet.recompute (distributed/utils_recompute.py) against the
    reference's on the same MLP and input (test_distributed.py's
    test_recompute_grad_parity), and against no recompute."""
    import paddle_tpu.nn as ref_nn
    from paddle_tpu.distributed.fleet import recompute as ref_recompute
    paddle.seed(1)
    net = ref_nn.Sequential(ref_nn.Linear(4, 8), ref_nn.Tanh(),
                            ref_nn.Linear(8, 4))
    x_np = np.random.RandomState(3).randn(3, 4).astype("float32")
    x = paddle.to_tensor(x_np, stop_gradient=False)
    ref_recompute(net, x).sum().backward()
    want = [np.asarray(p.grad.numpy()) for p in net.parameters()]
    tnet = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 4))
    with torch.no_grad():
        for tp, p in zip(tnet.parameters(), net.parameters()):
            v = torch.from_numpy(np.array(p.numpy()))
            tp.copy_(v.t() if v.dim() == 2 else v)
    tx = torch.from_numpy(x_np).requires_grad_(True)
    fleet.recompute(tnet, tx).sum().backward()
    got = [p.grad.t() if p.dim() == 2 else p.grad for p in tnet.parameters()]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(x.grad.numpy()),
                               rtol=1e-5, atol=1e-7)
    plain = [p.grad.clone() for p in tnet.parameters()]
    tnet.zero_grad()
    tnet(tx).sum().backward()
    for a, p in zip(plain, tnet.parameters()):
        torch.testing.assert_close(a, p.grad, rtol=0, atol=0)


def test_recompute_replays_the_dropout_mask():
    """The reference's test_recompute_preserves_rng on the port: dropout
    drawing from the port's default generator keeps its mask when the
    backward runs the function again, so the grad is nonzero exactly
    where the forward kept values."""
    import paddle_tpu_torch
    from paddle_tpu_torch.ops import nn_ops
    paddle_tpu_torch.seed(2)
    x = torch.ones(64, requires_grad=True)
    out = fleet.recompute(lambda t: nn_ops.dropout(t, 0.5), x)
    kept = out.detach() != 0
    out.sum().backward()
    assert 0 < int(kept.sum()) < 64
    assert torch.equal(x.grad != 0, kept)
