"""The port's fleet meta-optimizers (distributed/fleet/meta_optimizers.py)
against the reference's on the same parameters and grads: GradientMerge,
LocalSGD and its adaptive form, the 16-bit grad round trip, DGC (its
warm-up, its top-k by threshold with ties at the threshold, the residual,
the sparsity schedule) and the strategy compiler, in one process; then
LocalSGD's parameter average and the bf16 all-reduce over two gloo rank
processes (tests/torch_dist_worker.py, suite ``meta``, about 10 s).

Each scenario runs through both packages: the reference's optimizer on
its Parameters, the port's on torch leaves, the same numpy grads.
Tolerance: f32 values rtol 1e-6, atol 1e-7 (the same operations in the
same order), DGC's kept set exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet import meta_optimizers as ref_meta

from _torch_dist import run_ranks
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.distributed.fleet import meta_optimizers as meta


class _Ref:
    """The reference's side of a scenario."""
    meta = ref_meta
    opt = paddle.optimizer

    @staticmethod
    def param(val):
        p = paddle.create_parameter(list(val.shape), "float32")
        p.set_value(val)
        return p

    @staticmethod
    def set_grad(p, g):
        from paddle_tpu.core.tensor import Tensor
        p._grad = Tensor(np.asarray(g, np.float32))

    @staticmethod
    def value(p):
        return np.asarray(p.numpy())


class _Port:
    meta = meta
    opt = port_opt

    @staticmethod
    def param(val):
        return torch.tensor(val, requires_grad=True)

    @staticmethod
    def set_grad(p, g):
        p.grad = torch.tensor(np.asarray(g, np.float32))

    @staticmethod
    def value(p):
        return p.detach().numpy().copy()


def _both(scenario):
    return scenario(_Ref), scenario(_Port)


def _gm(k, avg):
    def run(S):
        p = S.param(np.ones(4, np.float32))
        gm = S.meta.GradientMergeOptimizer(S.opt.SGD(0.1, parameters=[p]),
                                           k_steps=k, avg=avg)
        seen = []
        for g in (np.full(4, 0.5), np.full(4, 1.5), np.arange(4.0),
                  np.full(4, -2.0)):
            S.set_grad(p, g)
            gm.step()
            seen.append(S.value(p))
        return seen
    return run


@pytest.mark.parametrize("k,avg", [(2, True), (2, False), (3, True)])
def test_gradient_merge_matches_reference(k, avg):
    ref, mine = _both(_gm(k, avg))
    np.testing.assert_allclose(mine, ref, rtol=1e-6, atol=1e-7)


def test_localsgd_single_process_matches_reference():
    def run(S):
        p = S.param(np.random.RandomState(0).randn(4).astype(np.float32))
        opt = S.meta.LocalSGDOptimizer(S.opt.SGD(0.1, parameters=[p]),
                                       k_steps=2)
        for _ in range(4):
            S.set_grad(p, np.ones(4, np.float32))
            opt.step()
        return S.value(p)
    ref, mine = _both(run)
    np.testing.assert_allclose(mine, ref, rtol=1e-6, atol=1e-7)


def test_adaptive_localsgd_interval_follows_the_loss():
    """minimize's loss: improving keeps the interval, a stall doubles
    it, as the reference's."""
    def run(S):
        p = S.param(np.ones(2, np.float32))
        opt = S.meta.AdaptiveLocalSGDOptimizer(
            S.opt.SGD(0.1, parameters=[p]), init_k_steps=1, max_k_steps=4)
        ks = []
        for scale in (1.0, 0.5, 0.5, 0.5, 0.4):
            if S is _Ref:
                loss = (p * paddle.to_tensor(np.float32(scale))).sum()
            else:
                loss = (p * scale).sum()
            opt.minimize(loss)
            opt.clear_grad()
            ks.append(opt._k)
        return ks, S.value(p)
    (rk, rv), (mk, mv) = _both(run)
    assert mk == rk
    np.testing.assert_allclose(mv, rv, rtol=1e-6)


def test_fp16_allreduce_rounds_through_bfloat16():
    def run(S):
        p = S.param(np.zeros(4, np.float32))
        opt = S.meta.FP16AllReduceOptimizer(S.opt.SGD(1.0, parameters=[p]))
        S.set_grad(p, np.array([1.0 + 2 ** -10, 1.0, 2.0, 3.0 + 2 ** -9],
                               np.float32))
        opt.step()
        return S.value(p)
    ref, mine = _both(run)
    np.testing.assert_array_equal(mine, ref)


def test_dgc_warmup_is_plain_momentum():
    g = np.random.RandomState(1).randn(8).astype(np.float32)
    w = np.random.RandomState(2).randn(8).astype(np.float32)

    def run(S):
        p1, p2 = S.param(w.copy()), S.param(w.copy())
        dgc = S.meta.DGCMomentumOptimizer(0.1, momentum=0.9, parameters=[p1],
                                          rampup_begin_step=100)
        mom = S.opt.Momentum(0.1, momentum=0.9, parameters=[p2])
        S.set_grad(p1, g)
        S.set_grad(p2, g)
        dgc.step()
        mom.step()
        return S.value(p1), S.value(p2)
    (r1, r2), (m1, m2) = _both(run)
    np.testing.assert_allclose(m1, m2, rtol=1e-6)
    np.testing.assert_allclose(m1, r1, rtol=1e-6)


@pytest.mark.parametrize("grad", ["distinct", "ties"])
def test_dgc_top_k_by_threshold_matches_reference(grad):
    """Three DGC steps at sparsity 0.75 on 64 elements: the kept set each
    step (every element at or above the 16th largest |v|, so repeated
    magnitudes at the threshold are all kept), the residual carried, the
    weights: the reference's, element by element."""
    if grad == "distinct":
        g0 = np.arange(64, dtype=np.float32) + 1.0
    else:   # 24 elements tie at the threshold's magnitude, signs mixed
        g0 = np.concatenate([np.full(40, 0.5), np.full(24, 2.0)]).astype(
            np.float32) * np.where(np.arange(64) % 3, 1.0, -1.0)
    grads = [g0, np.zeros(64, np.float32),
             np.random.RandomState(3).randn(64).astype(np.float32)]

    def run(S):
        p = S.param(np.zeros(64, np.float32))
        dgc = S.meta.DGCMomentumOptimizer(1.0, momentum=0.5, parameters=[p],
                                          rampup_begin_step=0, rampup_step=1,
                                          sparsity=[0.75])
        out = []
        for g in grads:
            before = S.value(p)
            S.set_grad(p, g)
            dgc.step()
            out.append(S.value(p) - before)
        return out
    ref, mine = _both(run)
    for r, m in zip(ref, mine):
        np.testing.assert_array_equal(m != 0, r != 0)
        np.testing.assert_allclose(m, r, rtol=1e-6, atol=1e-7)
    if grad == "ties":
        assert np.count_nonzero(mine[0]) == 24     # more than k = 16


def test_dgc_sparsity_schedule():
    for step in (0, 4, 5, 6, 7, 8, 100):
        assert meta._dgc_sparsity(step, 5, 4, [0.75, 0.9375]) \
            == ref_meta._dgc_sparsity(step, 5, 4, [0.75, 0.9375])


def test_strategy_compiler_chains_wrappers():
    """apply_meta_optimizers builds the reference's chain (DGC swap,
    gradient merge, LocalSGD), and the chain's steps give the reference's
    values."""
    def run(S, fleet):
        strat = fleet.DistributedStrategy()
        strat.dgc = True
        strat.gradient_merge = True
        strat.gradient_merge_configs = {"k_steps": 2, "avg": True}
        strat.localsgd = True
        p = S.param(np.random.RandomState(4).randn(32).astype(np.float32))
        inner = S.opt.Momentum(0.1, momentum=0.9, parameters=[p])
        opt = S.meta.apply_meta_optimizers(inner, strat)
        kinds = [type(opt).__name__, type(opt._inner_opt).__name__,
                 type(opt._inner_opt._inner_opt).__name__]
        for i in range(4):
            S.set_grad(p, np.full(32, 0.1 * (i + 1), np.float32))
            opt.step()
        return kinds, S.value(p)
    rk, rv = run(_Ref, paddle.distributed.fleet)
    mk, mv = run(_Port, port_fleet)
    assert mk == rk == ["LocalSGDOptimizer", "GradientMergeOptimizer",
                        "DGCMomentumOptimizer"]
    np.testing.assert_allclose(mv, rv, rtol=1e-6, atol=1e-7)


def test_fleet_distributed_optimizer_applies_strategy():
    from paddle_tpu_torch.distributed import topology
    strat = port_fleet.DistributedStrategy()
    strat.gradient_merge = True
    strat.gradient_merge_configs = {"k_steps": 2, "avg": False}
    port_fleet.init(is_collective=True, strategy=strat)
    try:
        p = torch.ones(4, requires_grad=True)
        opt = port_fleet.distributed_optimizer(
            port_opt.SGD(0.1, parameters=[p]), strategy=strat)
        for _ in range(2):
            p.grad = torch.ones(4)
            opt.step()
        np.testing.assert_allclose(p.detach().numpy(), 0.8, rtol=1e-6)
    finally:
        topology.reset()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("meta", 2, tmp_path_factory.mktemp("meta"))


def test_localsgd_averages_the_ranks_parameters(ranks):
    """Two ranks step on their own grads; every k_steps = 2 LocalSGD
    averages their parameters over the dp group: equal on both ranks at
    steps 2 and 4, apart at 1 and 3, and the mean of the local steps."""
    lines, arrays = ranks
    a, b = arrays
    for step in (1, 3):
        assert not np.array_equal(a[f"lsgd{step}"], b[f"lsgd{step}"])
    for step in (2, 4):
        np.testing.assert_array_equal(a[f"lsgd{step}"], b[f"lsgd{step}"])
        np.testing.assert_allclose(
            a[f"lsgd{step}"], (a[f"pre{step}"] + b[f"pre{step}"]) / 2,
            rtol=1e-6)


def test_fp16_allreduce_over_a_group(ranks):
    """With a group, the grads are averaged over it in bfloat16: the
    bf16 mean of the bf16 grads, then the step."""
    _, arrays = ranks
    g = [np.random.RandomState(50 + r).randn(16).astype(np.float32)
         for r in range(2)]
    low = [torch.tensor(x).to(torch.bfloat16) for x in g]
    want = -((low[0] + low[1]) / 2).float().numpy()
    for a in arrays:
        np.testing.assert_array_equal(a["fp16ar"], want)
