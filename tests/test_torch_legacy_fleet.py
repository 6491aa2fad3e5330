"""The port's legacy ``fluid.incubate.fleet`` skins
(``tests/test_legacy_fleet.py``'s four cases and
``tests/test_advice_round4.py``'s ``all_reduce_worker`` contract)
against the reference, one worker on the CPU: the namespaces and modes,
the strategy factory's modern strategies, the collective fleet's three
SGD ``minimize`` steps from the reference's weights (the same losses
and weights), ``split_files``, and the caller's buffer receiving the
reduction.

Tolerance: losses and weights rtol 1e-5 (f32, SGD on a 16 x 8 batch).
"""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as device_mod


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    P.set_device("cpu")
    yield
    device_mod._current_place = None


def _legacy(pkg):
    base = __import__(f"{pkg.__name__}.fluid.incubate.fleet.base",
                      fromlist=["role_maker"])
    coll = __import__(f"{pkg.__name__}.fluid.incubate.fleet.collective",
                      fromlist=["fleet"])
    return base.role_maker, coll.fleet


def test_legacy_namespaces_importable():
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.incubate.fleet.base import role_maker
    from paddle_tpu_torch.fluid.incubate.fleet.base.mode import Mode
    from paddle_tpu_torch.fluid.incubate.fleet.parameter_server import (
        DistributedMode)
    from paddle_tpu_torch.fluid.incubate.fleet.parameter_server import \
        pslib
    assert fluid.incubate.fleet is not None
    assert Mode.TRANSPILER == 1 and Mode.COLLECTIVE == 3
    assert DistributedMode.GEO == 3
    assert role_maker.PaddleCloudRoleMaker \
        is P.distributed.fleet.PaddleCloudRoleMaker
    with pytest.raises(NotImplementedError, match="MPI"):
        role_maker.MPISymetricRoleMaker()
    with pytest.raises(NotImplementedError, match="PSLib"):
        pslib.PSLib()
    with pytest.raises(NotImplementedError, match="PSLib"):
        pslib.fleet()


def test_legacy_strategy_factory_maps_to_modern():
    from paddle_tpu_torch.fluid.incubate.fleet.parameter_server. \
        distribute_transpiler.distributed_strategy import StrategyFactory

    sync = StrategyFactory.create_sync_strategy().to_modern()
    assert sync.a_sync is False
    assert isinstance(sync, P.distributed.fleet.DistributedStrategy)
    asyncs = StrategyFactory.create_async_strategy().to_modern()
    assert asyncs.a_sync is True
    assert not asyncs.a_sync_configs.get("k_steps")
    half = StrategyFactory.create_half_async_strategy().to_modern()
    assert half.a_sync is True
    geo = StrategyFactory.create_geo_strategy(7).to_modern()
    assert geo.a_sync is True and geo.a_sync_configs["k_steps"] == 7
    cfg = StrategyFactory.create_sync_strategy() \
        .get_trainer_runtime_config().get_communicator_flags()
    assert "communicator_max_merge_var_num" in cfg


def _collective_steps(pkg, weights, monkeypatch):
    role_maker, fleet = _legacy(pkg)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    fleet.init(role_maker.PaddleCloudRoleMaker(is_collective=True))
    assert fleet.is_worker() and not fleet.is_server()
    assert fleet.worker_index() == 0 and fleet.is_first_worker()
    net = pkg.nn.Linear(8, 4)
    if weights is not None:
        assert net.set_state_dict(weights) == []
    made = {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}
    opt = pkg.optimizer.SGD(0.1, parameters=net.parameters())
    dist_opt = fleet.distributed_optimizer(opt)
    x = pkg.to_tensor(np.random.RandomState(0).randn(16, 8)
                      .astype("float32"))
    y = pkg.to_tensor(np.zeros((16, 4), "float32"))
    losses = []
    for _ in range(3):
        loss = ((net(x) - y) ** 2).mean()
        before = np.asarray(net.weight.numpy()).copy()
        dist_opt.minimize(loss)
        opt.clear_grad()
        losses.append(float(loss.numpy()))
        assert not np.allclose(before, np.asarray(net.weight.numpy()))
    return made, losses, np.asarray(net.weight.numpy())


def test_legacy_collective_fleet_trains(monkeypatch):
    R.seed(0)
    weights, want, w_want = _collective_steps(R, None, monkeypatch)
    _, got, w_got = _collective_steps(P, weights, monkeypatch)
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(w_got, w_want, rtol=1e-5, atol=1e-7)


def test_legacy_split_files(monkeypatch):
    role_maker, fleet = _legacy(P)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    fleet.init(role_maker.PaddleCloudRoleMaker(is_collective=True))
    files = [f"part-{i}" for i in range(5)]
    assert fleet.split_files(files) == files


def test_all_reduce_worker_inplace_contract():
    _, fleet = _legacy(P)
    src = np.array([1.0, 2.0], np.float32)
    buf = np.zeros(2, np.float32)
    fleet.all_reduce_worker(src, buf)
    np.testing.assert_array_equal(buf, src)
    lst = [0.0, 0.0]
    fleet.all_reduce_worker(src, lst)
    assert lst == [1.0, 2.0]
    t = P.to_tensor(np.zeros(2, np.float32))
    fleet.all_reduce_worker(src, t)
    np.testing.assert_array_equal(np.asarray(t.numpy()), src)
    sc = [0.0]
    fleet.all_reduce_worker(np.float32(3.0), sc)
    assert sc == [3.0]
    with pytest.raises(TypeError, match="in place"):
        fleet.all_reduce_worker(src, (0.0, 0.0))


def test_transpiler_fleet_wraps_a_modern_strategy():
    from paddle_tpu_torch.fluid.incubate.fleet.parameter_server \
        .distribute_transpiler import FleetTranspiler, fleet
    assert isinstance(fleet, FleetTranspiler)
    assert fleet._mode == 1
