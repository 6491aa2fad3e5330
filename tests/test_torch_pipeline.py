"""The port's functional pipeline (distributed/pipeline.py) against the
reference's over its ``pp`` mesh axis: four gloo rank processes at pp = 4
(tests/torch_dist_worker.py, suite ``pipefn``) run ``pipeline_apply``,
``pipeline_loss_and_grad`` (remat on and off) and
``pipeline_blocks_apply`` with uneven stages (padded slots masked), on the
reference's inputs; the reference runs its functions here on a dp = 2 x
pp = 4 mesh (its tests/test_pipeline.py). About 15 s.

Tolerances, f32: outputs and the loss rtol 1e-5, atol 1e-6; the stacked
grads rtol 1e-4, atol 1e-5 (the reference's test's: the microbatches'
grads summed in another order); remat on and off, on the port's ranks,
bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.distributed import fleet, pipeline, topology
from paddle_tpu.distributed.fleet import DistributedStrategy

from _torch_dist import run_ranks

PP, D = 4, 8


def _stage_fn(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _block_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _params(key, d=D):
    rs = np.random.RandomState(key)
    return [(rs.randn(d, d).astype("float32") * 0.5,
             rs.randn(d).astype("float32") * 0.1) for _ in range(PP)]


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "pp_degree": PP}
    fleet.init(is_collective=True, strategy=strategy)
    mesh = fleet.get_hybrid_communicate_group().mesh
    try:
        inputs, want = {}, {}
        fwd = _params(0)
        x = np.random.RandomState(1).randn(6, 4, D).astype("float32")
        stacked = pipeline.stack_stage_params(
            [tuple(map(jnp.asarray, p)) for p in fwd])
        want["fwd"] = np.asarray(jax.jit(lambda s, xx: pipeline.pipeline_apply(
            _stage_fn, s, xx, mesh))(stacked, x))
        for s, (w, b) in enumerate(fwd):
            inputs[f"fwd.w{s}"], inputs[f"fwd.b{s}"] = w, b
        inputs["fwd.x"] = x
        gp = _params(2, 4)
        rs = np.random.RandomState(3)
        gx = rs.randn(4, 2, 4).astype("float32")
        gy = rs.randn(4, 2, 4).astype("float32")
        stacked = pipeline.stack_stage_params(
            [tuple(map(jnp.asarray, p)) for p in gp])
        loss, grads = jax.jit(lambda s: pipeline.pipeline_loss_and_grad(
            _stage_fn, lambda o, t: jnp.mean((o - t) ** 2), s, gx, gy,
            mesh))(stacked)
        want["grad.loss"] = float(loss)
        want["grad.dw"], want["grad.db"] = (np.asarray(g) for g in grads)
        for s, (w, b) in enumerate(gp):
            inputs[f"grad.w{s}"], inputs[f"grad.b{s}"] = w, b
        inputs["grad.x"], inputs["grad.y"] = gx, gy
        # 7 blocks over 4 stages: 2, 2, 2, 1 (the last stage's second
        # slot padded)
        rs = np.random.RandomState(4)
        lps = 2
        bw = rs.randn(PP, lps, D, D).astype("float32") * 0.4
        bb = rs.randn(PP, lps, D).astype("float32") * 0.1
        valid = np.array([[True, True]] * 3 + [[True, False]])
        h = rs.randn(8, D).astype("float32")
        want["blocks"] = np.asarray(jax.jit(
            lambda p, hh: pipeline.pipeline_blocks_apply(
                _block_fn, p, jnp.asarray(valid), hh, 4, mesh))(
            {"w": jnp.asarray(bw), "b": jnp.asarray(bb)}, h))
        inputs.update({"blocks.w": bw, "blocks.b": bb,
                       "blocks.valid": valid, "blocks.h": h})
    finally:
        topology._HYBRID = None
    _, arrays = run_ranks("pipefn", PP, tmp_path_factory.mktemp("pipefn"),
                          inputs)
    return want, arrays


def test_pipeline_forward_parity(cases):
    want, arrays = cases
    for r, a in enumerate(arrays):
        np.testing.assert_allclose(a["fwd"], want["fwd"], rtol=1e-5,
                                   atol=1e-6, err_msg=f"rank {r}")


@pytest.mark.parametrize("remat", [True, False])
def test_pipeline_grads_match_reference(cases, remat):
    want, arrays = cases
    for r, a in enumerate(arrays):
        np.testing.assert_allclose(a[f"grad.loss.{remat}"],
                                   want["grad.loss"], rtol=1e-5)
        for k in ("dw", "db"):
            np.testing.assert_allclose(a[f"grad.{k}.{remat}"],
                                       want[f"grad.{k}"], rtol=1e-4,
                                       atol=1e-5, err_msg=f"rank {r} {k}")


def test_pipeline_remat_matches_no_remat(cases):
    _, arrays = cases
    for a in arrays:
        for k in ("loss", "dw", "db"):
            np.testing.assert_array_equal(a[f"grad.{k}.True"],
                                          a[f"grad.{k}.False"])


def test_pipeline_blocks_apply_uneven_stages(cases):
    want, arrays = cases
    for r, a in enumerate(arrays):
        np.testing.assert_allclose(a["blocks"], want["blocks"], rtol=1e-5,
                                   atol=1e-6, err_msg=f"rank {r}")


def test_stack_stage_params_layout():
    """stack_stage_params keeps the reference's layout: the stage on the
    leading axis of every leaf."""
    import torch
    from paddle_tpu_torch.distributed import pipeline as port
    per = _params(7)
    mine = port.stack_stage_params(
        [tuple(torch.from_numpy(a) for a in p) for p in per])
    ref = pipeline.stack_stage_params([tuple(map(jnp.asarray, p))
                                       for p in per])
    for m, r in zip(mine, ref):
        np.testing.assert_array_equal(m.numpy(), np.asarray(r))
