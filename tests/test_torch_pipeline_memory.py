"""Pipeline memory in the port (reference tests/test_pipeline_memory.py:
the schedule exists to bound the activations alive at once, Paddle's
SectionWorker 1F1B, section_worker.cc:34-103). Two gloo rank processes at
pp = 2 (tests/torch_dist_worker.py, suite ``pipemem``) run
``pipeline_loss_and_grad`` over one batch of 64 rows cut into 4 and into
16 microbatches: the loss is the same (rtol 1e-5, as the reference's test
holds it), equal to the reference's on its pp = 2 mesh, and the
microbatches alive at once on a stage stay at most pp whatever their
count (1F1B), where a forward-all-then-backward schedule would hold all
of them. The peak device memory flat in the microbatch count at a fixed
microbatch size is held on the card (tests/test_torch_dist_cuda.py).
About 10 s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from paddle_tpu.distributed.pipeline import pipeline_loss_and_grad

from _torch_dist import run_ranks

PP, B, H, L = 2, 64, 32, 3


def mem_inputs():
    rng = np.random.RandomState(0)
    w = (rng.randn(PP, L, H, H) * 0.05).astype(np.float32)
    b = np.zeros((PP, L, H), np.float32)
    rng = np.random.RandomState(1)
    return {"mem.w": w, "mem.b": b,
            "mem.x": rng.randn(B, H).astype(np.float32),
            "mem.y": rng.randn(B, H).astype(np.float32)}


def _stage_fn(params, x):
    def one(carry, wl):
        w, b = wl
        return jnp.tanh(carry @ w + b), None

    y, _ = jax.lax.scan(one, x, (params["w"], params["b"]))
    return y


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = mem_inputs()
    lines, _ = run_ranks("pipemem", PP, tmp_path_factory.mktemp("pipemem"),
                         inputs)
    mesh = Mesh(np.array(jax.devices()[:PP]), ("pp",))
    stacked = {"w": jnp.asarray(inputs["mem.w"]),
               "b": jnp.asarray(inputs["mem.b"])}
    loss, _ = jax.jit(lambda p, x, y: pipeline_loss_and_grad(
        _stage_fn, lambda o, t: jnp.mean((o - t) ** 2), p, x, y, mesh,
        "pp"))(stacked, inputs["mem.x"].reshape(4, -1, H),
               inputs["mem.y"].reshape(4, -1, H))
    return lines, float(loss)


def test_loss_matches_across_microbatch_counts(runs):
    lines, ref = runs
    for line in lines:
        assert line["loss4"] == pytest.approx(line["loss16"], rel=1e-5)
        assert line["loss4"] == pytest.approx(ref, rel=1e-5)


def test_activations_alive_bounded_by_stages(runs):
    """1F1B: stage s holds at most pp - s microbatches' activations, at 4
    microbatches and at 16 alike."""
    lines, _ = runs
    for s, line in enumerate(lines):
        assert line["in_flight4"] == line["in_flight16"] == PP - s
