"""Sequence parallelism in the port (ops.ring_attention, the GPT's
``use_sp``) against the reference, over gloo processes on the CPU.

Rank ``r`` of the ``sp`` group holds block ``r`` of the sequence; the
reference runs here on a mesh over ``jax.devices()[:n]`` with the whole
sequence (its shard_map splits it the same way). Ring and Ulysses
attention at ``sp`` = 2 and 4, causal and not: each rank's output and
the grads of its q/k/v blocks (the backward of sum(out * cot)) against
the blocks of the reference's ``ring_attention``/``ulysses_attention``
and their ``jax.vjp``. The tiny GPT with ``use_sp`` (ring and Ulysses,
with and without recompute, at ``sp`` = 2) and with ``use_mp`` and
``use_sp`` together (``mp`` = ``sp`` = 2, the reference's
test_sequence_parallel.py:108-151 composition): the loss and every
grad, summed over the ``sp`` ranks by ``fleet.distributed_model``'s
wrapper and gathered over ``mp``, against the reference's GPT on its
mesh, on the same weights. Two spawns (2 and 4 ranks), about 15 s each.

Tolerances, f32: attention outputs and grads rtol 1e-5, atol 1e-6 (the
online softmax over blocks in the same order as the reference's; the
Ulysses core is the port's plain flash attention, the reference's its
dense composition); the GPT's loss rtol 1e-5 and grads rtol 1e-5, atol
1e-6.
"""
import jax
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import topology as ref_topology
from paddle_tpu.ops import ring_attention as ref_ra
from paddle_tpu.text.models import GPTForCausalLM, TransformerLMConfig

from _torch_dist import run_ranks
from torch_dist_worker import TINY_GPT, attn_inputs, gpt_batch

GPT_CASES = {"ring": ("ring", False), "ring_rc": ("ring", True),
             "ulysses": ("ulysses", False), "ulysses_rc": ("ulysses", True)}


def _mesh(**degrees):
    n = int(np.prod(list(degrees.values())))
    return ref_topology.build_mesh(devices=jax.devices()[:n], **degrees)


def _ref_attention(n, mode, causal):
    q, k, v, cot = attn_inputs(5)
    fn = ref_ra.ring_attention if mode == "ring" else ref_ra.ulysses_attention
    mesh = _mesh(sp=n)

    @jax.jit
    def fwd_bwd(a, b, c, ct):
        out, vjp = jax.vjp(lambda a_, b_, c_: fn(a_, b_, c_, mesh,
                                                 causal=causal), a, b, c)
        return (out,) + vjp(ct)
    got = fwd_bwd(q, k, v, cot)
    return {k_: np.asarray(a) for k_, a in zip(("o", "dq", "dk", "dv"), got)}


def _ref_weights():
    paddle.seed(13)
    m = GPTForCausalLM(TransformerLMConfig(**TINY_GPT))
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _ref_gpt(weights, mode, recompute, **degrees):
    """The reference GPT with use_sp (and use_mp with an mp degree) on its
    mesh, on ``weights``: the loss and every grad."""
    ref_topology.HybridCommunicateGroup(mesh=_mesh(**degrees), **degrees)
    try:
        m = GPTForCausalLM(TransformerLMConfig(
            use_sp=True, use_mp="mp" in degrees, sp_mode=mode,
            recompute=recompute, **TINY_GPT))
        m.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
        m.train()
        ids, labels = gpt_batch(1)
        loss = m(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        loss.backward()
        return float(loss.numpy()), {n: np.asarray(p.grad.numpy())
                                     for n, p in m.named_parameters()}
    finally:
        ref_topology._HYBRID = None


@pytest.fixture(scope="module")
def weights():
    return _ref_weights()


@pytest.fixture(scope="module")
def spawns(weights, tmp_path_factory):
    done = {}

    def get(n):
        if n not in done:
            inputs = {f"ref.{k}": v for k, v in weights.items()}
            if n == 4:
                inputs["gpt.mpsp"] = np.zeros(1)
            done[n] = run_ranks("sp", n, tmp_path_factory.mktemp(f"sp{n}"),
                                inputs)
        return done[n]
    return get


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_reference(spawns, n, mode, causal):
    _, arrays = spawns(n)
    want = _ref_attention(n, mode, causal)
    for r, a in enumerate(arrays):
        for k, w in want.items():
            blk = np.split(w, n, axis=2)[r]
            np.testing.assert_allclose(a[f"{mode}.{int(causal)}.{k}"], blk,
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("n", [2, 4])
def test_host_staged_route_gives_the_same_bits(spawns, n):
    """The route of ranks that share a card (the collectives gloo takes
    no CUDA tensor in, staged through a host copy), forced on the CPU:
    ring and Ulysses give the unstaged route's bits, forward and grads,
    and the staged collectives are counted."""
    lines, arrays = spawns(n)
    for line, a in zip(lines, arrays):
        assert line["host_staged"].get("send", 0) > 0       # the ring
        assert line["host_staged"].get("alltoall", 0) > 0   # Ulysses
        for mode in ("ring", "ulysses"):
            for k in ("o", "dq", "dk", "dv"):
                np.testing.assert_array_equal(a[f"staged.{mode}.1.{k}"],
                                              a[f"{mode}.1.{k}"])


def _check_gpt(lines, arrays, tag, loss, grads):
    for r, (line, a) in enumerate(zip(lines, arrays)):
        np.testing.assert_allclose(line[f"gpt.{tag}.loss"], loss, rtol=1e-5)
        got = {k[len(tag) + 10:]: v for k, v in a.items()
               if k.startswith(f"gpt.{tag}.grad.")}
        assert set(got) == set(grads)
        for k, g in grads.items():
            np.testing.assert_allclose(got[k], g, rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} {tag} {k}")


@pytest.mark.parametrize("tag", list(GPT_CASES))
def test_gpt_sp2_matches_reference(spawns, weights, tag):
    """use_sp at sp = 2, ring and Ulysses, with and without recompute."""
    lines, arrays = spawns(2)
    mode, rc = GPT_CASES[tag]
    loss, grads = _ref_gpt(weights, mode, rc, sp=2)
    _check_gpt(lines, arrays, tag, loss, grads)


def test_gpt_mp_and_sp_combined_matches_reference(spawns, weights):
    """use_mp and use_sp together on 4 ranks (mp = 2 x sp = 2, ring)."""
    lines, arrays = spawns(4)
    loss, grads = _ref_gpt(weights, "ring", False, mp=2, sp=2)
    _check_gpt(lines, arrays, "mpsp", loss, grads)
