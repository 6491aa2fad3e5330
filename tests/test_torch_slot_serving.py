"""paddle_tpu_torch serving on the slot-contiguous pool against the JAX
reference on the CPU: ServingEngine(paged=False) in both packages, over
the same weights and the same traffic (tests/test_serving.py's
scenarios: staggered mixed lengths, slot reuse, EOS, a deep queue of
same-bucket groups, synchronous against pipelined), must give
token-identical greedy streams; plus the pool's lowest-slot-first
allocator under a random acquire/release sequence, the bucket and group
sets, and the decode attentions (stale rows masked, the per-query causal
block forms) against the reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jattn
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import SlotKVPool as JaxSlotPool
from paddle_tpu.serving import default_buckets as jax_buckets
from paddle_tpu.serving import default_group_sizes as jax_groups

from _torch_port import jax_gpt, torch_twin
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.serving import (ServingEngine, SlotKVPool,
                                      default_buckets, default_group_sizes)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while a module's tests run: the serving tests
    run thousands of tiny ops, and under parallel test workers each op's
    thread team waits on the others' (tens of times slower). Autouse
    here and in the modules that import it; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _prompts(rs, lengths):
    return [rs.randint(0, 97, (n,)).astype(np.int64) for n in lengths]


def _staggered():
    rs = np.random.RandomState(0)
    specs = [(3, 6), (11, 9), (7, 4), (20, 12), (5, 8), (13, 5), (9, 7),
             (26, 10)]
    return _prompts(rs, [n for n, _ in specs]), [k for _, k in specs]


def _reuse():
    rs = np.random.RandomState(1)
    return _prompts(rs, [4, 9, 6, 12, 5]), [6] * 5


def _deep_queue():
    rs = np.random.RandomState(8)
    specs = [(5, 4), (7, 5), (3, 6), (6, 4), (11, 5), (13, 4), (9, 6),
             (14, 5), (4, 4), (8, 5), (12, 4), (10, 6)]
    return _prompts(rs, [n for n, _ in specs]), [k for _, k in specs]


# name -> (traffic, engine knobs, arrivals staggered?)
SCENARIOS = {
    "staggered": (_staggered, dict(num_slots=3), True),
    "reuse": (_reuse, dict(num_slots=2), False),
    "deep_queue": (_deep_queue, dict(num_slots=4), False),
    "singleton_groups": (_staggered, dict(num_slots=3,
                                          prefill_group_sizes=(1,)), False),
}


def _drive(eng, prompts, specs, staggered, eos_id=None, on_token=None):
    reqs = []
    for i, (p, k) in enumerate(zip(prompts, specs)):
        reqs.append(eng.add_request(p, max_new_tokens=k, eos_id=eos_id,
                                    on_token=on_token))
        if staggered and i % 3 == 2:
            eng.step()
            eng.step()
    eng.run()
    return reqs


@pytest.fixture(scope="module")
def models():
    jm = jax_gpt()
    return jm, torch_twin(jm)


@pytest.fixture(scope="module")
def jax_streams(models):
    """Each scenario's JAX slot-pool streams, computed once."""
    out = {}
    for name, (traffic, knobs, staggered) in SCENARIOS.items():
        eng = JaxEngine(models[0], paged=False, bucket_min=8, **knobs)
        reqs = _drive(eng, *traffic(), staggered)
        out[name] = ([r.output_ids for r in reqs],
                     eng.metrics.prefill_group_hist)
    return out


@pytest.mark.parametrize("async_depth", [0, 1])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_streams_match_reference_engine(models, jax_streams, name,
                                        async_depth):
    traffic, knobs, staggered = SCENARIOS[name]
    refs, hist = jax_streams[name]
    eng = ServingEngine(models[1], device="cpu", paged=False, bucket_min=8,
                        async_depth=async_depth, **knobs)
    streamed = {}
    reqs = _drive(eng, *traffic(), staggered,
                  on_token=lambda r, t: streamed.setdefault(
                      r.rid, []).append(t))
    for r, ref in zip(reqs, refs):
        assert r.done
        np.testing.assert_array_equal(r.output_ids, ref)
        assert streamed[r.rid] == r.generated
    # the same admission groups as the reference
    assert eng.metrics.prefill_group_hist == hist
    assert eng.metrics.prefill_requests == len(reqs)
    assert eng.pool.free_count == eng.pool.num_slots
    if name == "reuse":
        assert eng.pool.reuse_count >= 3
    if name == "deep_queue":
        assert any(g > 1 for g in hist)
        assert eng.metrics.prefills < len(reqs)
    if async_depth == 0:
        assert eng.metrics.speculative_masked == 0


def test_eos_stops_slot_early_and_frees_it(models, jax_streams):
    """Declaring a token the staggered traffic emits as EOS: each stream
    is the reference stream cut at its first EOS, the in-flight token
    past it masked."""
    refs, _ = jax_streams["staggered"]
    prompts, specs = _staggered()
    eos = int(refs[3][len(prompts[3]) + 2])
    eng = ServingEngine(models[1], device="cpu", paged=False, bucket_min=8,
                        num_slots=3, eos_id=eos)
    reqs = _drive(eng, prompts, specs, True)
    stopped = 0
    for r, p, ref in zip(reqs, prompts, refs):
        gen = [int(t) for t in ref[len(p):]]
        if eos in gen:
            gen = gen[:gen.index(eos) + 1]
            stopped += 1
        assert r.generated == gen
    assert stopped >= 1 and eng.metrics.speculative_masked >= 1
    assert eng.pool.free_count == 3


def test_recycled_slot_equals_fresh_engine(models):
    prompts, _ = _reuse()
    eng = ServingEngine(models[1], device="cpu", paged=False, bucket_min=8,
                        num_slots=2)
    reqs = [eng.add_request(p, max_new_tokens=6) for p in prompts]
    eng.run()
    eng2 = ServingEngine(models[1], device="cpu", paged=False, bucket_min=8,
                         num_slots=2)
    r2 = eng2.add_request(prompts[-1], max_new_tokens=6)
    eng2.run()
    np.testing.assert_array_equal(r2.output_ids, reqs[-1].output_ids)


def test_failed_group_prefill_rolls_back(models, jax_streams):
    eng = ServingEngine(models[1], device="cpu", paged=False, bucket_min=8,
                        num_slots=4)
    good = eng._prefill_fn
    eng._prefill_fn = lambda *a: (_ for _ in ()).throw(
        RuntimeError("injected prefill failure"))
    prompts, specs = _deep_queue()
    reqs = [eng.add_request(p, max_new_tokens=k)
            for p, k in zip(prompts, specs)]
    with pytest.raises(RuntimeError, match="injected"):
        eng.run()
    assert eng.pool.free_count == 4 and not eng.scheduler.active
    assert [r.rid for r in eng.scheduler.queue] == [r.rid for r in reqs]
    assert all(r.inflight == 0 and r.slot is None for r in reqs)
    eng._prefill_fn = good
    eng.run()
    for r, ref in zip(reqs, jax_streams["deep_queue"][0]):
        np.testing.assert_array_equal(r.output_ids, ref)
    assert eng.metrics.requests_admitted == len(reqs)


def test_pool_acquire_release_fuzz_matches_reference():
    """Random acquire/release traffic: the same slots as the reference
    pool, the lowest free one each time, None when full, double release
    raising, the same reuse count."""
    ours = SlotKVPool(4, 1, 1, 8, 4, device="cpu")
    ref = JaxSlotPool(4, 1, 1, 8, 4)
    rs = np.random.RandomState(9)
    live = set()
    for i in range(300):
        if live and (ours.free_count == 0 or rs.rand() < 0.45):
            slot = int(rs.choice(sorted(live)))
            ours.release(slot)
            ref.release(slot)
            live.discard(slot)
            with pytest.raises(ValueError):
                ours.release(slot)
        else:
            free_before = set(ours._free)
            slot = ours.acquire(i)
            assert slot == ref.acquire(i) == min(free_before)
            assert ours.owner_of(slot) == i
            live.add(slot)
        assert set(ours._free) | live == {0, 1, 2, 3}
        assert ours.free_count == ref.free_count
        assert ours.occupancy == ref.occupancy
        if ours.free_count == 0:
            assert ours.acquire(-1) is None
    assert ours.reuse_count == ref.reuse_count >= 50
    assert ours.nbytes() == 2 * 4 * 8 * 4 * 4


@pytest.mark.parametrize("n", [1, 6, 8, 48, 64, 100])
def test_bucket_and_group_sets_match_reference(n):
    for bmin in (1, 8, 32, 64):
        assert default_buckets(n, bmin) == jax_buckets(n, bmin)
    assert default_group_sizes(n) == jax_groups(n)


def _attn_inputs(seed, S=3, nh=2, C=16, hd=8, t=3, NB=9, BS=4):
    rs = np.random.RandomState(seed)
    q1 = rs.randn(S, nh, hd).astype(np.float32)
    qt = rs.randn(S, nh, t, hd).astype(np.float32)
    kc = (rs.randn(S, nh, C, hd) * 50).astype(np.float32)   # garbage rows
    vc = (rs.randn(S, nh, C, hd) * 50).astype(np.float32)
    kp = (rs.randn(NB, nh, BS, hd) * 50).astype(np.float32)
    vp = (rs.randn(NB, nh, BS, hd) * 50).astype(np.float32)
    tables = rs.randint(0, NB, (S, C // BS)).astype(np.int32)
    lengths = np.array([1, 7, C], np.int32)
    qpos = np.stack([np.arange(t) + p for p in (0, 6, C - t)]).astype(
        np.int32)
    return q1, qt, kc, vc, kp, vp, tables, lengths, qpos


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_attentions_match_reference(seed):
    """cached_slot_attention masks stale rows (huge garbage carries zero
    weight) as the reference does; the block forms apply the per-query
    causal mask kpos <= qpos; the paged forms gather through the table."""
    q1, qt, kc, vc, kp, vp, tables, lengths, qpos = _attn_inputs(seed)
    T = torch.from_numpy
    J = jnp.asarray
    pairs = [
        (tattn.cached_slot_attention(T(q1), T(kc), T(vc), T(lengths)),
         jattn.cached_slot_attention(J(q1), J(kc), J(vc), J(lengths))),
        (tattn.cached_paged_attention(T(q1), T(kp), T(vp), T(tables),
                                      T(lengths)),
         jattn.cached_paged_attention(J(q1), J(kp), J(vp), J(tables),
                                      J(lengths))),
        (tattn.cached_slot_block_attention(T(qt), T(kc), T(vc), T(qpos)),
         jattn.cached_slot_block_attention(J(qt), J(kc), J(vc), J(qpos))),
        (tattn.cached_paged_block_attention(T(qt), T(kp), T(vp), T(tables),
                                            T(qpos)),
         jattn.cached_paged_block_attention(J(qt), J(kp), J(vp), J(tables),
                                            J(qpos))),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-4)
    # t = 1 at qpos = lengths - 1 is cached_slot_attention
    one = tattn.cached_slot_block_attention(
        T(q1)[:, :, None], T(kc), T(vc), T(lengths - 1)[:, None])[:, :, 0]
    np.testing.assert_allclose(one.numpy(), pairs[0][0].numpy(), rtol=1e-6,
                               atol=1e-5)
    # each slot sees its live prefix only
    s, L = 1, int(lengths[1])
    sc = np.einsum("hd,hkd->hk", q1[s], kc[s, :, :L]) / np.sqrt(8.0)
    w = np.exp(sc - sc.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    np.testing.assert_allclose(pairs[0][0][s].numpy(),
                               np.einsum("hk,hkd->hd", w, vc[s, :, :L]),
                               rtol=1e-4, atol=1e-3)
