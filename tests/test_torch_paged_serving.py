"""paddle_tpu_torch paged serving against the JAX reference on the CPU:
the port's ServingEngine (device="cpu") and the reference's
ServingEngine(paged=True, paged_attn=True) with its Pallas paged decode
kernel in interpret mode, over the same weights and the same traffic,
must produce token-identical greedy streams, the same prefix-cache hits
and a conserved block pool; plus eviction under block pressure, EOS
masking in the pipeline, rollback of a failed prefill, plan_prefix and
the radix index."""
import numpy as np
import pytest

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.paged.radix import RadixPrefixIndex as JaxRadix

from _torch_port import jax_gpt, torch_twin
from paddle_tpu_torch.serving import ServingEngine, StepScheduler
from paddle_tpu_torch.serving.paged.radix import RadixPrefixIndex


def _mixed_traffic():
    """tests/test_paged_serving.py's mixed traffic: shared-stem and
    disjoint prompts, more requests than slots."""
    rs = np.random.RandomState(0)
    stem = rs.randint(0, 97, (16,)).astype(np.int64)
    prompts = [np.concatenate([stem, rs.randint(0, 97, (k,))
                               .astype(np.int64)]) for k in (3, 6, 2, 9)]
    prompts += [rs.randint(0, 97, (n,)).astype(np.int64)
                for n in (5, 11, 7)]
    return prompts, [6, 4, 8, 5, 7, 3, 6]


def _pressure_traffic():
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 97, (n,)).astype(np.int64)
               for n in (9, 14, 6, 12, 8, 11)]
    return prompts, [5] * len(prompts)


def _drive(eng, prompts, specs, eos_id=None, on_token=None):
    """Staggered arrivals: two engine steps after every third request."""
    reqs = []
    for i, (p, k) in enumerate(zip(prompts, specs)):
        reqs.append(eng.add_request(p, max_new_tokens=k, eos_id=eos_id,
                                    on_token=on_token))
        if i % 3 == 2:
            eng.step()
            eng.step()
    eng.run()
    return reqs


MIXED = dict(num_slots=3, bucket_min=8, block_size=4)
PRESSURE = dict(num_slots=2, bucket_min=8, block_size=4, num_blocks=17,
                max_len=32)


def _jax_run(jm, knobs, traffic, eos_id=None):
    jpa._FORCE_INTERPRET[0] = True
    try:
        eng = JaxEngine(jm, paged=True, paged_attn=True, **knobs)
        assert eng.decode_layout == "paged_pallas"
        reqs = _drive(eng, *traffic, eos_id=eos_id)
    finally:
        jpa._FORCE_INTERPRET[0] = False
    return ([r.output_ids for r in reqs],
            eng.metrics.snapshot()["prefix_cache"])


@pytest.fixture(scope="module")
def models():
    jm = jax_gpt()
    return jm, torch_twin(jm)


@pytest.fixture(scope="module")
def jax_mixed(models):
    return _jax_run(models[0], MIXED, _mixed_traffic())


@pytest.mark.parametrize("async_depth", [0, 1])
def test_streams_match_reference_engine(models, jax_mixed, async_depth):
    jouts, jpc = jax_mixed
    eng = ServingEngine(models[1], device="cpu", async_depth=async_depth,
                        **MIXED)
    streamed = {}
    reqs = _drive(eng, *_mixed_traffic(),
                  on_token=lambda r, t: streamed.setdefault(r.rid,
                                                            []).append(t))
    for r, ref in zip(reqs, jouts):
        assert r.done
        np.testing.assert_array_equal(r.output_ids, ref)
        assert streamed[r.rid] == r.generated
    pc = eng.metrics.snapshot()["prefix_cache"]
    assert pc["hits"] == jpc["hits"] >= 3
    assert pc["misses"] == jpc["misses"]
    assert pc["cached_tokens"] == jpc["cached_tokens"]
    assert set(pc) == set(jpc)
    assert set(pc["pool"]) == set(jpc["pool"])
    eng.pool.check_conservation()
    assert eng.pool.live_blocks == 0


def test_eviction_under_block_pressure_matches_reference(models):
    """An undersized pool: admissions wait for blocks and LRU cached
    blocks are evicted and reused; streams still equal the reference
    engine's under the same pressure."""
    jouts, _ = _jax_run(models[0], PRESSURE, _pressure_traffic())
    eng = ServingEngine(models[1], device="cpu", **PRESSURE)
    reqs = _drive(eng, *_pressure_traffic())
    for r, ref in zip(reqs, jouts):
        np.testing.assert_array_equal(r.output_ids, ref)
    assert eng.pool.evictions > 0, "pressure never evicted"
    eng.pool.check_conservation()


def test_eos_stop_masks_the_inflight_token(models, jax_mixed):
    """An EOS stop is known only when its token is read, one step after
    the next decode went out: that in-flight token is masked, and each
    stream is its reference stream cut at the first EOS."""
    jouts, _ = jax_mixed
    prompts, specs = _mixed_traffic()
    eos = int(jouts[2][len(prompts[2]) + 2])   # a token that occurs
    eng = ServingEngine(models[1], device="cpu", eos_id=eos, **MIXED)
    reqs = _drive(eng, prompts, specs)
    for r, p, ref in zip(reqs, prompts, jouts):
        gen = list(ref[len(p):])
        if eos in gen:
            gen = gen[:gen.index(eos) + 1]
        assert r.generated == gen
        assert r.stop_reason == ("eos" if gen[-1] == eos
                                 else "max_tokens")
    assert eng.metrics.speculative_masked >= 1
    eng.pool.check_conservation()


def test_failed_prefill_rolls_back_and_recovers(models, jax_mixed):
    eng = ServingEngine(models[1], device="cpu", **MIXED)
    prompts, specs = _mixed_traffic()
    good = eng._prefill_fn

    def failing(*args):
        raise RuntimeError("injected prefill failure")

    eng._prefill_fn = failing
    reqs = [eng.add_request(p, max_new_tokens=k)
            for p, k in zip(prompts, specs)]
    with pytest.raises(RuntimeError, match="injected"):
        eng.run()
    assert eng.pool.free_count == MIXED["num_slots"]
    assert not eng.scheduler.active
    assert [r.rid for r in eng.scheduler.queue] == [r.rid for r in reqs]
    assert all(r.inflight == 0 and r.slot is None for r in reqs)
    eng.pool.check_conservation()
    assert eng.pool.live_blocks == 0
    eng._prefill_fn = good
    eng.run()
    for r, ref in zip(reqs, jax_mixed[0]):
        assert r.done
        np.testing.assert_array_equal(r.output_ids, ref)
    assert eng.metrics.requests_admitted == len(reqs)
    eng.pool.check_conservation()


def test_close_aborts_owed_work(models):
    eng = ServingEngine(models[1], device="cpu", **MIXED)
    prompts, specs = _mixed_traffic()
    reqs = [eng.add_request(p, max_new_tokens=k)
            for p, k in zip(prompts, specs)]
    eng.step()
    eng.step()
    eng.close()
    assert all(r.done for r in reqs)
    assert any(r.stop_reason == "aborted" for r in reqs)
    assert eng.pool.live_blocks == 0 and not eng.scheduler.pending
    eng.pool.check_conservation()
    with pytest.raises(RuntimeError):
        eng.add_request(prompts[0], 2)


def test_plan_prefix_respects_tail_and_capacity():
    """At least one tail token, block alignment, and the bucket-padded
    tail within the slot's capacity (the reference suite's cases)."""
    sch = StepScheduler([8, 16, 32, 48], 48)
    assert sch.plan_prefix(16, 16, 4, 48) == (12, 8)
    assert sch.plan_prefix(23, 16, 4, 48) == (16, 8)
    start, bucket = sch.plan_prefix(46, 44, 4, 48)
    assert (start, bucket) == (40, 8) and start + bucket <= 48
    assert sch.plan_prefix(30, 0, 4, 48) == (0, 32)


def test_radix_index_matches_reference_under_random_ops():
    """Insert / match / LRU-leaf eviction give the same answers as the
    reference's index over a random operation sequence."""
    rs = np.random.RandomState(12)
    ours, ref = RadixPrefixIndex(4), JaxRadix(4)
    stems = [rs.randint(0, 5, 12) for _ in range(3)]
    next_block = 1
    refs = {}
    for step in range(200):
        op = rs.randint(3)
        toks = np.concatenate([stems[rs.randint(3)],
                               rs.randint(0, 5, rs.randint(0, 9))])
        if op == 0:
            n = len(toks) // 4
            blocks = list(range(next_block, next_block + n))
            next_block += n
            assert ours.insert(toks, blocks) == ref.insert(toks, blocks)
        elif op == 1:
            assert ours.match(toks) == ref.match(toks)
        else:
            pinned = set(rs.choice(next_block, 3))
            b1 = ours.evict_lru(lambda b: b not in pinned)
            b2 = ref.evict_lru(lambda b: b not in pinned)
            assert b1 == b2
            refs[step] = b1
        assert len(ours) == len(ref)
        assert ours.stats() == ref.stats()
    assert any(b is not None for b in refs.values())
    assert ours.thrash_count == ref.thrash_count
