"""paddle_tpu_torch's speculative decoding against the JAX reference on
the CPU (tests/test_spec.py's scenarios): the n-gram drafter and the
SpecDecoder give the reference objects' proposals, index sizes and
acceptance EWMAs on the same token streams; the verify programs give
the reference programs' outputs, acceptances and cache writes (parked
and near-full slots included) on both pools; and the engine's streams
with speculation on equal plain greedy and the JAX spec engine's, on
both pools at both pipeline depths, with drafts that agree with greedy
accepted in full."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.spec import NGramDrafter as JaxDrafter
from paddle_tpu.serving.spec import SpecDecoder as JaxSpecDecoder
from paddle_tpu.serving.spec.programs import (
    build_paged_spec_verify_fn as jax_paged_verify,
    build_spec_verify_fn as jax_verify)

from _torch_port import jax_gpt, torch_twin
from test_torch_slot_serving import one_torch_thread  # noqa: F401
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.spec import NGramDrafter, SpecDecoder
from paddle_tpu_torch.serving.spec.programs import (
    build_paged_spec_verify_fn, build_spec_verify_fn)


def _prompts(rs, lengths):
    return [rs.randint(0, 97, (n,)).astype(np.int64) for n in lengths]


@pytest.fixture(scope="module")
def models():
    jm = jax_gpt()
    return jm, torch_twin(jm)


# ----------------------------------------------------------- drafter unit

def test_drafter_rejects_bad_width():
    with pytest.raises(ValueError):
        NGramDrafter(0)
    with pytest.raises(ValueError):
        NGramDrafter(4, ngram_max=1, ngram_min=2)


@pytest.mark.parametrize("symbols,k", [(12, 4), (5, 3), (40, 2)])
def test_drafter_proposals_match_reference(symbols, k):
    """Identical streams give the reference's proposals at every length,
    at every width cap, on two slots that share prompts."""
    rs = np.random.RandomState(symbols)
    stream = [int(t) for t in rs.randint(0, symbols, (200,))]
    ours, ref = NGramDrafter(k), JaxDrafter(k)
    hits = 0
    for i in range(8, len(stream)):
        for slot in (0, 1):
            toks = stream[:i] if slot == 0 else stream[:8] + stream[:i - 8]
            ours.sync(slot, f"r{slot}", toks)
            ref.sync(slot, f"r{slot}", toks)
            for w in (None, 1, k - 1):
                p = ours.propose(slot, width=w)
                assert p == ref.propose(slot, width=w)
                hits += bool(p)
    assert hits
    assert ours.index_sizes() == ref.index_sizes()


def test_drafter_continuation_and_bounds_match_reference():
    for cls in (NGramDrafter, JaxDrafter):
        d = cls(3)
        d.sync(0, "r1", [1, 2, 3, 9, 8, 7, 1, 2, 3])
        assert d.propose(0) == [9, 8, 7]
        assert d.propose(0, width=2) == [9, 8]
        assert d.propose(0, width=0) == []
    ours = NGramDrafter(4, max_entries=64, shared_entries=128)
    ref = JaxDrafter(4, max_entries=64, shared_entries=128)
    for d in (ours, ref):
        d.sync(0, "r1", list(range(10_000)))
        assert d.propose(0) == []
        for i in range(300):
            d.sync(0, f"r{i}", [(i * 31 + j) % 9973 for j in range(24)])
    assert ours.index_sizes() == ref.index_sizes()
    sizes = ours.index_sizes()
    assert sizes[0] <= 64 and sizes["shared"] <= 128
    assert sizes["seen_prompts"] <= 128 and len(ours._slots) == 1
    prompt = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6]
    d = NGramDrafter(4)
    d.sync(0, "r1", prompt)
    d.sync(1, "r2", prompt)
    assert d.propose(1) == [7, 8, 5, 6]
    assert d.index_sizes()["seen_prompts"] == 1


class _R:
    def __init__(self, rid, ids, gen, max_new, inflight=0):
        self.rid, self.prefill_ids = rid, ids
        self.generated, self.max_new_tokens = gen, max_new
        self.inflight = inflight


def test_spec_decoder_matches_reference():
    """The fixed [S, k] drafts (zero padded), the width cap, the
    in-flight guard and the EWMA gate, as the reference decides them."""
    rep = [1, 2, 3, 1, 2, 3, 1, 2]
    snap = {0: _R("a", rep + [3], [3], 16), 2: _R("b", [9, 8, 7], [7], 16),
            3: _R("c", rep + [3], [3], 3)}
    ours = SpecDecoder(4, 4, 0.5, ewma_alpha=0.5)
    ref = JaxSpecDecoder(4, 4, 0.5, ewma_alpha=0.5)
    for step in range(3):
        a, b = ours.propose(snap), ref.propose(snap)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
        assert a[0].shape == (4, 4) and a[0].dtype == np.int32
        assert a[1][3] <= 1 and (a[0][0, a[1][0]:] == 0).all()
        for d in (ours, ref):
            d.observe("a", 4, 0)        # 1.0 -> 0.5 -> 0.25: gated
        assert ours.acceptance_ewma("a") == ref.acceptance_ewma("a")
    assert 0 not in ours.propose(snap)[2]
    snap[3].inflight = 1
    assert ours.propose(snap)[2] == ref.propose(snap)[2] == {}
    for i in range(5000):
        ours.observe(f"x{i}", 4, 2)
    assert len(ours._ewma) <= 4096


# ---------------------------------------------------------- verify programs

def _verify_state(jm, S, C, k, seed, paged=False, BS=4):
    """Random caches, positions (a fresh slot, a mid one, one near the
    end, one parked past it) and drafts half of which are greedy."""
    rs = np.random.RandomState(seed)
    c = jm.cfg
    L, nh, hd = c.num_layers, c.num_heads, c.hidden_size // c.num_heads
    if paged:
        MB = C // BS
        NB = S * MB + 1
        shape = (L, NB, nh, BS, hd)
        perm = rs.permutation(np.arange(1, NB))
        tables = perm[:S * MB].reshape(S, MB).astype(np.int32)
        tables[1, MB // 2:] = 0          # a trash-padded row
    else:
        shape = (L, S, nh, C, hd)
        tables = None
    kc = rs.randn(*shape).astype(np.float32)
    vc = rs.randn(*shape).astype(np.float32)
    pos = np.array([0, 9, C - 2, C + 3], np.int32)[:S]
    toks = rs.randint(0, 97, (S,)).astype(np.int32)
    drafts = rs.randint(0, 97, (S, k)).astype(np.int32)
    dlen = np.array([k, 2, k, 0], np.int32)[:S]
    return toks, pos, drafts, dlen, tables, kc, vc


@pytest.mark.parametrize("paged", [False, True])
def test_verify_programs_match_reference(models, paged):
    jm, tm = models
    S, C, k = 4, 32, 4
    jp = jm.export_decode_params()
    tp = tm.export_decode_params()
    for seed in range(3):
        toks, pos, drafts, dlen, tables, kc, vc = _verify_state(
            jm, S, C, k, seed, paged)
        if paged:
            jf = jax_paged_verify(jm.cfg, S, 4, kc.shape[1], C // 4, k)
            tf = build_paged_spec_verify_fn(tm.cfg, S, 4, kc.shape[1],
                                            C // 4, k)
        else:
            jf = jax_verify(jm.cfg, S, C, k)
            tf = build_spec_verify_fn(tm.cfg, S, C, k)
        if seed == 1:
            # drafts that continue the greedy choice, as far as they go
            jout = np.asarray(jf(jp, *map(jnp.asarray, (toks, pos, drafts,
                                                        dlen * 0)),
                                 *([jnp.asarray(tables)] if paged else []),
                                 jnp.asarray(kc), jnp.asarray(vc))[0])
            drafts[:, 0] = jout[:, 0]
        jt = jnp.asarray(tables) if paged else None
        jres = jf(jp, jnp.asarray(toks), jnp.asarray(pos),
                  jnp.asarray(drafts), jnp.asarray(dlen),
                  *([jt] if paged else []), jnp.asarray(kc), jnp.asarray(vc))
        T = torch.from_numpy
        tk, tv = T(kc.copy()), T(vc.copy())
        tres = tf(tp, T(toks), T(pos), T(drafts), T(dlen),
                  *([T(tables)] if paged else []), tk, tv)
        for ours, ref in zip(tres, jres[:4]):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        # the written caches agree (trash block 0 holds garbage)
        lo = 1 if paged else 0
        for ours, ref in ((tk, jres[4]), (tv, jres[5])):
            np.testing.assert_allclose(ours.numpy()[:, lo:],
                                       np.asarray(ref)[:, lo:], rtol=1e-5,
                                       atol=1e-5)
        # a parked slot's rows are untouched on the slot pool
        if not paged:
            np.testing.assert_array_equal(tk.numpy()[:, 3], kc[:, 3])


# ------------------------------------------------------------ engine parity

N_NEW = 24


def _spec_traffic():
    rs = np.random.RandomState(0)
    return _prompts(rs, (5, 9, 13, 7, 21, 6))


@pytest.fixture(scope="module")
def jax_spec(models):
    """The JAX spec engine's streams on each pool."""
    out = {}
    for paged in (False, True):
        eng = JaxEngine(models[0], num_slots=4, bucket_min=8, paged=paged,
                        speculative=True, spec_k=4)
        reqs = [eng.add_request(p, max_new_tokens=N_NEW)
                for p in _spec_traffic()]
        eng.run()
        out[paged] = [r.output_ids for r in reqs]
    return out


@pytest.mark.parametrize("async_depth", [0, 1])
@pytest.mark.parametrize("paged", [False, True])
def test_spec_streams_match_greedy_and_reference(models, jax_spec, paged,
                                                 async_depth):
    outs = {}
    for spec in (False, True):
        eng = ServingEngine(models[1], device="cpu", num_slots=4,
                            bucket_min=8, paged=paged,
                            async_depth=async_depth, speculative=spec,
                            spec_k=4)
        reqs = [eng.add_request(p, max_new_tokens=N_NEW)
                for p in _spec_traffic()]
        eng.run()
        outs[spec] = [r.output_ids for r in reqs]
    for a, b, ref in zip(outs[True], outs[False], jax_spec[paged]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, ref)
    spec = eng.metrics.snapshot()["perf"]["spec"]
    assert spec["enabled"] is True and spec["k"] == 4
    assert spec["verify_steps"] > 0
    assert spec["drafted_tokens"] == \
        spec["accepted_tokens"] + spec["rejected_tokens"]
    assert spec["effective_tokens_per_dispatch"] >= 1.0
    assert eng.metrics.decode_steps == \
        spec["verify_steps"] + spec["fallback_steps"]
    if paged:
        eng.pool.check_conservation()


class _OracleDrafter:
    """Proposes the model's true greedy continuation."""

    def __init__(self, k, refs):
        self.k = k
        self._refs = [[int(t) for t in r] for r in refs]
        self._ctx = {}

    def sync(self, slot, rid, tokens):
        self._ctx[slot] = [int(t) for t in tokens]

    def propose(self, slot, width=None):
        toks = self._ctx[slot]
        w = self.k if width is None else min(self.k, int(width))
        for ref in self._refs:
            if len(ref) > len(toks) and ref[:len(toks)] == toks:
                return ref[len(toks):len(toks) + w]
        return []


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_agreeing_drafts_totally_accepted(models, jax_spec, paged):
    refs = jax_spec[paged][:3]
    eng = ServingEngine(models[1], device="cpu", num_slots=4, bucket_min=8,
                        paged=paged, speculative=True, spec_k=4)
    eng._spec.drafter = _OracleDrafter(4, refs)
    reqs = [eng.add_request(p, max_new_tokens=N_NEW)
            for p in _spec_traffic()[:3]]
    eng.run()
    for r, ref in zip(reqs, refs):
        np.testing.assert_array_equal(r.output_ids, ref)
    spec = eng.metrics.snapshot()["perf"]["spec"]
    assert spec["drafted_tokens"] > 0 and spec["rejected_tokens"] == 0
    assert spec["acceptance_rate"] == 1.0
    assert spec["effective_tokens_per_dispatch"] >= 3.0


def test_spec_eos_inside_a_block(models, jax_spec):
    """An EOS among accepted drafts retires the request there; the tail
    of the block never surfaces."""
    refs = jax_spec[True]
    prompts = _spec_traffic()
    eos = int(refs[4][len(prompts[4]) + 9])
    eng = ServingEngine(models[1], device="cpu", num_slots=4, bucket_min=8,
                        speculative=True, spec_k=4, eos_id=eos)
    eng._spec.drafter = _OracleDrafter(4, refs)
    reqs = [eng.add_request(p, max_new_tokens=N_NEW) for p in prompts]
    eng.run()
    for r, p, ref in zip(reqs, prompts, refs):
        gen = [int(t) for t in ref[len(p):]]
        if eos in gen:
            gen = gen[:gen.index(eos) + 1]
        assert r.generated == gen
    eng.pool.check_conservation()
    assert eng.pool.live_blocks == 0


def test_config_rejects_bad_spec_knobs(models):
    m = models[1]
    for kw in (dict(spec_k=0), dict(spec_min_accept=1.5),
               dict(sampling=True)):
        with pytest.raises(ValueError):
            ServingEngine(m, device="cpu", num_slots=2, speculative=True,
                          **kw)
    with pytest.raises(ValueError):
        ServingEngine(m, device="cpu", num_slots=2, max_len=8, bucket_min=8,
                      speculative=True, spec_k=8)
    eng = ServingEngine(m, device="cpu", num_slots=2)
    assert eng.speculative is False and eng._spec is None
    assert eng.metrics.snapshot()["perf"]["spec"]["enabled"] is False
