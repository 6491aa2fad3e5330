"""paddle_tpu_torch's KV wire and the prefill/decode handoff against the
JAX reference on the CPU (tests/test_kv_wire.py's scenarios): payloads
byte-identical to the reference's for the same tiles, f32 and bf16
(bf16 decoded without ml_dtypes); round trips byte-exact; a corrupted
frame refused with KVWireError before any pool change; a prefill ->
export -> import -> decode handoff within the port equal to a
monolithic engine with no leaked block; and the handoff across the two
packages both ways: a JAX export resumes the JAX monolithic stream in
the port's decode engine, and a port export resumes it in the JAX
decode engine."""
import json

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import kv_wire as jwire

from _torch_port import jax_gpt, torch_twin
from test_torch_slot_serving import one_torch_thread  # noqa: F401
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.kv_wire import (KVWireError, blocks_for_prompt,
                                              deserialize_handoff,
                                              payload_wire_bytes,
                                              serialize_handoff)


def _tiles(dtype, n_blocks=3, bs=8, seed=0):
    rs = np.random.RandomState(seed)
    shape = (2, n_blocks, 4, bs, 16)
    return (torch.from_numpy(rs.randn(*shape)).to(dtype),
            torch.from_numpy(rs.randn(*shape)).to(dtype))


def _np(t):
    """A tile tensor as the reference's numpy array (bf16 through
    ml_dtypes, bit for bit)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_round_trip_and_byte_compatibility(dtype):
    k, v = _tiles(dtype)
    prompt = list(range(2 * 8 + 3))          # partial last block
    payload = json.loads(json.dumps(serialize_handoff(k, v, prompt, 42)))
    ref = jwire.serialize_handoff(_np(k), _np(v), prompt, 42)
    assert payload == json.loads(json.dumps(ref))
    assert payload_wire_bytes(payload) == k.nbytes + v.nbytes
    for h in (deserialize_handoff(payload), deserialize_handoff(ref)):
        assert h.prompt == prompt and h.first_token == 42
        assert h.n_blocks == blocks_for_prompt(len(prompt), 8) == 3
        assert h.k.dtype == dtype and h.wire_bytes == k.nbytes + v.nbytes
        assert torch.equal(h.k.view(torch.uint8), k.view(torch.uint8))
        assert torch.equal(h.v.view(torch.uint8), v.view(torch.uint8))
    # and the reference decodes the port's payload to the same bits
    rh = jwire.deserialize_handoff(payload)
    assert rh.k.tobytes() == _np(k).tobytes()


def test_partial_last_block_counts_whole():
    assert [blocks_for_prompt(n, 16) for n in (1, 16, 17)] == [1, 1, 2]
    with pytest.raises(ValueError):
        blocks_for_prompt(0, 16)
    k, v = _tiles(torch.float32, n_blocks=2)
    with pytest.raises(ValueError):
        serialize_handoff(k[:, :1], v[:, :1], list(range(9)), 0)


@pytest.mark.parametrize("mutate", [
    lambda p: p["frames"][1].__setitem__("digest",
                                         p["frames"][1]["digest"] ^ 1),
    lambda p: p.__setitem__("version", 99),
    lambda p: p.__setitem__("prompt", []),
    lambda p: p["frames"].pop(),
    lambda p: p["frames"][0].__setitem__("k", "!!notb64"),
    lambda p: p.__setitem__("dtype", "int7"),
    lambda p: p.pop("tile_shape"),
])
def test_damaged_payload_raises_typed_error(mutate):
    k, v = _tiles(torch.float32, n_blocks=2)
    bad = json.loads(json.dumps(serialize_handoff(k, v, list(range(16)),
                                                  7)))
    mutate(bad)
    with pytest.raises(KVWireError):
        deserialize_handoff(bad)


# ------------------------------------------------------ engine handoffs

KNOBS = dict(num_slots=4, bucket_min=8, paged=True)


@pytest.fixture(scope="module")
def models():
    jm = jax_gpt(seed=11)
    return jm, torch_twin(jm)


def _port(models, role="monolithic", **kw):
    return ServingEngine(models[1], device="cpu", role=role,
                         **{**KNOBS, **kw})


def _empty(eng):
    eng.pool.check_conservation()
    return eng.pool.live_blocks == 0 and eng.pool.free_count == 4


PROMPTS = [list(range(1, 20)), list(range(3, 36)), [7] * 16]


@pytest.fixture(scope="module")
def jax_mono(models):
    outs = []
    for p in PROMPTS:
        eng = JaxEngine(models[0], **KNOBS)
        r = eng.add_request(np.asarray(p, np.int64), 6)
        eng.run()
        outs.append([int(t) for t in r.generated])
    return outs


def _prefill_export(eng, prompt):
    req = eng.add_request(np.asarray(prompt, np.int64), 1, hold_kv=True)
    eng.run()
    return eng.export_kv(req.rid)


@pytest.mark.parametrize("async_depth", [0, 1])
def test_handoff_within_the_port(models, jax_mono, async_depth):
    """prefill -> export -> JSON -> import -> decode equals the
    monolithic stream; both pools end empty and conserved."""
    pe = _port(models, "prefill", async_depth=async_depth)
    de = _port(models, "decode", async_depth=async_depth)
    de.warmup_kv_handoff()
    got = {}
    dreqs = []
    for p in PROMPTS:
        payload = json.loads(json.dumps(_prefill_export(pe, p)))
        assert _empty(pe)
        dreqs.append(de.import_kv(payload, 6, on_token=lambda r, t: got.
                                  setdefault(r.rid, []).append(int(t))))
    de.run()
    for d, ref in zip(dreqs, jax_mono):
        assert [int(t) for t in d.generated] == ref
        assert got[d.rid] == ref[1:]
    assert _empty(de)
    snap = (pe.metrics.snapshot()["kv_wire"],
            de.metrics.snapshot()["kv_wire"])
    assert snap[0]["exports"] == snap[1]["imports"] == 3
    assert snap[0]["export_bytes"] == snap[1]["import_bytes"] > 0


def test_export_reads_shared_prefix_blocks_in_place(models):
    eng = _port(models, "prefill")
    prompt = np.arange(1, 33)               # two full blocks: indexed
    r1 = eng.add_request(prompt, 1, hold_kv=True)
    eng.run()
    r2 = eng.add_request(prompt, 1, hold_kv=True)
    eng.run()
    pool = eng.pool
    assert any(c > 1 for c in pool._ref.values())
    blocks = pool._slot_blocks[r1.slot][:2]
    want_k, want_v = pool.kc[:, blocks].clone(), pool.vc[:, blocks].clone()
    h = deserialize_handoff(eng.export_kv(r1.rid))
    assert torch.equal(h.k[:, :2], want_k) and torch.equal(h.v[:, :2],
                                                           want_v)
    pool.check_conservation()
    eng.export_kv(r2.rid)
    with pytest.raises(KeyError):
        eng.export_kv(r2.rid)
    assert _empty(eng)


def test_corrupt_import_never_touches_the_pool(models):
    pe, de = _port(models, "prefill"), _port(models, "decode")
    payload = _prefill_export(pe, list(range(1, 18)))
    bad = json.loads(json.dumps(payload))
    bad["frames"][0]["digest"] ^= 0x2
    before = (de.pool.free_blocks, de.pool.free_count, de.pool.kc.clone(),
              de._toks.clone(), de._pos.clone())
    with pytest.raises(KVWireError):
        de.import_kv(bad, 4)
    assert (de.pool.free_blocks, de.pool.free_count) == before[:2]
    for t, b in zip((de.pool.kc, de._toks, de._pos), before[2:]):
        assert torch.equal(t, b)
    de.pool.check_conservation()
    dreq = de.import_kv(payload, 4)
    de.run()
    assert len(dreq.generated) == 4 and _empty(de)


def test_import_rejects_pool_mismatch_and_roles_need_paged(models):
    pe = _port(models, "prefill")
    payload = _prefill_export(pe, list(range(1, 10)))
    de = _port(models, "decode", block_size=8)
    with pytest.raises(KVWireError, match="block"):
        de.import_kv(payload, 4)
    de.pool.check_conservation()
    with pytest.raises(ValueError):
        _port(models, "decode", paged=False)
    slot = ServingEngine(models[1], device="cpu", num_slots=2, paged=False)
    with pytest.raises(ValueError):
        slot.add_request(np.arange(4), 2, hold_kv=True)
    for fn in (slot.export_kv, slot.warmup_kv_handoff):
        with pytest.raises(RuntimeError):
            fn(*([0] if fn == slot.export_kv else []))


def test_close_releases_held_exports(models):
    eng = _port(models, "prefill")
    eng.add_request(np.arange(1, 20), 1, hold_kv=True)
    eng.run()
    assert eng.pool.live_blocks > 0
    eng.close()
    assert _empty(eng)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_handoff_across_packages(models, jax_mono, direction):
    """A payload from one package's prefill engine resumes the JAX
    monolithic stream in the other package's decode engine."""
    jm = models[0]
    for p, ref in zip(PROMPTS, jax_mono):
        if direction == "jax_to_torch":
            pe = JaxEngine(jm, role="prefill", **KNOBS)
            req = pe.add_request(np.asarray(p, np.int64), 1, hold_kv=True)
            pe.run()
            payload = json.loads(json.dumps(pe.export_kv(req.rid)))
            de = _port(models, "decode")
        else:
            payload = json.loads(json.dumps(_prefill_export(
                _port(models, "prefill"), p)))
            de = JaxEngine(jm, role="decode", **KNOBS)
        d = de.import_kv(payload, 6)
        de.run()
        assert [int(t) for t in d.generated] == ref
        de.pool.check_conservation()
        assert de.pool.live_blocks == 0
