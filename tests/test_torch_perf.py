"""paddle_tpu_torch's perf observatory against the JAX reference on the
CPU (tests/test_perf.py's scenarios): the decode-step model, the
roofline floor and KV-read bytes on the same inputs; program labels;
``ProgramPerf.report`` on the same recorded dispatches and costs; the
perf ledger's rows, digests, comparison, compaction and pruning; and
what the port adds, the per-dispatch prices from shapes
(``program_cost``), against hand arithmetic at the small test config
and inside a live engine.

Every comparison is exact (the functions are the same arithmetic on the
same floats), except wall-clock seconds, which only the live-engine
tests read, and only as containment checks. The reference prices with
another chip's figures when the device is unknown; the port does not,
so both packages are given the same explicit ``peak_flops`` and
``hbm_bps`` wherever they are compared.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.observability import perf as jperf
from paddle_tpu.serving import ServingEngine as JaxEngine

from _torch_port import jax_gpt, torch_twin
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.observability import perf as tperf
from paddle_tpu_torch.observability.perf.roofline import program_cost
from paddle_tpu_torch.serving import ServingEngine

PEAK, HBM = 5.0e11, 2.0e11


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------ roofline model

MODEL_CASES = [
    dict(batch=8, kv_len=1024, num_layers=12, num_heads=12, head_dim=64,
         n_params=124_000_000, param_bytes=4, kv_bytes=4),
    dict(batch=4, kv_len=64, num_layers=2, num_heads=4, head_dim=8,
         n_params=30_624, param_bytes=4, kv_bytes=4, paged=True),
    dict(batch=1, kv_len=2048, num_layers=24, num_heads=16, head_dim=64,
         n_params=350_000_000, param_bytes=2, kv_bytes=2,
         layout="paged_pallas", live_kv_len=700),
    dict(batch=16, kv_len=512, num_layers=12, num_heads=12, head_dim=64,
         n_params=124_000_000, layout="paged_xla", live_kv_len=100),
    dict(batch=2, kv_len=128, num_layers=2, num_heads=2, head_dim=32,
         n_params=10_000, layout="paged_pallas", live_kv_len=999),
    dict(batch=3, kv_len=96, num_layers=4, num_heads=8, head_dim=16,
         n_params=77_777, layout="contiguous"),
]


@pytest.mark.parametrize("priced", [False, True])
@pytest.mark.parametrize("case", range(len(MODEL_CASES)))
def test_decode_step_model_matches_reference(case, priced):
    kw = dict(MODEL_CASES[case])
    if priced:
        kw.update(peak_flops=PEAK, hbm_bps=HBM)
    assert tperf.decode_step_model(**kw) == jperf.decode_step_model(**kw)


FLOOR_CASES = [(1e9, 1e6, PEAK, HBM), (1e6, 1e9, PEAK, HBM),
               (0, 1e9, PEAK, HBM), (1e9, 0, PEAK, HBM),
               (1e9, 1e9, None, HBM), (1e9, 1e9, PEAK, None),
               (None, None, PEAK, HBM), (2.5e11, 1e11, PEAK, HBM)]


@pytest.mark.parametrize("case", FLOOR_CASES)
def test_roofline_floor_matches_reference(case):
    assert tperf.roofline_floor(*case) == jperf.roofline_floor(*case)


@pytest.mark.parametrize("layout", ["contiguous", "paged_xla",
                                    "paged_pallas", None])
def test_kv_read_bytes_matches_reference(layout):
    for kv_len in (1, 17, 1024):
        args = (kv_len, 12, 12, 64)
        for paged in (False, True):
            assert tperf.kv_read_bytes_per_token(
                *args, kv_bytes=4, paged=paged, layout=layout) == \
                jperf.kv_read_bytes_per_token(
                    *args, kv_bytes=4, paged=paged, layout=layout)


@pytest.mark.parametrize("key", [("decode",), ("prefill", 16, 4),
                                 ("paged_prefill", 32), ("chunk_prefill", 8),
                                 ("paged_spec_verify",), ("kv_import",),
                                 "decode", ("x", 1, 2, 3)])
def test_format_program_key_matches_reference(key):
    assert tperf.format_program_key(key) == jperf.format_program_key(key)


def test_schema_keys_are_the_references():
    for name in ("PERF_KEYS", "PERF_PROGRAM_KEYS", "PERF_SPEC_KEYS"):
        assert getattr(tperf, name) == getattr(jperf, name), name
    assert tperf.disabled_perf_report() == jperf.disabled_perf_report()
    assert tperf.disabled_spec_report() == jperf.disabled_spec_report()
    assert tperf.LAYOUTS == ("contiguous", "paged_xla", "paged_pallas")


def test_device_tables_hold_no_borrowed_number():
    """The H100's data-sheet figures by device name; None elsewhere."""
    assert tperf.peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12
    assert tperf.hbm_bps_for("NVIDIA H100 80GB HBM3") == 3.35e12
    for name in ("cpu", "TPU v5 lite", "NVIDIA A100-SXM4-80GB", ""):
        assert tperf.peak_flops_for(name) is None
        assert tperf.hbm_bps_for(name) is None
    p = tperf.ProgramPerf(MetricsRegistry())
    p.set_device("cpu", "cpu")
    p.record_dispatch(("decode",), 0.01)
    p.bind_cost(("decode",), {"flops": 1e9, "bytes_accessed": 1e8})
    rep = p.report()
    assert rep["device"]["device_peak"] is False
    assert rep["device"]["peak_flops"] is None
    prog = rep["programs"]["decode"]
    assert prog["roofline_fraction"] is None
    assert prog["roofline_floor_ms"] is None


def _record(perf, seed):
    rs = np.random.RandomState(seed)
    keys = [("decode",), ("prefill", 16, 2), ("paged_prefill", 8),
            ("chunk_prefill", 12), ("paged_spec_verify",)]
    for _ in range(40):
        key = keys[rs.randint(len(keys))]
        perf.record_dispatch(key, float(rs.rand()) * 1e-3)
        if rs.rand() < 0.8:
            perf.record_sync(key, float(rs.rand()) * 1e-3)
    for i, key in enumerate(keys[:3]):
        perf.bind_cost(key, {"flops": 1e6 * (i + 1) * (seed + 1),
                             "bytes_accessed": 3e6 * (i + 2)})


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_program_perf_report_matches_reference(seed):
    """The same dispatches, syncs and costs on the same device figures:
    the same report, gauge values and prefill seconds."""
    from paddle_tpu.observability import MetricsRegistry as JReg
    reports = []
    for mod, reg in ((tperf, MetricsRegistry()), (jperf, JReg())):
        p = mod.ProgramPerf(reg)
        p.set_device("gpu", "card", peak_flops=PEAK, hbm_bps=HBM)
        p.set_decode_model(mod.build_decode_model(
            batch=4, kv_len=64, num_layers=2, num_heads=4, head_dim=8,
            n_params=30624, param_bytes=4, kv_bytes=4, paged=True,
            peak_flops=PEAK, hbm_bps=HBM, layout="paged_pallas"))
        _record(p, seed)
        fam = reg.snapshot()["serving_roofline_fraction"]["values"]
        reports.append((p.report(step_total_s=0.5), fam,
                        p.prefill_seconds()))
    assert reports[0] == reports[1]
    assert reports[0][0]["programs"]["decode"]["roofline_fraction"] > 0


def test_accrued_costs_are_the_mean_price():
    """The port's per-dispatch pricing: ``cost`` is the mean of the
    priced dispatches, and the fraction is its floor over the measured
    mean wall, as ``bind_cost`` of that mean would give."""
    p = tperf.ProgramPerf(MetricsRegistry())
    p.set_device("gpu", "card", peak_flops=PEAK, hbm_bps=HBM)
    q = tperf.ProgramPerf(MetricsRegistry())
    q.set_device("gpu", "card", peak_flops=PEAK, hbm_bps=HBM)
    prices = [(1e6, 4e6), (3e6, 8e6), (2e6, 9e6)]
    for f, b in prices:
        p.record_dispatch(("decode",), 2e-4)
        p.accrue_cost(("decode",), f, b)
        q.record_dispatch(("decode",), 2e-4)
    q.bind_cost(("decode",), {"flops": 2e6, "bytes_accessed": 7e6})
    a, b = p.report()["programs"]["decode"], q.report()["programs"]["decode"]
    assert a == b
    assert a["cost"] == {"flops": 2e6, "bytes_accessed": 7e6}
    assert a["roofline_floor_ms"] == pytest.approx(7e6 / HBM * 1e3)


# -------------------------------------------------- prices from shapes

# the small test config: TINY's widths, f32 weights and cache
TINY_DIMS = dict(n_params=30624, num_layers=2, num_heads=4, head_dim=8,
                 param_bytes=4, kv_bytes=4)
HIDDEN, LAYERS = 32, 2
PER_POS = 2 * 2 * 4 * 8 * 4     # K and V, layers, heads, head_dim, f32


@pytest.mark.parametrize("kind,positions,layout,kv_len", [
    ("decode", [(9, 1)], "paged_pallas", None),
    ("decode", [(9, 1), (20, 1), (0, 1)], "paged_pallas", None),
    ("paged_prefill", [(16, 5)], "paged_pallas", None),
    ("prefill", [(0, 7), (0, 12)], "contiguous", 64),
    ("verify", [(10, 5), (31, 5)], "paged_pallas", None),
    ("decode", [(9, 1), (20, 1)], "paged_xla", 64),
    ("decode", [(9, 1)], "contiguous", 64),
])
def test_program_cost_against_hand_arithmetic(kind, positions, layout,
                                              kv_len):
    """FLOPs: 2 n_params a new token plus 4 hidden layers a (query, key)
    pair; bytes: the parameters once, each new token's K/V written, and
    the K/V read: ``start + tokens`` positions in place, the fixed
    ``kv_len`` on the contiguous layout, three times that through the
    composed gather."""
    new = sum(t for _, t in positions)
    pairs = sum(sum(s + i + 1 for i in range(t)) for s, t in positions)
    if layout == "paged_pallas":
        read = sum(s + t for s, t in positions)
    else:
        read = kv_len * len(positions)
    factor = 3.0 if layout == "paged_xla" else 1.0
    want_flops = 2 * 30624 * new + 4 * HIDDEN * LAYERS * pairs
    want_bytes = 30624 * 4 + PER_POS * new + PER_POS * read * factor
    got = program_cost(positions, layout=layout, kv_len=kv_len,
                       **TINY_DIMS)
    assert got == {"flops": float(want_flops),
                   "bytes_accessed": float(want_bytes)}


@pytest.mark.parametrize("live", [1, 9, 33, 64])
def test_decode_price_equals_the_decode_model_at_live_length(live):
    """One slot's decode priced from its shapes is
    ``decode_step_model`` of the in-place layout at that live length."""
    got = program_cost([(live - 1, 1)], layout="paged_pallas", **TINY_DIMS)
    model = tperf.decode_step_model(
        batch=1, kv_len=live, live_kv_len=live, layout="paged_pallas",
        **TINY_DIMS)
    assert got["bytes_accessed"] == model["bytes_total"]
    assert got["flops"] == model["flops"]


# ------------------------------------------------------- live engines

@pytest.fixture(scope="module")
def models():
    jm = jax_gpt()
    return jm, torch_twin(jm)


def _wave(eng, seed):
    rs = np.random.RandomState(seed)
    reqs = [eng.add_request(rs.randint(0, 97, (n,)).astype(np.int64), k)
            for n, k in ((5, 6), (9, 5), (20, 4), (6, 5))]
    eng.run()
    return reqs


@pytest.mark.parametrize("paged", [False, True])
def test_engine_programs_and_dispatches_match_reference(models, paged):
    """The same traffic on both engines: the same program labels with
    the same dispatch and sync counts, the report's key sets, the
    attributed seconds inside the step total, and the layout priced."""
    jm, tm = models
    kw = dict(num_slots=2, bucket_min=8, prefill_chunk=12, paged=paged)
    ours = ServingEngine(tm, device="cpu", peak_flops=PEAK, **kw)
    ref = JaxEngine(jm, peak_flops=PEAK, **kw)
    _wave(ours, 0)
    _wave(ref, 0)
    a, b = ours.metrics.perf_report(), ref.metrics.perf_report()
    assert set(a) == set(b) == set(tperf.PERF_KEYS)
    assert set(a["spec"]) == set(tperf.PERF_SPEC_KEYS)
    assert {k: (v["dispatches"], v["syncs"]) for k, v in
            a["programs"].items()} == \
        {k: (v["dispatches"], v["syncs"]) for k, v in b["programs"].items()}
    for prog in a["programs"].values():
        assert set(prog) == set(tperf.PERF_PROGRAM_KEYS)
        assert prog["cost"]["flops"] > 0 and prog["bound"] == "flops"
        assert 0 < prog["roofline_fraction"]
    assert 0 < a["attributed_s"] <= a["step_total_s"]
    model = a["decode_roofline"]["model"]
    assert model["layout"] == ("paged_xla" if paged else "contiguous")
    assert ours.decode_layout == model["layout"]
    assert a["device"]["device_hbm"] is False
    snap = ours.metrics.snapshot()
    assert set(snap["perf"]) == set(ref.metrics.snapshot()["perf"])
    ours.close()
    ref.close()


def test_engine_decode_prices_follow_live_lengths(models):
    """The decode program's cost is the mean of its dispatches' prices,
    each slot at its live length: reckoned here from the requests."""
    _, tm = models
    eng = ServingEngine(tm, device="cpu", num_slots=4, bucket_min=8,
                        peak_flops=PEAK)
    rs = np.random.RandomState(3)
    lens, new = [5, 9, 12, 7], 6
    for n in lens:
        eng.add_request(rs.randint(0, 97, (n,)).astype(np.int64), new)
    eng.run()
    # every request rides decodes at cached lengths P .. P + new - 2
    # (max-token stops are known at dispatch: no masked extra step)
    steps = eng.metrics.decode_steps
    flops = bytes_ = 0.0
    for n in lens:
        for base in range(n, n + new - 1):
            c = program_cost([(base, 1)], layout="paged_xla", kv_len=64,
                             **TINY_DIMS)
            flops += c["flops"]
            # the parameters are read once a dispatch, not a slot
            bytes_ += c["bytes_accessed"] - 30624 * 4
    want_bytes = bytes_ / steps + 30624 * 4
    cost = eng.metrics.perf_report()["programs"]["decode"]["cost"]
    assert cost["bytes_accessed"] == pytest.approx(want_bytes, rel=1e-12)
    assert cost["flops"] == pytest.approx(flops / steps, rel=1e-12)
    mfu = eng.metrics.estimated_mfu()
    assert 0 < mfu < 1
    reg = eng.metrics.registry.snapshot()
    assert reg["serving_decode_flops_per_step"]["values"][""] == \
        pytest.approx(cost["flops"])
    eng.close()


def test_engine_perf_off_pays_nothing_and_keeps_the_shape(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8,
                        perf=False)
    _wave(eng, 1)
    rep = eng.metrics.perf_report()
    assert rep["enabled"] is False and rep["programs"] == {}
    assert set(rep) == set(tperf.PERF_KEYS)
    assert eng.metrics.estimated_mfu() == 0.0
    assert "serving_program_dispatch_seconds" not in \
        eng.metrics.registry.snapshot()
    eng.close()


def test_engine_without_peak_reads_none(models):
    """On the CPU with no ``peak_flops``: fractions None, MFU 0, no HBM
    gauges."""
    _, tm = models
    eng = ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8)
    _wave(eng, 2)
    rep = eng.metrics.perf_report()
    assert rep["device"]["device_peak"] is False
    assert all(p["roofline_fraction"] is None
               for p in rep["programs"].values())
    assert eng.metrics.estimated_mfu() == 0.0
    assert "serving_hbm_bytes_in_use" not in eng.metrics.registry.snapshot()
    eng.close()


# ------------------------------------------------------- perf ledger

def _rows(mod, seed):
    rs = np.random.RandomState(seed)
    rows = []
    for i in range(12):
        scenario = ("serve", "train")[rs.randint(2)]
        metric, direction = (("tps", "higher_better"),
                             ("ms", "lower_better"))[rs.randint(2)]
        rows.append(mod.make_row(
            timestamp=f"t{i}", run_id=f"run{i}", source="test",
            scenario=scenario, metric=metric,
            value=float(100 + rs.randn() * (40 if i == 11 else 5)),
            unit="x", direction=direction,
            config_digest=mod.config_digest({"cfg": int(rs.randint(2))}),
            device="cpu", rel_threshold=0.2 if rs.rand() < 0.5 else None))
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ledger_rows_and_compare_match_reference(seed):
    ours, ref = _rows(tperf, seed), _rows(jperf, seed)
    assert ours == ref
    assert tperf.compare(ours) == jperf.compare(ref)
    assert tperf.PERF_LEDGER_SCHEMA == jperf.PERF_LEDGER_SCHEMA
    assert tperf.LEDGER_ROW_KEYS == jperf.LEDGER_ROW_KEYS


def test_ledger_validation_matches_reference():
    for mod in (tperf, jperf):
        for bad in (dict(value=float("nan")), dict(direction="sideways"),
                    dict(scenario=""), dict(measurement="vibes")):
            kw = dict(timestamp="t0", run_id="r", source="s", scenario="s",
                      metric="m", value=1.0, unit="x",
                      direction="higher_better", config_digest="c",
                      device="cpu")
            kw.update(bad)
            with pytest.raises(ValueError):
                mod.make_row(**kw)


@pytest.mark.parametrize("op", ["compact", "prune"])
def test_ledger_files_match_reference(tmp_path, op):
    """append, junk, then compaction or pruning: the same file and the
    same counts from both packages."""
    out = []
    for mod in (tperf, jperf):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        mod.append_rows(path, _rows(mod, 5))
        with open(path, "a") as fh:
            fh.write("junk\n")
        if op == "compact":
            counts = mod.compact(path, keep_last=2)
        else:
            counts = mod.prune(path, run_ids=["run3"],
                               series=["serve/tps"])
        out.append((counts, mod.read_rows(path)))
    assert out[0] == out[1]
