"""Performance observatory: per-program device-time attribution,
roofline-anchored efficiency, and the cross-run perf ledger (a port of
``paddle_tpu/observability/perf``).

  * **attribution.ProgramPerf** — every serving dispatch (prefill
    buckets, chunk program, pooled decode, speculative verify) records
    measured dispatch/sync wall seconds against its program key into
    registry histograms; ``snapshot()["perf"]`` and ``/debug/perf``
    decompose a step into named programs;
  * **roofline** — the analytic decode-step HBM/FLOPs model, the
    port's per-dispatch prices from shapes (``program_cost``) and the
    card's data-sheet peak and bandwidth by device name; joined with the
    measured wall it yields ``serving_roofline_fraction{program}``;
  * **ledger** — the schema-versioned cross-run JSONL perf ledger and
    its robust median+MAD comparison.

All three are stdlib only.
"""
from .attribution import (  # noqa: F401
    PERF_KEYS, PERF_PROGRAM_KEYS, PERF_SPEC_KEYS, ProgramPerf,
    build_decode_model, disabled_perf_report, disabled_spec_report,
    format_program_key,
)
from .ledger import (  # noqa: F401
    LEDGER_ROW_KEYS, MEASUREMENTS, PERF_LEDGER_SCHEMA, append_rows,
    compact, compare, config_digest, make_row, prune, read_rows,
)
from .roofline import (  # noqa: F401
    LAYOUTS, PAGED_GATHER_FACTOR, decode_step_model, hbm_bps_for,
    kv_read_bytes_per_token, peak_flops_for, program_cost,
    roofline_floor,
)
