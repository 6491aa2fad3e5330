"""Decode-step roofline model: the analytic floor a decode dispatch
cannot beat, and the device tables to price it (a port of
``paddle_tpu/observability/perf/roofline.py``).

A decode step is memory-bound long before it is FLOP-bound: every step
re-reads the whole parameter set plus the K/V cache, so the HBM traffic
term — KV-read bytes per token as a function of batch, sequence length,
heads and layout — is the yardstick a paged attention kernel is judged
by. The engine's perf attribution (``snapshot()["perf"]``,
``/debug/perf``) prices its programs with it. Stdlib only.

Layouts (the three names are wire values: ``/debug/perf`` and the fleet
rollup carry them, and either package's poller reads the other's
replicas):

  * **contiguous** (SlotKVPool): attention reads the pooled
    ``[slots, heads, cache_len, head_dim]`` K/V directly — one read of
    the full fixed-shape cache per step;
  * **paged_xla** (PagedKVPool behind a block table, composed of plain
    tensor ops): the gather materializes a contiguous copy before
    attention reads it — pool read + copy write + attention read, ~3x
    the contiguous traffic. In the port this is the plain paged
    version, which the CPU runs;
  * **paged_pallas**: attention reads the blocks in place — gather
    factor 1.0, and no max-len over-read: the read stops at each slot's
    live length (callers pass ``live_kv_len``). In the port the name
    means the hand-written CUDA kernel K4 (``csrc/paged_decode.cu``),
    which the card runs; the reference's name is kept as the wire
    value.

Device tables are keyed by ``torch.cuda.get_device_name()`` and hold
data-sheet peaks. An unknown device (the CPU, a card the table does not
know) prices with ``None``: fractions then read None, never a borrowed
number. The reference falls back to another chip's figures there.
"""

# data-sheet dense bf16 tensor-core peak (FLOP/s) and HBM bandwidth
# (bytes/s) by device-name prefix (lower-cased): the H100 SXM5
_PEAK_FLOPS_BY_NAME = (
    ("nvidia h100 80gb hbm3", 989e12),
)
_HBM_BPS_BY_NAME = (
    ("nvidia h100 80gb hbm3", 3.35e12),
)

# paged attention composed of plain ops: gather reads the pool, writes a
# contiguous copy, attention reads the copy back (vs one direct read on
# the contiguous layout)
PAGED_GATHER_FACTOR = 3.0

# the decode K/V layouts the model prices; per-layout gather
# materialization factor on the KV-read term
LAYOUTS = ("contiguous", "paged_xla", "paged_pallas")
_GATHER_FACTORS = {
    "contiguous": 1.0,
    "paged_xla": PAGED_GATHER_FACTOR,
    "paged_pallas": 1.0,
}


def resolve_layout(paged=False, layout=None):
    """``layout`` when given, else the bool ``paged`` (True means
    ``"paged_xla"``)."""
    if layout is None:
        return "paged_xla" if paged else "contiguous"
    if layout not in _GATHER_FACTORS:
        raise ValueError(f"unknown KV layout {layout!r}; "
                         f"expected one of {LAYOUTS}")
    return layout


def _lookup(table, device_name):
    name = str(device_name).lower()
    for prefix, value in table:
        if name.startswith(prefix):
            return value
    return None


def peak_flops_for(device_name):
    """Dense bf16 peak FLOP/s of a card by its
    ``torch.cuda.get_device_name()``; None when unknown."""
    return _lookup(_PEAK_FLOPS_BY_NAME, device_name)


def hbm_bps_for(device_name):
    """HBM bandwidth (bytes/sec) of a card by its
    ``torch.cuda.get_device_name()``; None when unknown."""
    return _lookup(_HBM_BPS_BY_NAME, device_name)


def roofline_floor(flops, bytes_accessed, peak_flops, hbm_bps):
    """(floor_seconds, bound) — the time one dispatch cannot beat:
    max of the compute term and the memory term, with ``bound`` naming
    the binding resource ("flops" | "hbm"). Terms whose inputs are
    missing/zero drop out; (None, None) when nothing is computable."""
    t_flops = None
    if flops and peak_flops:
        t_flops = float(flops) / float(peak_flops)
    t_hbm = None
    if bytes_accessed and hbm_bps:
        t_hbm = float(bytes_accessed) / float(hbm_bps)
    if t_flops is None and t_hbm is None:
        return None, None
    if t_hbm is None or (t_flops is not None and t_flops >= t_hbm):
        return t_flops, "flops"
    return t_hbm, "hbm"


def kv_read_bytes_per_token(kv_len, num_layers, num_heads, head_dim,
                            kv_bytes=2, paged=False, layout=None):
    """HBM bytes attention reads to serve ONE decode token: K and V
    across every layer over ``kv_len`` positions, times the gather
    materialization factor on the composed paged layout (the in-place
    layout pays factor 1.0)."""
    base = 2.0 * num_layers * num_heads * head_dim * kv_len * kv_bytes
    return base * _GATHER_FACTORS[resolve_layout(paged, layout)]


def decode_step_model(batch, kv_len, num_layers, num_heads, head_dim,
                      n_params, param_bytes=2, kv_bytes=2, paged=False,
                      layout=None, live_kv_len=None,
                      peak_flops=None, hbm_bps=None):
    """Analytic cost of ONE pooled decode dispatch (``batch`` slots,
    one token each, attending over ``kv_len`` cached positions).

    On the ``paged_pallas`` layout the kernel stops reading at each
    slot's live length, so the KV-read term uses ``live_kv_len`` when
    given (the other layouts always read the fixed ``kv_len`` — the
    over-read is part of their price).

    Returns a JSON-safe dict: the traffic decomposition (KV read per
    token and total, KV append write, parameter read), matmul +
    attention FLOPs, arithmetic intensity, and — when peak_flops /
    hbm_bps are given — the roofline floor and its binding resource.
    """
    layout = resolve_layout(paged, layout)
    hidden = num_heads * head_dim
    kv_len_read = kv_len
    if layout == "paged_pallas" and live_kv_len is not None:
        kv_len_read = min(int(live_kv_len), int(kv_len))
    kv_tok = kv_read_bytes_per_token(kv_len_read, num_layers,
                                     num_heads, head_dim,
                                     kv_bytes=kv_bytes, layout=layout)
    kv_read = batch * kv_tok
    # one position appended per layer, K and V
    kv_write = batch * 2.0 * num_layers * num_heads * head_dim * kv_bytes
    param_read = float(n_params) * param_bytes
    bytes_total = kv_read + kv_write + param_read
    # dense matmuls touch every parameter twice per token; attention
    # is QK^T + AV, 2 * kv_len * hidden multiply-adds each, per layer
    flops = batch * (2.0 * n_params
                     + 4.0 * kv_len * hidden * num_layers)
    floor_s, bound = roofline_floor(flops, bytes_total, peak_flops,
                                    hbm_bps)
    return {
        "batch": int(batch),
        "kv_len": int(kv_len),
        "num_layers": int(num_layers),
        "num_heads": int(num_heads),
        "head_dim": int(head_dim),
        "n_params": int(n_params),
        # "paged" says whether the POOL is paged; "layout" names the
        # attention path actually priced
        "paged": layout != "contiguous",
        "layout": layout,
        "gather_factor": _GATHER_FACTORS[layout],
        "kv_len_read": int(kv_len_read),
        "kv_read_bytes_per_token": kv_tok,
        "kv_read_bytes": kv_read,
        "kv_write_bytes": kv_write,
        "param_read_bytes": param_read,
        "bytes_total": bytes_total,
        "flops": flops,
        "arithmetic_intensity": flops / bytes_total
        if bytes_total else None,
        "peak_flops": peak_flops,
        "hbm_bps": hbm_bps,
        "floor_s": floor_s,
        "floor_ms": round(floor_s * 1e3, 6)
        if floor_s is not None else None,
        "bound": bound,
    }


def program_cost(positions, n_params, num_layers, num_heads,
                 head_dim, param_bytes, kv_bytes, layout="paged_pallas",
                 kv_len=None):
    """The port's price of ONE dispatch from its shapes (the reference
    prices from XLA's ``cost_analysis``; the port compiles nothing).

    ``positions`` lists, per sequence the dispatch serves, ``(start,
    tokens)``: the cached positions it attends over before this call
    and the new tokens it computes. A decode is ``(len - 1, 1)`` per
    slot, a prefill ``(cached_prefix, tail)``, a speculative verify
    ``(len - 1, k + 1)`` per slot. Returns ``{"flops",
    "bytes_accessed"}``:

      * flops: ``2 * n_params`` per new token (every weight a
        multiply-add) plus attention, ``4 * hidden * layers`` per
        (query, key) pair: a new token at position ``p`` attends over
        ``p + 1`` keys;
      * bytes: the parameters read once, each new token's K/V written
        once, and the K/V the attention reads: ``start + tokens``
        positions a sequence in place (``paged_pallas``, K4 stops at the
        live length), the fixed ``kv_len`` a sequence on
        ``contiguous``, and that times the gather factor on
        ``paged_xla``.
    """
    hidden = num_heads * head_dim
    per_pos = 2.0 * num_layers * num_heads * head_dim * kv_bytes
    layout = resolve_layout(layout=layout)
    new = pairs = read = 0
    for start, tokens in positions:
        start, tokens = int(start), int(tokens)
        new += tokens
        # sum over p in [start, start + tokens) of (p + 1)
        pairs += tokens * start + tokens * (tokens + 1) // 2
        if layout == "paged_pallas" or kv_len is None:
            read += start + tokens
        else:
            read += int(kv_len)
    flops = 2.0 * n_params * new + 4.0 * hidden * num_layers * pairs
    bytes_accessed = (float(n_params) * param_bytes + per_pos * new
                      + per_pos * read * _GATHER_FACTORS[layout])
    return {"flops": flops, "bytes_accessed": bytes_accessed}
