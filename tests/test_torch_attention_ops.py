"""paddle_tpu_torch attention ops against the JAX reference on the CPU:
the plain version of the flash-attention forward kernel (K1) against the
Pallas kernel in interpret mode and against the XLA composition, the
decode compositions, and the plain version of the paged decode kernel
(K4) against the Pallas kernel in interpret mode. Tolerance: atol and
rtol 1e-5 in f32 (the same f32 math, summed in another order); 2e-2 for
bf16 inputs (the outputs are rounded to bf16)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops import attention as jattn
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops import paged_attention as tpa

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def interpret_flash():
    jattn._FORCE_INTERPRET[0] = True
    yield
    jattn._FORCE_INTERPRET[0] = False


@pytest.fixture
def interpret_kernel():
    jpa._FORCE_INTERPRET[0] = True
    yield
    jpa._FORCE_INTERPRET[0] = False


def _qkv(seed, shape):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_interpret(interpret_flash, causal):
    """O and LSE of the port's plain K1 equal the Pallas forward kernel
    run in interpret mode, at [2, 4, 256, 32]."""
    q, k, v = _qkv(0, (2, 4, 256, 32))
    scale = 1.0 / np.sqrt(32)
    jo, jlse = jattn._pallas_flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), scale, causal)
    to, tlse = tattn.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale, causal)
    assert tuple(tlse.shape) == (2, 4, 1, 256)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [256, 512])
def test_flash_plain_bf16_p_matches_pallas_interpret(interpret_flash, causal,
                                                     s):
    """bf16 inputs: the plain K1 with P rounded to bf16 (``p_dtype``, over
    the bf16 kernel's 64-key tiles) against the Pallas forward in
    interpret mode (256- or 512-key blocks). Tolerance 1e-2, absolute and
    relative: both round O to bf16 once (2^-8 of |O|), and a P element
    rounded against another block's max, an exp or a sum in another order
    can round P, or O, the other way (2^-8 of that element). P kept in f32
    is held at the bf16 tolerance, 2e-2. LSE is f32 on both sides: 1e-5."""
    rs = np.random.RandomState(3)
    q, k, v = (rs.randn(1, 2, s, 64).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(64)
    jo, jlse = jattn._pallas_flash_fwd(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale, causal)
    jo = np.asarray(jo, np.float32)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    for p_dtype, tol in ((torch.bfloat16, 1e-2), (None, 2e-2)):
        to, tlse = tattn.flash_attention_plain(tq, tk, tv, scale, causal,
                                               p_dtype=p_dtype)
        assert to.dtype == torch.bfloat16
        np.testing.assert_allclose(to.float().numpy(), jo, atol=tol,
                                   rtol=tol)
        np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 64, 200])
def test_flash_plain_online_loop_keeps_f32_result(causal, s):
    """The online loop of the rounded-P variant, run with P kept in f32
    (``p_dtype=torch.float32``), equals the one-pass f32 plain version
    at [1, 2, s, 64], ragged s included: only the rounding of P differs
    between the variants. 1e-5."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, (1, 2, s, 64)))
    ref_o, ref_lse = tattn.flash_attention_plain(q, k, v, 0.125, causal)
    o, lse = tattn.flash_attention_plain(q, k, v, 0.125, causal,
                                         p_dtype=torch.float32)
    np.testing.assert_allclose(o.numpy(), ref_o.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 4, 256, 32), (1, 2, 37, 16)])
def test_flash_plain_matches_reference_attention(causal, shape):
    q, k, v = _qkv(1, shape)
    scale = 1.0 / np.sqrt(shape[-1])
    ref = jattn._reference_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), None, scale, causal)
    out, _ = tattn.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the model's entry point takes the same path on CPU tensors
    sdpa = tattn.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=causal)
    np.testing.assert_allclose(sdpa.numpy(), np.asarray(ref), **TOL)


def test_reference_attention_with_mask_matches():
    q, k, v = _qkv(2, (1, 2, 12, 8))
    mask = np.random.RandomState(3).randn(1, 1, 12, 12).astype(np.float32)
    ref = jattn._reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        1.0 / np.sqrt(8), True)
    out = tattn.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=torch.from_numpy(mask), is_causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _paged_case(seed, S, nh, hd, BS, MB, lengths=None, trash_fill=0.0):
    """The reference suite's pool fixture: block 0 is trash (filled with
    ``trash_fill``), slot s owns blocks 1 + s*MB .. for its live prefix,
    padding entries point at trash."""
    rs = np.random.RandomState(seed)
    NB = S * MB + 1
    kc = rs.randn(NB, nh, BS, hd).astype(np.float32)
    vc = rs.randn(NB, nh, BS, hd).astype(np.float32)
    kc[0] = trash_fill
    vc[0] = trash_fill
    q = rs.randn(S, nh, hd).astype(np.float32)
    if lengths is None:
        lengths = rs.randint(1, MB * BS + 1, S)
    lengths = np.asarray(lengths, np.int32)
    tables = np.zeros((S, MB), np.int32)
    for s in range(S):
        used = (int(lengths[s]) + BS - 1) // BS
        tables[s, :used] = 1 + s * MB + np.arange(used)
    return q, kc, vc, tables, lengths


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("S,nh,hd,BS,MB", [
    (4, 4, 8, 8, 4),
    (3, 2, 16, 4, 5),
    (2, 4, 8, 16, 2),
    (5, 1, 32, 8, 3),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_pallas_interpret(interpret_kernel, S, nh, hd,
                                              BS, MB, dtype):
    """Ragged lengths with mid-block tails and trash-padded tables: the
    port's plain K4 equals the Pallas kernel, and the argmax over hd is
    identical."""
    lengths = [1, BS, BS + 1, MB * BS, max(1, MB * BS - 3)][:S]
    q, kc, vc, tables, lens = _paged_case(7, S, nh, hd, BS, MB,
                                          lengths=lengths, trash_fill=1e4)
    jdt = jnp.dtype(dtype)
    ref = jpa.paged_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
        jnp.asarray(tables), jnp.asarray(lens))
    tdt = getattr(torch, dtype)
    tq, tkc, tvc, tt, tl = _t(q, kc, vc, tables, lens)
    out = tpa.paged_decode_attention(tq.to(tdt), tkc.to(tdt), tvc.to(tdt),
                                     tt, tl)
    assert out.dtype == tdt and tuple(out.shape) == (S, nh, hd)
    out32 = out.float().numpy()
    ref32 = np.asarray(ref, np.float32)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out32, ref32, atol=tol, rtol=tol)
    if dtype == "float32":
        np.testing.assert_array_equal(out32.argmax(-1), ref32.argmax(-1))


def test_paged_plain_ignores_trash_and_recycled_rows(interpret_kernel):
    """Trash block and every row past a slot's length filled with huge
    garbage: the output equals the clean pool's and the Pallas kernel's
    (a recycled slot is bit-identical to a fresh one)."""
    S, nh, hd, BS, MB = 3, 2, 8, 4, 3
    q, kc, vc, tables, lens = _paged_case(
        11, S, nh, hd, BS, MB, lengths=[3, 5, BS * MB], trash_fill=1e4)
    clean_k, clean_v = kc.copy(), vc.copy()
    clean_k[0] = clean_v[0] = 0.0
    for s in range(S):
        for col in range(MB):
            b = tables[s, col]
            for off in range(BS):
                if b and col * BS + off >= lens[s]:
                    kc[b, :, off] = vc[b, :, off] = 1e4
                    clean_k[b, :, off] = clean_v[b, :, off] = 0.0
    poisoned = tpa.paged_decode_plain(*_t(q, kc, vc, tables, lens))
    clean = tpa.paged_decode_plain(*_t(q, clean_k, clean_v, tables, lens))
    np.testing.assert_array_equal(poisoned.numpy(), clean.numpy())
    ref = jpa.paged_decode_attention(*map(jnp.asarray,
                                          (q, kc, vc, tables, lens)))
    np.testing.assert_allclose(poisoned.numpy(), np.asarray(ref), **TOL)


def test_length_past_table_clamps_like_reference(interpret_kernel):
    """A parked slot's length grows past MB*BS; both sides attend over
    the whole row."""
    S, nh, hd, BS, MB = 2, 2, 8, 4, 3
    q, kc, vc, tables, _ = _paged_case(5, S, nh, hd, BS, MB,
                                       lengths=[MB * BS, MB * BS])
    lens = np.array([MB * BS + 5, MB * BS + 40], np.int32)
    ref = jpa.paged_decode_attention(*map(jnp.asarray,
                                          (q, kc, vc, tables, lens)))
    out = tpa.paged_decode_attention(*_t(q, kc, vc, tables, lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_cached_compositions_match_reference():
    """cached_slot_attention and cached_paged_attention equal the
    reference's compositions, and the paged one equals the slot one over
    the same rows laid out contiguously."""
    S, nh, hd, BS, MB = 3, 2, 8, 4, 4
    q, kc, vc, tables, lens = _paged_case(4, S, nh, hd, BS, MB,
                                          lengths=[3, 9, 16],
                                          trash_fill=10.0)
    jref = jattn.cached_paged_attention(*map(jnp.asarray,
                                             (q, kc, vc, tables, lens)))
    tout = tattn.cached_paged_attention(*_t(q, kc, vc, tables, lens))
    assert tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jref), **TOL)
    kslot = kc[tables].transpose(0, 2, 1, 3, 4).reshape(S, nh, MB * BS, hd)
    vslot = vc[tables].transpose(0, 2, 1, 3, 4).reshape(S, nh, MB * BS, hd)
    jslot = jattn.cached_slot_attention(*map(jnp.asarray,
                                             (q, kslot, vslot, lens)))
    tslot = tattn.cached_slot_attention(*_t(q, kslot, vslot, lens))
    np.testing.assert_allclose(tslot.numpy(), np.asarray(jslot), **TOL)
    np.testing.assert_array_equal(tslot.numpy(), tout.numpy())


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors the kernel wrappers compute the plain versions and
    count no launch."""
    q, kc, vc, tables, lens = _paged_case(9, 2, 2, 8, 4, 3)
    n4 = tpa.paged_decode_attention.launches
    out = tpa.paged_decode_attention(*_t(q, kc, vc, tables, lens))
    np.testing.assert_array_equal(
        out.numpy(), tpa.paged_decode_plain(*_t(q, kc, vc, tables,
                                                lens)).numpy())
    fq, fk, fv = (torch.from_numpy(a) for a in _qkv(5, (1, 2, 20, 64)))
    n1 = tattn.flash_attention_forward.launches
    o, lse = tattn.flash_attention_forward(fq, fk, fv, 0.125, True)
    ro, rlse = tattn.flash_attention_plain(fq, fk, fv, 0.125, True)
    np.testing.assert_array_equal(o.numpy(), ro.numpy())
    np.testing.assert_array_equal(lse.numpy(), rlse.numpy())
    assert tpa.paged_decode_attention.launches == n4
    assert tattn.flash_attention_forward.launches == n1


@pytest.mark.parametrize("BS,MB,hd,itemsize,want", [
    (16, 64, 64, 4, (4, 16)),    # the engine's f32 pool: 64-row chunks
    (16, 64, 64, 2, (8, 8)),     # bf16: 128-row chunks, the same bytes
    (16, 1, 64, 4, (1, 1)),      # MB = 1: one chunk of the one page
    (256, 8, 64, 4, (1, 8)),     # pages larger than a chunk: one a chunk
    (16, 6, 32, 4, (6, 1)),      # fewer pages than a chunk holds
    (8, 5, 128, 4, (4, 2)),      # the last chunk has one page of four
    (16, 0, 64, 4, (1, 0)),      # no table columns: no chunk
])
def test_decode_chunks_plan(BS, MB, hd, itemsize, want):
    """K4's chunking, fixed by the static shapes: whole pages a chunk (at
    least one, at most MB) and enough chunks to cover MB pages."""
    pages, chunks = tpa.decode_chunks(BS, MB, hd, itemsize)
    assert (pages, chunks) == want
    assert pages * chunks >= MB and (chunks - 1) * pages < max(MB, 1)


def _split_decode(q, kc, vc, tables, lens):
    """K4's arithmetic on the CPU: each slot's rows clamped to MB*BS, cut
    into the chunks of ``decode_chunks``, one (m, l, acc) a live chunk in
    log2 units, merged in chunk order; acc / max(l, 1e-37)."""
    S, nh, hd = q.shape
    BS, MB = kc.shape[2], tables.shape[1]
    pages, chunks = tpa.decode_chunks(BS, MB, hd, q.element_size())
    cr = pages * BS
    k = kc[tables.long()].permute(0, 2, 1, 3, 4).reshape(S, nh, -1, hd)
    v = vc[tables.long()].permute(0, 2, 1, 3, 4).reshape(S, nh, -1, hd)
    sc = torch.einsum("shd,shkd->shk", q, k) * (np.log2(np.e) / hd ** 0.5)
    out = torch.zeros(S, nh, hd)
    for s in range(S):
        n = min(max(int(lens[s]), 0), MB * BS)
        parts = []
        for c in range(chunks):
            if c * cr >= n:
                break
            rows = slice(c * cr, min(c * cr + cr, n))
            m = sc[s, :, rows].amax(-1)
            p = torch.exp2(sc[s, :, rows] - m[:, None])
            parts.append((m, p.sum(-1), torch.einsum("hk,hkd->hd", p,
                                                     v[s, :, rows])))
        mx = torch.full((nh,), -1e30)
        for m, _, _ in parts:
            mx = torch.maximum(mx, m)
        lsum, acc = torch.zeros(nh), torch.zeros(nh, hd)
        for m, l, a in parts:
            f = torch.exp2(m - mx)
            lsum, acc = lsum + l * f, acc + a * f[:, None]
        out[s] = acc / lsum.clamp_min(1e-37)[:, None]
    return out


@pytest.mark.parametrize("S,BS,MB,lengths", [
    (1, 16, 1, [9]),                              # S = 1, MB = 1
    (4, 16, 8, [0, 64, 65, 200]),                 # a length 0; past MB*BS
    (5, 8, 20, [63, 64, 1, 160, -2]),             # chunk edges; a 1-row slot
    (3, 256, 2, [300, 512, 700]),                 # one page a chunk
])
def test_split_decode_merge_matches_plain(S, BS, MB, lengths):
    """The split K4 computes: chunks of ``decode_chunks`` merged in chunk
    order give the plain version's output on every slot with a length >
    0 (within 1e-5), and zeros on a slot with a length <= 0."""
    nh, hd = 3, 32
    q, kc, vc, tables, lens = _paged_case(
        11, S, nh, hd, BS, MB, lengths=np.minimum(lengths, MB * BS),
        trash_fill=1e4)
    lens = np.asarray(lengths, np.int32)
    tq, tkc, tvc, ttab, tlen = _t(q, kc, vc, tables, lens)
    got = _split_decode(tq, tkc, tvc, ttab, tlen)
    ref = tpa.paged_decode_plain(tq, tkc, tvc, ttab, tlen)
    live = lens > 0
    np.testing.assert_allclose(got.numpy()[live], ref.numpy()[live], **TOL)
    assert not got.numpy()[~live].any()
