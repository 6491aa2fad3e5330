"""paddle_tpu_torch's CUDA kernels on the card, against their plain
PyTorch versions on the same inputs. Marked ``cuda``: without a CUDA
device every test skips. On a machine with a card and no JAX, run them
without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: 1e-5 (K4) and 2e-5 (K1) in f32, where only the summation
order differs (K4 merges its chunks, K1 its key slices, in a fixed order,
so two runs give the same bits); 2e-2 for bf16 inputs, whose outputs are rounded to bf16
(1e-2 for the bf16 K1 against the plain version that rounds P as it does).
K2/K3 grads are held relative to the largest grad, or to 1 where that
is smaller (dK and dV sum over up to 1000 query rows): 1e-4 in f32, 2e-2
in bf16 (5e-3 for the bf16 K2/K3 against the plain version that rounds P
and dS as they do). K5-K7: the loss and LSE are f32 on both sides (atol 1e-4), the
grads relative to the largest grad (1e-4 in f32, 1e-2 in bf16).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import attention as attn
from paddle_tpu_torch.ops import fused_ce as tce
from paddle_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged(dev, S, nh, hd, BS, MB, lengths, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    NB = S * MB + 1
    kc = torch.randn(NB, nh, BS, hd, generator=g)
    vc = torch.randn(NB, nh, BS, hd, generator=g)
    kc[0] = vc[0] = 1e4
    q = torch.randn(S, nh, hd, generator=g)
    tables = torch.zeros(S, MB, dtype=torch.int32)
    for s, n in enumerate(lengths):
        used = min(-(-max(n, 0) // BS), MB)
        tables[s, :used] = 1 + s * MB + torch.arange(used)
    lens = torch.tensor(lengths, dtype=torch.int32)
    return [t.to(dev) if not t.is_floating_point() else t.to(dev, dtype)
            for t in (q, kc, vc, tables, lens)]


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_paged_kernel_matches_plain(dev, hd, dtype, tol):
    args = _paged(dev, 5, 3, hd, 16, 6, [1, 16, 17, 96, 130], dtype)
    before = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(*args)
    assert pa.paged_decode_attention.launches == before + 1
    ref = pa.paged_decode_plain(*(a.float() if a.is_floating_point() else a
                                  for a in args))
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)


def test_paged_kernel_zero_length_is_finite(dev):
    out = pa.paged_decode_attention(*_paged(dev, 2, 2, 64, 8, 3, [0, -1],
                                            torch.float32))
    assert torch.isfinite(out).all() and not out.abs().any()


def test_paged_kernel_rejects_what_it_cannot_take(dev):
    q, kc, vc, tables, lens = _paged(dev, 2, 2, 64, 8, 3, [3, 9],
                                     torch.float32)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q.half(), kc.half(), vc.half(), tables,
                                  lens)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q, kc, vc, tables.long(), lens)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, kc, vc, tables, lens.cpu())
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q[:, :, :48].contiguous(),
                                  kc[..., :48].contiguous(),
                                  vc[..., :48].contiguous(), tables, lens)


def _chunk_rows(q, kc, tables):
    pages, _ = pa.decode_chunks(kc.shape[2], tables.shape[1], q.shape[-1],
                                q.element_size())
    return pages * kc.shape[2]


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_split_paged_kernel_at_chunk_edges(dev, hd, dtype, tol):
    """The split K4 at lengths that end one row before, on and one row
    past a chunk boundary, a 1-row slot among long ones, every other slot
    at MB*BS and one past it, against the plain version; a second run
    gives the same bits."""
    BS, MB = 16, 24
    probe = _paged(dev, 1, 1, hd, BS, MB, [1], dtype)
    cr = _chunk_rows(probe[0], probe[1], probe[3])
    cap = BS * MB
    lengths = [cr - 1, cr, cr + 1, 2 * cr, 1, cap, cap + 7, 2 * cr + 1,
               cap - 1, 0]
    args = _paged(dev, len(lengths), 3, hd, BS, MB, lengths, dtype, seed=hd)
    out = pa.paged_decode_attention(*args)
    ref = pa.paged_decode_plain(*(a.float() if a.is_floating_point() else a
                                  for a in args))
    live = [i for i, n in enumerate(lengths) if n > 0]
    torch.testing.assert_close(out[live].float(), ref[live], atol=tol,
                               rtol=tol)
    assert not out[lengths.index(0)].float().abs().any()
    assert torch.equal(out, pa.paged_decode_attention(*args))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_split_paged_kernel_all_full_and_one_page(dev, dtype, tol):
    """Every slot at MB*BS (the most chunks the grid has), and MB = 1 (one
    chunk of one page), against the plain version, twice for the same
    bits."""
    for S, BS, MB in ((6, 16, 64), (5, 8, 1)):
        args = _paged(dev, S, 4, 64, BS, MB, [BS * MB] * (S - 1) + [1],
                      dtype, seed=MB)
        out = pa.paged_decode_attention(*args)
        ref = pa.paged_decode_plain(*(a.float() if a.is_floating_point()
                                      else a for a in args))
        torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
        assert torch.equal(out, pa.paged_decode_attention(*args))


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_split_paged_kernel_misaligned_operand(dev, which):
    """An operand one element past a 16-byte boundary takes the kernel's
    element-by-element loads and gives the aligned operand's bits."""
    args = _paged(dev, 4, 3, 64, 16, 8, [1, 50, 128, 77], torch.float32)
    want = pa.paged_decode_attention(*args)
    i = ("q", "k", "v").index(which)
    t = args[i]
    buf = torch.empty(t.numel() + 1, device=dev)
    shifted = buf[1:].view_as(t)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    args[i] = shifted
    assert torch.equal(pa.paged_decode_attention(*args), want)


@pytest.mark.parametrize("s", [1, 64, 100, 256])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_matches_plain(dev, s, d, causal, dtype, tol):
    g = torch.Generator().manual_seed(s + d)
    q, k, v = (torch.randn(2, 3, s, d, generator=g).to(dev, dtype)
               for _ in range(3))
    before = attn.flash_attention_forward.launches
    o, lse = attn.flash_attention_forward(q, k, v, d ** -0.5, causal)
    assert attn.flash_attention_forward.launches == before + 1
    ro, rlse = attn.flash_attention_plain(q.float(), k.float(), v.float(),
                                          d ** -0.5, causal)
    assert o.dtype == dtype and tuple(lse.shape) == (2, 3, 1, s)
    torch.testing.assert_close(o.float(), ro, atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rlse, atol=tol, rtol=tol)


def _f32_split(q, k, v, scale, causal, ks):
    """The f32 K1 with ``ks`` warps on each 16 query rows, whatever the
    shape (``flash_attention_forward`` picks it from the shape)."""
    import ctypes

    from paddle_tpu_torch.ops import _build
    fn = _build.function(
        "flash_fwd", "flash_attention_forward_f32_split",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, 1, s, device=q.device)
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr(), b * h, s, d, scale, int(causal), ks,
              torch.cuda.current_stream().cuda_stream) == 0
    return o, lse


@pytest.mark.parametrize("s,b,h", [(1, 1, 1), (17, 2, 3), (63, 1, 5),
                                   (65, 2, 2), (661, 1, 12), (1024, 8, 12),
                                   (2048, 1, 4)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_flash_kernel_every_key_split(dev, s, b, h, d, causal):
    """The f32 K1 at ragged S (1 .. 2048), D = 64 and 128, B*H = 1 .. 96:
    the wrapper's launch and each key split (1, 2, 4 warps on 16 rows; 1,
    2 at D = 128) within 2e-5 of the plain version, O and LSE; the
    wrapper gives the same bits twice."""
    g = torch.Generator().manual_seed(s * d + b)
    q, k, v = (torch.randn(b, h, s, d, generator=g).to(dev)
               for _ in range(3))
    scale = d ** -0.5
    ro, rlse = attn.flash_attention_plain(q, k, v, scale, causal)
    o, lse = attn.flash_attention_forward(q, k, v, scale, causal)
    again = attn.flash_attention_forward(q, k, v, scale, causal)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    for ks in (None, 1, 2, 4) if d == 64 else (None, 1, 2):
        if ks is not None:
            o, lse = _f32_split(q, k, v, scale, causal, ks)
        torch.testing.assert_close(o, ro, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(lse, rlse, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("which", ["q", "k", "v"])
@pytest.mark.parametrize("d", [64, 128])
def test_f32_flash_kernel_misaligned_operand(dev, which, d):
    """An operand one float past a 16-byte boundary takes the f32 K1's
    element-by-element staging: within 2e-5 of the plain version and of
    the aligned operand's output, at a short grid and a long one."""
    for shape in ((1, 3, 77, d), (4, 12, 300, d)):
        g = torch.Generator().manual_seed(d)
        ops = dict(zip("qkv", (torch.randn(shape, generator=g).to(dev)
                               for _ in range(3))))
        want = attn.flash_attention_forward(ops["q"], ops["k"], ops["v"],
                                            d ** -0.5, True)
        t = ops[which]
        buf = torch.empty(t.numel() + 1, device=dev)
        shifted = buf[1:].view_as(t)
        shifted.copy_(t)
        assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
        ops[which] = shifted
        got = attn.flash_attention_forward(ops["q"], ops["k"], ops["v"],
                                           d ** -0.5, True)
        ref = attn.flash_attention_plain(ops["q"], ops["k"], ops["v"],
                                         d ** -0.5, True)
        for a, w, r in zip(got, want, ref):
            torch.testing.assert_close(a, r, atol=2e-5, rtol=2e-5)
            torch.testing.assert_close(a, w, atol=2e-5, rtol=2e-5)


# bf16 K1 (the tensor-core kernel) against the plain version with P rounded
# to bf16 over 64-key blocks, as the kernel rounds it: 1e-2, absolute and
# relative (both round O to bf16 once, and an exp or a sum in another order
# can round a P element or O the other way: 2^-8 of it); against P kept in
# f32, 2e-2; LSE is f32 on both sides (sums over up to 2048 keys and
# products over up to 128 columns in another order, exp2 for exp): 5e-5
FLASH_BF16P_TOL = 1e-2
FLASH_LSE_TOL = 5e-5


@pytest.mark.parametrize("s,b,h", [(1, 1, 1), (63, 2, 3), (65, 1, 5),
                                   (200, 3, 4), (333, 1, 12), (1024, 8, 12),
                                   (2048, 1, 4)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_flash_kernel_against_both_plain_variants(dev, s, b, h, d,
                                                       causal):
    """The bf16 K1 at ragged S (1 .. 2048), D = 64 and 128, B*H = 1 .. 96,
    one launch, against both plain variants."""
    g = torch.Generator().manual_seed(s * d + b)
    q, k, v = (torch.randn(b, h, s, d, generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    before = attn.flash_attention_forward.launches
    o, lse = attn.flash_attention_forward(q, k, v, d ** -0.5, causal)
    assert attn.flash_attention_forward.launches == before + 1
    assert o.dtype == torch.bfloat16 and tuple(lse.shape) == (b, h, 1, s)
    for p_dtype, tol in ((None, 2e-2), (torch.bfloat16, FLASH_BF16P_TOL)):
        ro, rlse = attn.flash_attention_plain(q, k, v, d ** -0.5, causal,
                                              p_dtype=p_dtype)
        torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(lse, rlse, atol=FLASH_LSE_TOL,
                                   rtol=FLASH_LSE_TOL)


def test_bf16_forward_kernels_give_the_same_bits_twice(dev):
    """Two runs of the bf16 K1 (the flagship's [8, 12, 1024, 64] causal) and
    of the bf16 K5 (128-row tiles over several vocab splits) give the same
    bits."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(8, 12, 1024, 64, generator=g).to(dev,
                                                            torch.bfloat16)
               for _ in range(3))
    first = attn.flash_attention_forward(q, k, v, 0.125, True)
    again = attn.flash_attention_forward(q, k, v, 0.125, True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    x, w, labels, _ = _ce_inputs(dev, 1000, 768, 20000, torch.bfloat16, 1)
    first = tce.fused_ce_forward(x, w, labels)
    again = tce.fused_ce_forward(x, w, labels)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def _bwd_inputs(dev, shape, dtype, causal, seed):
    """q, k, v, dO in ``dtype`` on the card, with the forward's O and LSE
    from K1 and delta = rowsum(dO * O)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(*shape, generator=g).to(dev, dtype)
                   for _ in range(4))
    o, lse = attn.flash_attention_forward(q, k, v, shape[-1] ** -0.5,
                                          causal)
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("s", [1, 63, 64, 65, 100, 127, 129, 256, 1000])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_backward_kernels_match_plain(dev, s, d, causal, dtype, tol):
    """K2 (dq) and K3 (dk, dv) against the plain backward on f32 copies
    of the same inputs, at the edges of the kernels' tiles (64 held rows
    a block; the f32 kernels stream 32 rows a tile at D = 64, 16 at D =
    128); the tolerance is relative to the largest grad."""
    q, k, v, do, lse, delta = _bwd_inputs(dev, (2, 3, s, d), dtype, causal,
                                          s + d)
    scale = d ** -0.5
    n2, n3 = attn.flash_bwd_dq.launches, attn.flash_bwd_dkv.launches
    dq = attn.flash_bwd_dq(q, k, v, lse, do, delta, scale, causal)
    dk, dv = attn.flash_bwd_dkv(q, k, v, lse, do, delta, scale, causal)
    assert attn.flash_bwd_dq.launches == n2 + 1
    assert attn.flash_bwd_dkv.launches == n3 + 1
    ref = attn.flash_attention_backward_plain(
        q.float(), k.float(), v.float(), lse, do.float(), delta, scale,
        causal)
    for got, want in zip((dq, dk, dv), ref):
        assert got.dtype == dtype and got.shape == want.shape
        err = (got.float() - want).abs().max().item()
        # at s = 1 the true grads are 0 (O = V): an absolute floor of tol
        assert err <= tol * max(want.abs().max().item(), 1.0)


@pytest.mark.parametrize("dtype,tol,btol", [(torch.float32, 2e-5, 1e-4),
                                            (torch.bfloat16, 1e-2, 5e-3)])
def test_noncausal_kernels_at_bert_shape(dev, dtype, tol, btol):
    """K1, K2 and K3 non-causal at BERT-base pretraining's shape
    [32, 12, 128, 64] (two 64-key tiles a row, no causal skip) against
    their plain versions; bf16 against the plain versions that round P
    (and dS) to bf16 as the kernels do. K1's O and LSE within ``tol``,
    the grads within ``btol`` of the largest grad."""
    q, k, v, do, lse, delta = _bwd_inputs(dev, (32, 12, 128, 64), dtype,
                                          False, 128)
    p_dtype = torch.bfloat16 if dtype == torch.bfloat16 else None
    o, lse2 = attn.flash_attention_forward(q, k, v, 0.125, False)
    ro, rlse = attn.flash_attention_plain(q, k, v, 0.125, False,
                                          p_dtype=p_dtype)
    assert (o.float() - ro.float()).abs().max().item() <= tol
    assert (lse2 - rlse).abs().max().item() <= 5e-5
    dq = attn.flash_bwd_dq(q, k, v, lse, do, delta, 0.125, False)
    dk, dv = attn.flash_bwd_dkv(q, k, v, lse, do, delta, 0.125, False)
    ref = attn.flash_attention_backward_plain(
        q.float(), k.float(), v.float(), lse, do.float(), delta, 0.125,
        False, p_dtype=p_dtype)
    for got, want in zip((dq, dk, dv), ref):
        err = (got.float() - want).abs().max().item()
        assert err <= btol * want.abs().max().item()


def test_bert_step_launches_k1_k2_k3_once_a_layer(dev):
    """A BERT-base pretraining step (12 layers, non-causal, under
    amp.auto_cast O1 bf16) launches K1, K2 and K3 12 times each; the loss
    is f32 and finite."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import bert_base
    model = bert_base(max_seq_len=128, dropout=0.0,
                      generator=torch.Generator().manual_seed(0))
    opt = AdamW(1e-4, parameters=model.named_parameters(),
                weight_decay=0.01)
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, 30522, (2, 128))).to(dev)
    mlm = torch.where(torch.rand(2, 128, device=dev) < 0.15, ids, -1)
    nsp = torch.tensor([[0], [1]], device=dev)
    n = (attn.flash_attention_forward.launches, attn.flash_bwd_dq.launches,
         attn.flash_bwd_dkv.launches)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        loss = model(ids, torch.zeros_like(ids), mlm, nsp)
    loss.backward()
    opt.step()
    assert (attn.flash_attention_forward.launches,
            attn.flash_bwd_dq.launches,
            attn.flash_bwd_dkv.launches) == tuple(c + 12 for c in n)
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))


@pytest.mark.parametrize("which", ["q", "k", "v", "do"])
@pytest.mark.parametrize("d", [64, 128])
def test_f32_flash_backward_misaligned_operand(dev, which, d):
    """An operand that starts one float past a 16-byte boundary (a view
    with a storage offset) takes the kernels' element-by-element staging
    and gives the same grads as the aligned operand, within 1e-4."""
    ops = dict(zip(("q", "k", "v", "do", "lse", "delta"), _bwd_inputs(
        dev, (1, 3, 77, d), torch.float32, True, d)))
    scale = d ** -0.5
    want = (attn.flash_bwd_dq(ops["q"], ops["k"], ops["v"], ops["lse"],
                              ops["do"], ops["delta"], scale, True),
            *attn.flash_bwd_dkv(ops["q"], ops["k"], ops["v"], ops["lse"],
                                ops["do"], ops["delta"], scale, True))
    t = ops[which]
    buf = torch.empty(t.numel() + 1, device=dev)
    shifted = buf[1:].view_as(t)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    ops[which] = shifted
    args = (ops["q"], ops["k"], ops["v"], ops["lse"], ops["do"],
            ops["delta"], scale, True)
    got = (attn.flash_bwd_dq(*args), *attn.flash_bwd_dkv(*args))
    ref = attn.flash_attention_backward_plain(*args)
    for g, w, r in zip(got, want, ref):
        top = max(r.abs().max().item(), 1.0)
        assert (g - r).abs().max().item() <= 1e-4 * top
        assert (g - w).abs().max().item() <= 1e-4 * top


def test_f32_backward_kernels_give_the_same_bits_twice(dev):
    """Two runs of the f32 K2 and K3 at [2, 12, 1024, 64] causal give the
    same bits: neither uses atomics."""
    q, k, v, do, lse, delta = _bwd_inputs(dev, (2, 12, 1024, 64),
                                          torch.float32, True, 3)
    runs = [(attn.flash_bwd_dq(q, k, v, lse, do, delta, 0.125, True),
             *attn.flash_bwd_dkv(q, k, v, lse, do, delta, 0.125, True))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# bf16 K2/K3 (the tensor-core kernels) against the plain backward that
# rounds P and dS to bf16 as they do: 5e-3 of the largest grad (half a
# bf16 ulp for the kernels' final rounding, plus a P or dS element that an
# exp or a sum in another order rounds the other way); against P and dS
# kept f32, 2e-2. At s = 1 the true dQ and dK are 0 (O = V, so dP =
# delta): an absolute floor of the tolerance
FLASH_BWD_BF16P_TOL = 5e-3


@pytest.mark.parametrize("s,b,h", [(1, 1, 2), (63, 2, 3), (64, 1, 5),
                                   (65, 1, 5), (333, 1, 12), (1024, 2, 12)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_flash_backward_kernels_against_both_plain_variants(
        dev, s, b, h, d, causal):
    """The bf16 K2 and K3 at the tile edges (S = 1 .. 1024), D = 64 and
    128, B*H = 2 .. 24, one launch each, against both plain variants."""
    q, k, v, do, lse, delta = _bwd_inputs(dev, (b, h, s, d), torch.bfloat16,
                                          causal, s * d + b)
    scale = d ** -0.5
    n2, n3 = attn.flash_bwd_dq.launches, attn.flash_bwd_dkv.launches
    dq = attn.flash_bwd_dq(q, k, v, lse, do, delta, scale, causal)
    dk, dv = attn.flash_bwd_dkv(q, k, v, lse, do, delta, scale, causal)
    assert attn.flash_bwd_dq.launches == n2 + 1
    assert attn.flash_bwd_dkv.launches == n3 + 1
    for p_dtype, tol in ((None, 2e-2), (torch.bfloat16, FLASH_BWD_BF16P_TOL)):
        ref = attn.flash_attention_backward_plain(
            q.float(), k.float(), v.float(), lse, do.float(), delta, scale,
            causal, p_dtype=p_dtype)
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            assert got.dtype == torch.bfloat16 and got.shape == want.shape
            assert torch.isfinite(got).all()
            err = (got.float() - want).abs().max().item()
            assert err <= tol * max(want.abs().max().item(), 1.0), (
                name, p_dtype, err)


def test_bf16_backward_kernels_give_the_same_bits_twice(dev):
    """Two runs of the bf16 K2 and K3 at the flagship's [8, 12, 1024, 64]
    causal give the same bits: neither uses atomics."""
    q, k, v, do, lse, delta = _bwd_inputs(dev, (8, 12, 1024, 64),
                                          torch.bfloat16, True, 0)
    runs = [(attn.flash_bwd_dq(q, k, v, lse, do, delta, 0.125, True),
             *attn.flash_bwd_dkv(q, k, v, lse, do, delta, 0.125, True))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_bf16_flash_backward_rejects_what_it_cannot_take(dev):
    """bf16 operands the kernels do not take raise before any launch: a
    head_dim other than 64/128, a dO of another dtype or layout, fp16, a
    LSE in bf16."""
    q, k, v, do, lse, delta = _bwd_inputs(dev, (1, 2, 40, 64),
                                          torch.bfloat16, True, 1)
    n2, n3 = attn.flash_bwd_dq.launches, attn.flash_bwd_dkv.launches
    q96 = torch.zeros(1, 2, 40, 96, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attn.flash_bwd_dq(q96, q96, q96, lse, q96, delta, 0.1, True)
    with pytest.raises(ValueError):
        attn.flash_bwd_dkv(q, k, v, lse, do.float(), delta, 0.125, True)
    with pytest.raises(ValueError):
        attn.flash_bwd_dq(q, k, v, lse, do.transpose(2, 3).contiguous()
                          .transpose(2, 3), delta, 0.125, True)
    with pytest.raises(TypeError):
        attn.flash_bwd_dkv(q.half(), k.half(), v.half(), lse, do.half(),
                           delta, 0.125, True)
    with pytest.raises(ValueError):
        attn.flash_bwd_dq(q, k, v, lse.bfloat16(), do, delta, 0.125, True)
    assert attn.flash_bwd_dq.launches == n2
    assert attn.flash_bwd_dkv.launches == n3


def test_flash_kernel_rejects_and_backward_launches_k2_k3(dev):
    """The backward of ``scaled_dot_product_attention`` on the card
    launches K2 and K3 once each and matches the plain backward; what the
    kernels cannot take raises."""
    q = torch.randn(1, 2, 16, 96, device=dev)
    with pytest.raises(ValueError):
        attn.flash_attention_forward(q, q, q, 0.1, True)
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 3, 77, 64, generator=g).to(dev)
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n2, n3 = attn.flash_bwd_dq.launches, attn.flash_bwd_dkv.launches
    out = attn.scaled_dot_product_attention(*leaves, is_causal=True)
    out.backward(do)
    assert attn.flash_bwd_dq.launches == n2 + 1
    assert attn.flash_bwd_dkv.launches == n3 + 1
    o, lse = attn.flash_attention_plain(q, k, v, 0.125, True)
    delta = (do * o).sum(-1)[:, :, None, :]
    ref = attn.flash_attention_backward_plain(q, k, v, lse, do, delta, 0.125,
                                              True)
    for leaf, want in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, want, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError):
        attn.flash_bwd_dq(q, k, v, lse, do.transpose(2, 3), delta, 0.125,
                          True)
    with pytest.raises(ValueError):
        attn.flash_bwd_dkv(q, k, v, lse.cpu(), do, delta, 0.125, True)
    # a mask takes the reference's composition (its _flash_op), no K1
    mask = torch.zeros(77, 77, device=dev).masked_fill(
        torch.ones(77, 77, dtype=torch.bool, device=dev).triu(1), -1e9)
    n1 = attn.flash_attention_forward.launches
    got = attn.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    assert attn.flash_attention_forward.launches == n1
    torch.testing.assert_close(
        got, attn.reference_attention(q, k, v, mask, 0.125, False),
        atol=0, rtol=0)


def test_core_attention_op_takes_transposed_unbound_qkv(dev):
    """The core's flash_attention op on the Paddle surface's q, k, v
    (views of a fused QKV after transpose and unbind, non-contiguous)
    makes them contiguous and launches K1, then K2/K3 in backward() on a
    strided grad; the values and grads match the plain versions. With a
    mask it computes the reference's composition and launches no K1."""
    import paddle_tpu_torch as paddle
    g = torch.Generator().manual_seed(3)
    b, s, nh, hd = 2, 77, 3, 64
    qkv_np = (torch.randn(b, s, 3 * nh * hd, generator=g) * 0.5).numpy()
    # the grad reaches K2/K3 through a transpose: strided, as the model's
    do = torch.randn(b, s, nh, hd, generator=g).to(dev)
    card = paddle.CUDAPlace(0)
    x = paddle.to_tensor(qkv_np, place=card, stop_gradient=False)
    qkv = paddle.transpose(paddle.reshape(x, [b, s, 3, nh, hd]),
                           [2, 0, 3, 1, 4])
    q, k, v = paddle.unbind(qkv, axis=0)
    assert not q.value.is_contiguous()
    n = (attn.flash_attention_forward.launches, attn.flash_bwd_dq.launches,
         attn.flash_bwd_dkv.launches)
    out = paddle.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True)
    paddle.transpose(out, [0, 2, 1, 3]).backward(
        paddle.to_tensor(do.cpu().numpy(), place=card))
    from paddle_tpu_torch.core import lazy
    lazy.flush()        # under lazy eager the step's graph runs here
    assert (attn.flash_attention_forward.launches,
            attn.flash_bwd_dq.launches,
            attn.flash_bwd_dkv.launches) == tuple(c + 1 for c in n)
    tx = torch.from_numpy(qkv_np).to(dev).requires_grad_()
    tq, tk, tv = tx.reshape(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4).unbind(0)
    want, _ = attn.flash_attention_plain(tq, tk, tv, hd ** -0.5, True)
    want.permute(0, 2, 1, 3).backward(do)
    torch.testing.assert_close(out.value, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(x.grad.value, tx.grad, atol=1e-4, rtol=1e-4)
    mask_np = np.triu(np.full((s, s), -1e9, np.float32), 1)
    n1 = attn.flash_attention_forward.launches
    got = paddle.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=paddle.to_tensor(mask_np, place=card))
    assert attn.flash_attention_forward.launches == n1
    torch.testing.assert_close(
        got.value, attn.reference_attention(
            q.value, k.value, v.value, torch.from_numpy(mask_np).to(dev),
            hd ** -0.5, False), atol=0, rtol=0)


def test_layer_to_the_card_keeps_its_parameters(dev):
    """A Layer built on the CPU and moved with ``to(device=)`` keeps its
    Parameters and their torch tensors, so an optimizer built before
    updates them on the card; a Layer built on the card holds nothing
    on the CPU (Embedding's padding row, LayerNorm's weights)."""
    import paddle_tpu_torch as paddle
    paddle.set_device("cpu")
    try:
        fc = paddle.nn.Linear(4, 3)
        opt = paddle.optimizer.SGD(0.5, parameters=fc.parameters())
        w, leaf = fc.weight, fc.weight.value
    finally:
        paddle.set_device("gpu")
    try:
        fc.to(device="gpu")
        assert fc.weight is w and w.value is leaf and leaf.is_cuda
        before = w.value.clone()
        fc(paddle.ones([2, 4])).sum().backward()
        opt.step()
        torch.testing.assert_close(w.value, before - 1.0)
        emb = paddle.nn.Embedding(10, 4, padding_idx=3)
        ln = paddle.nn.LayerNorm(4)
        for t in (emb.weight, ln.weight, ln.bias):
            assert t.value.is_cuda
        assert not emb.weight.value[3].any()
    finally:
        from paddle_tpu_torch.core import device as device_mod
        device_mod._current_place = None


def test_engine_on_card_matches_cpu_engine(dev):
    """The tiny GPT served on the card streams the same greedy tokens as
    on the CPU, and every decode step went through the paged kernel."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              TransformerLMConfig)
    cfg = TransformerLMConfig(vocab_size=97, hidden_size=256, num_layers=2,
                              num_heads=4, max_seq_len=64, dropout=0.0)
    cpu = GPTForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0)).eval()
    gpu = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    gpu = gpu.eval()
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 97, n) for n in (5, 19, 33, 8)]
    outs = []
    for model, device in ((cpu, "cpu"), (gpu, None)):
        eng = ServingEngine(model, num_slots=2, bucket_min=8, block_size=4,
                            device=device)
        before = pa.paged_decode_attention.launches
        reqs = [eng.add_request(p, max_new_tokens=6) for p in prompts]
        eng.run()
        outs.append([r.output_ids for r in reqs])
        if device is None:
            assert pa.paged_decode_attention.launches - before == \
                eng.metrics.decode_steps * cfg.num_layers
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _ce_inputs(dev, t, h, v, dtype, seed, label_dtype=torch.int64):
    """x [t, h] and W [v, h] in ``dtype``, labels with every 7th row
    ignored, and a per-token cotangent g, on the card."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(t, h, generator=g) * 0.5).to(dev, dtype)
    w = (torch.randn(v, h, generator=g) * 0.5).to(dev, dtype)
    labels = torch.randint(0, v, (t,), generator=g)
    labels[::7] = -100
    gg = ((torch.rand(t, generator=g) + 0.5) / t).to(dev)
    return x, w, labels.to(dev, label_dtype), gg


@pytest.mark.parametrize("t,h,v", [(1, 8, 5), (37, 48, 211), (130, 64, 1000),
                                   (70, 800, 300)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("label_dtype", [torch.int64, torch.int32])
def test_fused_ce_kernels_match_plain(dev, t, h, v, dtype, tol, label_dtype):
    """K5 (loss, LSE), K6 (dx) and K7 (dW) against their plain versions on
    f32 copies of the same inputs, ragged T, V and H (H = 800 puts dx/dW
    columns on two blocks); the loss and LSE are f32 sums on both sides
    (atol 1e-4), the grads held relative to the largest grad (1e-4 in
    f32, 1e-2 in bf16, where the kernel rounds them to bf16)."""
    x, w, labels, g = _ce_inputs(dev, t, h, v, dtype, t + h + v, label_dtype)
    n5, n6, n7 = (tce.fused_ce_forward.launches, tce.fused_ce_bwd_dx.launches,
                  tce.fused_ce_bwd_dw.launches)
    loss, lse = tce.fused_ce_forward(x, w, labels)
    rloss, rlse = tce.fused_linear_cross_entropy_plain(x.float(), w.float(),
                                                       labels)
    torch.testing.assert_close(loss, rloss, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-5)
    assert not loss[labels == -100].any()
    dx = tce.fused_ce_bwd_dx(x, w, labels, lse, g)
    dw = tce.fused_ce_bwd_dw(x, w, labels, lse, g)
    assert (tce.fused_ce_forward.launches, tce.fused_ce_bwd_dx.launches,
            tce.fused_ce_bwd_dw.launches) == (n5 + 1, n6 + 1, n7 + 1)
    ref = tce.fused_linear_cross_entropy_backward_plain(
        x.float(), w.float(), labels, lse, g)
    for got, want in zip((dx, dw), ref):
        assert got.dtype == dtype and got.shape == want.shape
        err = (got.float() - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), err


@pytest.mark.parametrize("t,h,v", [
    (256, 8, 1234), (256, 48, 1234), (256, 200, 1234), (256, 800, 1234),
    (256, 1024, 1234), (45, 13, 300), (1, 768, 1234), (127, 768, 1234),
    (129, 768, 1234), (1000, 768, 1234), (256, 768, 7), (300, 768, 50304)])
@pytest.mark.parametrize("label_dtype", [torch.int64, torch.int32])
def test_bf16_ce_forward_kernel_at_tile_edges(dev, t, h, v, label_dtype):
    """The bf16 K5 at the edges of its 128 x 128 tiles and 64-column slices
    of H (H = 8 .. 1024, 13 staged element by element; T = 1 .. 1000; V =
    7 .. 50304), one launch, against the plain forward on f32 copies: the
    loss and LSE are f32 on both sides (atol 1e-4)."""
    x, w, labels, _ = _ce_inputs(dev, t, h, v, torch.bfloat16, t + h + v,
                                 label_dtype)
    before = tce.fused_ce_forward.launches
    loss, lse = tce.fused_ce_forward(x, w, labels)
    assert tce.fused_ce_forward.launches == before + 1
    rloss, rlse = tce.fused_linear_cross_entropy_plain(x.float(), w.float(),
                                                       labels)
    torch.testing.assert_close(loss, rloss, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-5)
    assert not loss[labels == -100].any()


def test_bf16_ce_forward_all_ignored_and_out_of_range_labels(dev):
    """bf16 K5: an all-ignored batch loses 0 everywhere with the plain LSE;
    a label outside [0, V) that is not ignore_index gets a label logit of
    0, so its loss is its LSE."""
    x, w, labels, _ = _ce_inputs(dev, 70, 768, 3000, torch.bfloat16, 5)
    _, rlse = tce.fused_linear_cross_entropy_plain(x.float(), w.float(),
                                                   labels)
    loss, lse = tce.fused_ce_forward(x, w, torch.full_like(labels, -100))
    assert not loss.any()
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-5)
    odd = labels.clone()
    odd[:3] = torch.tensor([3000, 4000, -3], device=dev)
    loss, lse = tce.fused_ce_forward(x, w, odd)
    torch.testing.assert_close(loss[:3], lse[:3], atol=0, rtol=0)


# bf16 K6/K7 (the tensor-core kernel) against the plain backward: with d
# kept f32, 1e-2 of the largest grad (d rounded to bf16 in the kernel,
# summed over V or T, and the final rounding); with d rounded to bf16 as
# the kernel rounds it, 4e-3 (half a bf16 ulp at the largest grad for the
# final rounding, plus f32 sums in another order, which may round a d
# the other way)
CE_BF16D_TOL = 4e-3


def _bf16_backward_errors(x, w, labels, lse, g):
    dx = tce.fused_ce_bwd_dx(x, w, labels, lse, g)
    dw = tce.fused_ce_bwd_dw(x, w, labels, lse, g)
    errs = []
    for d_dtype, tol in ((None, 1e-2), (torch.bfloat16, CE_BF16D_TOL)):
        ref = tce.fused_linear_cross_entropy_backward_plain(
            x.float(), w.float(), labels, lse, g, d_dtype=d_dtype)
        for got, want in zip((dx, dw), ref):
            assert got.dtype == torch.bfloat16 and got.shape == want.shape
            err = (got.float() - want).abs().max().item()
            top = want.abs().max().item()
            assert bool(torch.isfinite(got).all()) and err <= tol * top, (
                d_dtype, err, top)
            errs.append(err / top if top else 0.0)
    return dx, dw, errs


@pytest.mark.parametrize("t,h,v", [
    (256, 8, 1234), (256, 48, 1234), (256, 200, 1234), (256, 768, 1234),
    (256, 800, 1234), (256, 1024, 1234), (1, 768, 1234), (31, 768, 1234),
    (33, 768, 1234), (63, 768, 1234), (65, 768, 1234), (1000, 768, 1234),
    (256, 768, 7), (256, 768, 50304), (45, 13, 300)])
@pytest.mark.parametrize("label_dtype", [torch.int64, torch.int32])
def test_bf16_ce_backward_kernels_at_tile_edges(dev, t, h, v, label_dtype):
    """The bf16 K6/K7 at the edges of their 32-row tiles and 768-column
    chunks of H (H = 8 .. 1024, 13 staged element by element; T = 1 ..
    1000; V = 7 .. 50304) against both plain variants, one launch each."""
    x, w, labels, g = _ce_inputs(dev, t, h, v, torch.bfloat16, t + h + v,
                                 label_dtype)
    _, lse = tce.fused_ce_forward(x, w, labels)
    n6, n7 = tce.fused_ce_bwd_dx.launches, tce.fused_ce_bwd_dw.launches
    _bf16_backward_errors(x, w, labels, lse, g)
    assert (tce.fused_ce_bwd_dx.launches,
            tce.fused_ce_bwd_dw.launches) == (n6 + 1, n7 + 1)


def test_bf16_ce_backward_all_ignored_and_deterministic(dev):
    """An all-ignored batch gives exactly zero grads; two runs of the bf16
    K6/K7 at a mid-size shape give the same bits."""
    x, w, labels, g = _ce_inputs(dev, 70, 768, 3000, torch.bfloat16, 5)
    ignored = torch.full_like(labels, -100)
    _, lse = tce.fused_ce_forward(x, w, ignored)
    assert not tce.fused_ce_bwd_dx(x, w, ignored, lse, g).any()
    assert not tce.fused_ce_bwd_dw(x, w, ignored, lse, g).any()
    _, lse = tce.fused_ce_forward(x, w, labels)
    first = _bf16_backward_errors(x, w, labels, lse, g)
    again = _bf16_backward_errors(x, w, labels, lse, g)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


# the f32 K6/K7 (CUDA cores): 32-row blocks of A, 16-row tiles of B,
# 768-column chunks of H; held to the plain backward (d kept f32) within
# 1e-4 of the largest grad: f32 sums over V or T in another order. At V =
# 1 every true grad is 0 (the softmax of one logit is 1, less the one-hot
# 1), while the kernel's S, summed in another order than the LSE's, leaves
# exp(S - lse) an ulp or so from 1: there the grads are held to 1e-4 of
# the largest term of their sums instead, max |g| times the largest
# element of the other operand
CE_EDGES = [1, 15, 16, 17, 31, 32, 33, 63, 64, 65]


def _f32_backward(x, w, labels, g, tol=1e-4):
    """One launch each of the f32 K6 and K7 (counted), against the plain
    backward on the same inputs; returns (dx, dW)."""
    _, lse = tce.fused_linear_cross_entropy_plain(x, w, labels)
    n6, n7 = tce.fused_ce_bwd_dx.launches, tce.fused_ce_bwd_dw.launches
    dx = tce.fused_ce_bwd_dx(x, w, labels, lse, g)
    dw = tce.fused_ce_bwd_dw(x, w, labels, lse, g)
    assert (tce.fused_ce_bwd_dx.launches,
            tce.fused_ce_bwd_dw.launches) == (n6 + 1, n7 + 1)
    ref = tce.fused_linear_cross_entropy_backward_plain(x, w, labels, lse, g)
    for got, want, other in zip((dx, dw), ref, (w, x)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        err = (got - want).abs().max().item()
        top = want.abs().max().item() or (
            g.abs().max() * other.abs().max()).item()
        assert bool(torch.isfinite(got).all()) and err <= tol * top, (
            err, top)
    return dx, dw


@pytest.mark.parametrize("t", CE_EDGES)
@pytest.mark.parametrize("v", CE_EDGES)
def test_f32_ce_backward_kernels_at_row_tile_edges(dev, t, v):
    """The f32 K6/K7 with T and V one row before, on and past their 16- and
    32-row tiles (1 .. 65), H = 768."""
    _f32_backward(*_ce_inputs(dev, t, 768, v, torch.float32, 100 * t + v))


@pytest.mark.parametrize("h", [8, 13, 768, 800, 1536])
@pytest.mark.parametrize("t,v", [(1, 1), (33, 17), (65, 63), (200, 1234)])
@pytest.mark.parametrize("label_dtype", [torch.int64, torch.int32])
def test_f32_ce_backward_kernels_across_h(dev, h, t, v, label_dtype):
    """The f32 K6/K7 at H below, on and past one 768-column chunk (13
    stages element by element; 800 and 1536 walk two chunks), int32 and
    int64 labels."""
    x, w, labels, g = _ce_inputs(dev, t, h, v, torch.float32, t + h + v,
                                 label_dtype)
    _f32_backward(x, w, labels, g)


@pytest.mark.parametrize("which", ["x", "w"])
@pytest.mark.parametrize("h", [768, 800])
def test_f32_ce_backward_misaligned_operand(dev, which, h):
    """x or W one float past a 16-byte boundary: the f32 K6/K7 stage it
    element by element and give the aligned operands' results within the
    same tolerance."""
    x, w, labels, g = _ce_inputs(dev, 70, h, 300, torch.float32, 3)
    src = x if which == "x" else w
    buf = torch.empty(src.numel() + 1, device=dev)
    shifted = buf[1:].view_as(src)
    shifted.copy_(src)
    assert shifted.data_ptr() % 16
    args = (shifted, w) if which == "x" else (x, shifted)
    got = _f32_backward(*args, labels, g)
    want = _f32_backward(x, w, labels, g)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.parametrize("h", [768, 800])
def test_f32_ce_backward_all_ignored_gives_exact_zeros(dev, h):
    """Every row ignore_index: the f32 K6/K7 write exact zeros."""
    x, w, labels, g = _ce_inputs(dev, 70, h, 3000, torch.float32, 5)
    ignored = torch.full_like(labels, -100)
    _, lse = tce.fused_ce_forward(x, w, ignored)
    assert not tce.fused_ce_bwd_dx(x, w, ignored, lse, g).any()
    assert not tce.fused_ce_bwd_dw(x, w, ignored, lse, g).any()


def test_f32_ce_backward_gives_the_same_bits_twice(dev):
    """Two runs of the f32 K6/K7 at [T = 2048, H = 768, V = 50304] give the
    same bits, and both are within 1e-4 of the largest grad of the plain
    backward."""
    x, w, labels, g = _ce_inputs(dev, 2048, 768, 50304, torch.float32, 11)
    first = _f32_backward(x, w, labels, g)
    again = _f32_backward(x, w, labels, g)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


# the f32 K5 (CUDA cores): 128-row token tiles by 128-row vocab tiles, H
# in 64-column slices; the loss and LSE are f32 on both sides, sums over H
# and a logsumexp over V in another order (atol 1e-4)
K5_EDGES = [1, 127, 128, 129, 1000]


def _f32_forward(x, w, labels):
    """One launch of the f32 K5 (counted), against the plain forward on the
    same inputs; ignore_index rows lose exactly 0. Returns (loss, lse)."""
    before = tce.fused_ce_forward.launches
    loss, lse = tce.fused_ce_forward(x, w, labels)
    assert tce.fused_ce_forward.launches == before + 1
    rloss, rlse = tce.fused_linear_cross_entropy_plain(x, w, labels)
    assert loss.dtype == lse.dtype == torch.float32
    torch.testing.assert_close(loss, rloss, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-5)
    assert not loss[labels == -100].any()
    return loss, lse


@pytest.mark.parametrize("t", K5_EDGES)
@pytest.mark.parametrize("v", K5_EDGES)
def test_f32_ce_forward_kernel_at_tile_edges(dev, t, v):
    """The f32 K5 with T and V one row before, on and past its 128-row
    tiles (1 .. 1000), H = 768."""
    _f32_forward(*_ce_inputs(dev, t, 768, v, torch.float32, 10 * t + v)[:3])


@pytest.mark.parametrize("h", [13, 768, 1536])
@pytest.mark.parametrize("t,v", [(129, 7), (300, 50304), (1, 1000)])
@pytest.mark.parametrize("label_dtype", [torch.int64, torch.int32])
def test_f32_ce_forward_kernel_across_h(dev, h, t, v, label_dtype):
    """The f32 K5 at H = 13 (staged element by element), 768 and 1536 (12
    and 24 slices), V = 7 .. 50304, int32 and int64 labels."""
    x, w, labels, _ = _ce_inputs(dev, t, h, v, torch.float32, t + h + v,
                                 label_dtype)
    _f32_forward(x, w, labels)


@pytest.mark.parametrize("which", ["x", "w"])
@pytest.mark.parametrize("h", [768, 800])
def test_f32_ce_forward_misaligned_operand(dev, which, h):
    """x or W one float past a 16-byte boundary: the f32 K5 stages it
    element by element, the same values in the same order, so it gives
    the aligned operands' bits."""
    x, w, labels, _ = _ce_inputs(dev, 300, h, 1000, torch.float32, 4)
    src = x if which == "x" else w
    big = torch.empty(src.numel() + 1, device=dev)
    shifted = big[1:].view_as(src)
    shifted.copy_(src)
    assert shifted.data_ptr() % 16
    args = (shifted, w) if which == "x" else (x, shifted)
    got = _f32_forward(*args, labels)
    want = _f32_forward(x, w, labels)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_f32_ce_forward_all_ignored_and_out_of_range_labels(dev):
    """f32 K5: an all-ignored batch loses exactly 0 everywhere with the
    plain LSE; a label outside [0, V) that is not ignore_index gets a
    label logit of 0, so its loss is its LSE."""
    x, w, labels, _ = _ce_inputs(dev, 200, 768, 3000, torch.float32, 5)
    _, rlse = tce.fused_linear_cross_entropy_plain(x, w, labels)
    loss, lse = tce.fused_ce_forward(x, w, torch.full_like(labels, -100))
    assert not loss.any()
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-5)
    odd = labels.clone()
    odd[:3] = torch.tensor([3000, 4000, -3], device=dev)
    loss, lse = tce.fused_ce_forward(x, w, odd)
    torch.testing.assert_close(loss[:3], lse[:3], atol=0, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-5)


def test_f32_ce_forward_gives_the_same_bits_twice(dev):
    """Two runs of the f32 K5 at [T = 2048, H = 768, V = 50304] give the
    same bits, both within 1e-4 of the plain forward."""
    x, w, labels, _ = _ce_inputs(dev, 2048, 768, 50304, torch.float32, 12)
    first = _f32_forward(x, w, labels)
    again = _f32_forward(x, w, labels)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_fused_ce_rejects_and_autograd_launches_k5_k6_k7(dev):
    """Under autograd the fused op launches K5 once and K6 and K7 once
    each in its backward, with the plain composition's grads; what the
    kernels cannot take raises."""
    x, w, labels, g = _ce_inputs(dev, 45, 64, 300, torch.float32, 0)
    leaves = [t.clone().requires_grad_() for t in (x, w)]
    n5, n6, n7 = (tce.fused_ce_forward.launches, tce.fused_ce_bwd_dx.launches,
                  tce.fused_ce_bwd_dw.launches)
    loss = tce.fused_linear_cross_entropy(*leaves, labels)
    (loss * g).sum().backward()
    assert (tce.fused_ce_forward.launches, tce.fused_ce_bwd_dx.launches,
            tce.fused_ce_bwd_dw.launches) == (n5 + 1, n6 + 1, n7 + 1)
    _, lse = tce.fused_linear_cross_entropy_plain(x, w, labels)
    ref = tce.fused_linear_cross_entropy_backward_plain(x, w, labels, lse, g)
    for leaf, want in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, want, atol=1e-5, rtol=1e-4)
    with pytest.raises(TypeError):
        tce.fused_ce_forward(x.half(), w.half(), labels)
    with pytest.raises(TypeError):
        tce.fused_ce_forward(x, w.bfloat16(), labels)
    with pytest.raises(TypeError):
        tce.fused_ce_forward(x, w, labels.float())
    with pytest.raises(ValueError):
        tce.fused_ce_forward(x, w, labels.cpu())
    with pytest.raises(ValueError):
        tce.fused_ce_forward(x.t().contiguous().t(), w, labels)
    with pytest.raises(ValueError):
        tce.fused_ce_bwd_dx(x, w, labels, lse, g[:-1])


def test_tied_gpt_step_on_card_matches_cpu(dev):
    """A tied 2-layer GPT: the loss and every grad of one step on the card
    (K1-K3, K5-K7) match the same model on the CPU, in f32 and under
    ``auto_cast`` O1 (grads held relative to each parameter's largest:
    1e-3 in f32, 5e-2 under O1, where the two devices round to bf16 in
    different kernels)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              TransformerLMConfig)
    cfg = TransformerLMConfig(vocab_size=300, hidden_size=128, num_layers=2,
                              num_heads=2, max_seq_len=64, dropout=0.0)
    ids = torch.randint(0, 300, (2, 64), generator=torch.Generator()
                        .manual_seed(1))
    for level, tol in ((None, 1e-3), ("O1", 5e-2)):
        runs = []
        for device in ("cpu", None):
            m = GPTForCausalLM(cfg, device=device,
                               generator=torch.Generator().manual_seed(0))
            t = ids.to(m.device)
            with amp.auto_cast(enable=level is not None, level=level or "O1"):
                loss = m(t, labels=t)
            loss.backward()
            runs.append((loss.item(), {n: p.grad.float().cpu()
                                       for n, p in m.named_parameters()}))
        (cl, cg), (gl, gg) = runs
        assert abs(gl - cl) <= 1e-4 * abs(cl) * (1 if level is None else 10)
        for name, want in cg.items():
            err = (gg[name] - want).abs().max().item()
            assert err <= tol * want.abs().max().item(), (level, name, err)
