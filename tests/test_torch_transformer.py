"""paddle_tpu_torch's Transformer layers and its masked attention against
the JAX package's on the CPU.

The masked route of ``scaled_dot_product_attention`` (and of the core's
``flash_attention`` op) against the reference's ``_reference_attention``
with a bool and a float mask. ``MultiHeadAttention`` by every route
(no mask, bool mask, float mask, ``need_weights``, ``cache`` /
``gen_cache``, cross-attention of unequal lengths, head_dim 8,
attention dropout in training and in eval), each checked to take the
route the module documents (the core's flash op or the composition),
its output and every grad against the reference layer with the same
weights. The encoder (post- and pre-norm), the decoder and
``Transformer``, forward and grads, and
``generate_square_subsequent_mask``. f32, no TF32: rtol/atol 1e-5 (the
flash route's plain version sums in another order than the reference's
composition).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu.ops.attention import _reference_attention
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.ops import attention as attn_ops

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _carry(src, dst):
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    assert list(sd) == list(dst.state_dict())
    assert dst.set_state_dict(sd) == []


def _close(a, b, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol, err_msg=msg)


# ------------------------------------------------ the masked attention route

@pytest.mark.parametrize("kind", ["bool", "float"])
@pytest.mark.parametrize("causal", [False, True])
def test_masked_sdpa_is_the_reference_composition(kind, causal):
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(2, 3, 7, 64).astype("float32") for _ in range(3))
    if kind == "bool":
        mask = rs.rand(1, 1, 7, 7) < 0.7
    else:
        mask = np.where(rs.rand(2, 1, 7, 7) < 0.7, 0.0,
                        -1e9).astype("float32")
    want = np.asarray(_reference_attention(q, k, v, mask, 0.125, causal))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    n = attn_ops.flash_attention_forward.launches
    got = attn_ops.scaled_dot_product_attention(
        tq, tk, tv, attn_mask=torch.from_numpy(mask), is_causal=causal)
    _close(got, want, msg="torch tensors")
    core = paddle.nn.functional.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)),
        attn_mask=paddle.to_tensor(mask), is_causal=causal)
    _close(core.numpy(), want, msg="core op")
    # the composition: no K1 (nor its plain version) on this route
    assert attn_ops.flash_attention_forward.launches == n


def test_masked_sdpa_grads_are_the_compositions():
    rs = np.random.RandomState(1)
    arrs = [rs.randn(1, 2, 5, 64).astype("float32") for _ in range(4)]
    mask = np.where(rs.rand(1, 1, 5, 5) < 0.6, 0.0, -1e9).astype("float32")
    grads = []
    for P in (ref, paddle):
        q, k, v = (P.to_tensor(a, stop_gradient=False) for a in arrs[:3])
        out = P.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=P.to_tensor(mask))
        P.sum(out * P.to_tensor(arrs[3])).backward()
        grads.append([t.grad.numpy() for t in (q, k, v)])
    for g, w in zip(grads[1], grads[0]):
        _close(g, w)


# ----------------------------------------------------- MultiHeadAttention

@pytest.fixture
def route(monkeypatch):
    """Counts the calls MultiHeadAttention makes to the core's flash op."""
    calls = []
    real = attn_ops._flash_op

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(attn_ops, "_flash_op", counted)
    return calls


def _mha_pair(embed, heads, seed=0, **kw):
    ref.seed(seed)
    r = ref.nn.MultiHeadAttention(embed, heads, **kw)
    t = paddle.nn.MultiHeadAttention(embed, heads, **kw)
    _carry(r, t)
    return r, t


def _run_mha(P, layer, arrays, mask=None, use_cache=False, gen=False):
    q = P.to_tensor(arrays["q"], stop_gradient=False)
    kv = P.to_tensor(arrays["kv"], stop_gradient=False) \
        if "kv" in arrays else q
    m = None if mask is None else P.to_tensor(mask)
    if use_cache:
        cache = layer.gen_cache(q) if gen else (
            P.to_tensor(arrays["ck"]), P.to_tensor(arrays["cv"]))
        out, new_cache = layer(q, kv, kv, m, cache)
        outs = [out, new_cache[0], new_cache[1]]
    else:
        res = layer(q, kv, kv, m)
        outs = list(res) if isinstance(res, tuple) else [res]
    w = P.to_tensor(arrays["w"])
    P.sum(outs[0] * w).backward()
    grads = [q.grad.numpy()] + ([kv.grad.numpy()] if kv is not q else [])
    grads += [p.grad.numpy() for p in layer.parameters()]
    return [o.numpy() for o in outs], grads


MHA_CASES = [
    # (id, embed, heads, q len, kv len, mask kind, kwargs, cache, flash)
    ("no_mask", 64, 1, 6, None, None, {}, None, True),
    ("bool_mask", 64, 1, 6, None, "bool", {}, None, True),
    ("float_mask", 128, 2, 6, None, "float", {}, None, True),
    ("need_weights", 64, 1, 6, None, None, {"need_weights": True}, None,
     False),
    ("cache", 64, 1, 3, None, None, {}, "given", False),
    ("gen_cache", 64, 1, 4, None, None, {}, "gen", False),
    ("cross_unequal", 64, 1, 5, 9, "float", {}, None, False),
    ("head_dim_8", 32, 4, 6, None, "bool", {}, None, False),
    ("dropout_eval", 64, 1, 6, None, None, {"dropout": 0.5}, None, True),
]


@pytest.mark.parametrize("case", MHA_CASES, ids=[c[0] for c in MHA_CASES])
def test_multi_head_attention_matches_reference(case, route):
    name, embed, heads, s, t, mask_kind, kw, cache, flash = case
    rs = np.random.RandomState(3)
    arrays = {"q": rs.randn(2, s, embed).astype("float32")}
    klen = s if t is None else t
    if t is not None:
        arrays["kv"] = rs.randn(2, t, embed).astype("float32")
    hd = embed // heads
    total = klen
    if cache == "given":
        arrays["ck"] = rs.randn(2, heads, 4, hd).astype("float32")
        arrays["cv"] = rs.randn(2, heads, 4, hd).astype("float32")
        total = klen + 4
    mask = None
    if mask_kind == "bool":
        mask = rs.rand(1, 1, s, total) < 0.7
        mask[..., 0] = True
    elif mask_kind == "float":
        mask = np.where(rs.rand(2, 1, s, total) < 0.7, 0.0,
                        -1e9).astype("float32")
    arrays["w"] = rs.randn(2, s, embed).astype("float32")
    r, tl = _mha_pair(embed, heads, **kw)
    if name == "dropout_eval":
        r.eval()
        tl.eval()
    want = _run_mha(ref, r, arrays, mask, cache is not None, cache == "gen")
    got = _run_mha(paddle, tl, arrays, mask, cache is not None,
                   cache == "gen")
    assert len(route) == (1 if flash else 0), name
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            assert g.shape == w.shape, name
            _close(g, w, msg=name)


def test_attention_dropout_in_training_takes_the_composition(route):
    paddle.seed(0)
    m = paddle.nn.MultiHeadAttention(64, 1, dropout=0.5)
    x = paddle.to_tensor(np.ones((1, 4, 64), np.float32))
    m(x)
    assert not route
    m.eval()
    m(x)
    assert len(route) == 1


# ------------------------------------------- encoder, decoder, Transformer

def _layer_grads(P, layer, inputs, masks, wshape):
    ts = [P.to_tensor(a, stop_gradient=False) for a in inputs]
    ms = [None if m is None else P.to_tensor(m) for m in masks]
    out = layer(*ts, *ms)
    w = P.to_tensor(np.linspace(-1, 1, int(np.prod(wshape)))
                    .reshape(wshape).astype("float32"))
    P.sum(out * w).backward()
    return ([out.numpy()] + [t.grad.numpy() for t in ts]
            + [p.grad.numpy() for p in layer.parameters()])


@pytest.mark.parametrize("pre_norm", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_encoder_matches_reference(pre_norm, masked, route):
    def make(P):
        P.seed(5)
        lyr = P.nn.TransformerEncoderLayer(64, 1, 96, dropout=0.0,
                                           normalize_before=pre_norm)
        return P.nn.TransformerEncoder(
            lyr, 2, P.nn.LayerNorm(64) if pre_norm else None)
    r, t = make(ref), make(paddle)
    _carry(r, t)
    rs = np.random.RandomState(6)
    src = rs.randn(2, 7, 64).astype("float32")
    mask = ref.nn.Transformer.generate_square_subsequent_mask(7).numpy() \
        if masked else None
    want = _layer_grads(ref, r, [src], [mask], (2, 7, 64))
    got = _layer_grads(paddle, t, [src], [mask], (2, 7, 64))
    assert len(route) == 2       # both layers through the core's flash op
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("pre_norm", [False, True])
def test_decoder_matches_reference(pre_norm, route):
    def make(P):
        P.seed(7)
        lyr = P.nn.TransformerDecoderLayer(64, 1, 96, dropout=0.0,
                                           normalize_before=pre_norm,
                                           activation="gelu")
        return P.nn.TransformerDecoder(
            lyr, 2, P.nn.LayerNorm(64) if pre_norm else None)
    r, t = make(ref), make(paddle)
    _carry(r, t)
    rs = np.random.RandomState(8)
    tgt = rs.randn(2, 5, 64).astype("float32")
    mem = rs.randn(2, 9, 64).astype("float32")
    tmask = ref.nn.Transformer.generate_square_subsequent_mask(5).numpy()
    want = _layer_grads(ref, r, [tgt, mem], [tmask, None], (2, 5, 64))
    got = _layer_grads(paddle, t, [tgt, mem], [tmask, None], (2, 5, 64))
    # self-attention through the flash op; cross-attention (5 vs 9) not
    assert len(route) == 2
    for g, w in zip(got, want):
        _close(g, w)


def test_transformer_matches_reference():
    def make(P):
        P.seed(9)
        return P.nn.Transformer(d_model=32, nhead=4, num_encoder_layers=2,
                                num_decoder_layers=2, dim_feedforward=48,
                                dropout=0.0)
    r, t = make(ref), make(paddle)
    _carry(r, t)
    rs = np.random.RandomState(10)
    src = rs.randn(2, 6, 32).astype("float32")
    tgt = rs.randn(2, 4, 32).astype("float32")
    tmask = ref.nn.Transformer.generate_square_subsequent_mask(4).numpy()
    want = _layer_grads(ref, r, [src, tgt], [None, tmask, None], (2, 4, 32))
    got = _layer_grads(paddle, t, [src, tgt], [None, tmask, None],
                       (2, 4, 32))
    for g, w in zip(got, want):
        _close(g, w)


def test_square_subsequent_mask_matches_reference():
    for n in (1, 5):
        np.testing.assert_array_equal(
            paddle.nn.Transformer.generate_square_subsequent_mask(n).numpy(),
            ref.nn.Transformer.generate_square_subsequent_mask(n).numpy())
