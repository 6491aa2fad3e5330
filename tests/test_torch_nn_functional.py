"""paddle_tpu_torch's ``nn.functional`` against the JAX package's on the
CPU: the activations (values and grads: the unary grads of
tests/test_op_grads_sweep.py whose ops this slice ports), ``softmax``
with ``dtype``, ``linear`` (``x @ W + b``, W ``[in, out]``),
``layer_norm`` (``normalized_shape`` fixing ``begin_norm_axis``),
``embedding`` (``padding_idx``, the dense scatter grad), ``one_hot``,
``softmax_with_cross_entropy`` / ``cross_entropy`` (the squeeze on
``axis``, ``weight``, an all-ignored batch, soft labels, probabilities),
the plain losses, and attention on core Tensors. The reference scenarios
of tests/test_ops.py's ``TestNNOps`` (softmax, layer_norm, the ignored
labels, BCE with logits, dropout, embedding padding) and of
test_op_grads_sweep.py's ``test_cross_entropy_logits`` and
``test_embedding_weight`` are among them.

Forward values are held with f32 ``allclose`` (rtol 1e-6, atol 1e-6)
and the same dtype; the grads of a case (its float outputs against a
fixed cotangent) at rtol 1e-5. The dropouts draw from the port's own
generators (a documented divergence: the reference draws from
``jax.random``), so they are held to the reference's keep rule and
upscale, the keep share within six binomial standard deviations, and
determinism under ``paddle_tpu_torch.seed``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod

RTOL = ATOL = 1e-6
GRAD_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


_rs = np.random.RandomState(0)
# |x| in [0.3, 1.7]: off the kinks, as test_op_grads_sweep's _X
XS = (_rs.uniform(0.3, 1.7, (3, 4))
      * np.where(_rs.rand(3, 4) < 0.5, -1.0, 1.0)).astype(np.float32)
UNIT = _rs.uniform(-0.9, 0.9, (3, 4)).astype(np.float32)
WIDE = (_rs.randn(4, 6) * 4).astype(np.float32)
LOGITS = _rs.randn(6, 5).astype(np.float32)
LABELS = np.array([1, 0, 4, 2, 2, 3], np.int64)
IGNORED = np.array([1, -100, 4, -100, 2, 3], np.int64)
SOFT = np.abs(_rs.randn(6, 5)).astype(np.float32)
SOFT /= SOFT.sum(-1, keepdims=True)
PROBS = np.exp(LOGITS) / np.exp(LOGITS).sum(-1, keepdims=True)
W5 = _rs.uniform(0.5, 2.0, 5).astype(np.float32)
SEQ = _rs.randn(2, 3, 8).astype(np.float32)
IMG = _rs.randn(2, 4, 3, 3).astype(np.float32)
POS = _rs.uniform(0.05, 0.95, (3, 4)).astype(np.float32)
BIN = (_rs.rand(3, 4) > 0.5).astype(np.float32)
TABLE = _rs.randn(7, 4).astype(np.float32)
IDS = np.array([[0, 2, 2], [6, 1, 0]], np.int64)


def F(P):
    return P.nn.functional


ACTIVATIONS = {
    "relu": lambda P, x: F(P).relu(x),
    "relu6": lambda P, x: F(P).relu6(x * 4.0),
    "sigmoid": lambda P, x: F(P).sigmoid(x),
    "tanh": lambda P, x: F(P).tanh(x),
    "softsign": lambda P, x: F(P).softsign(x),
    "silu": lambda P, x: F(P).silu(x),
    "swish": lambda P, x: F(P).swish(x),
    "mish": lambda P, x: F(P).mish(x),
    "hardswish": lambda P, x: F(P).hardswish(x),
    "hardsigmoid": lambda P, x: F(P).hardsigmoid(x * 5.0),
    "tanhshrink": lambda P, x: F(P).tanhshrink(x),
    "log_sigmoid": lambda P, x: F(P).log_sigmoid(x),
    "gelu_erf": lambda P, x: F(P).gelu(x),
    "gelu_tanh": lambda P, x: F(P).gelu(x, approximate=True),
    "leaky_relu": lambda P, x: F(P).leaky_relu(x, 0.1),
    "elu": lambda P, x: F(P).elu(x),
    "elu_alpha": lambda P, x: F(P).elu(x, alpha=0.5),
    "selu": lambda P, x: F(P).selu(x),
    "celu": lambda P, x: F(P).celu(x, alpha=0.7),
    "hardtanh": lambda P, x: F(P).hardtanh(x, -0.5, 0.8),
    "hardshrink": lambda P, x: F(P).hardshrink(x, 0.6),
    "softshrink": lambda P, x: F(P).softshrink(x, 0.6),
    "softplus": lambda P, x: F(P).softplus(x),
    "softplus_beta": lambda P, x: F(P).softplus(x * 20.0, beta=2.0,
                                                threshold=15.0),
    "thresholded_relu": lambda P, x: F(P).thresholded_relu(x, 0.5),
    "softmax": lambda P, x: F(P).softmax(x, axis=-1),
    "softmax_axis0": lambda P, x: F(P).softmax(x, axis=0),
    "log_softmax": lambda P, x: F(P).log_softmax(x, axis=-1),
    "glu": lambda P, x: F(P).glu(x, axis=-1),
    "maxout": lambda P, x: F(P).maxout(x.reshape([1, 4, 3]), 2, axis=1),
    "normalize": lambda P, x: F(P).normalize(x, axis=1),
    "normalize_p1": lambda P, x: F(P).normalize(x, p=1, axis=0),
    "layer_norm_x": lambda P, x: F(P).layer_norm(x, (4,), None, None, 1e-5),
    "label_smooth": lambda P, x: F(P).label_smooth(F(P).softmax(x), 0.2),
}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
@pytest.mark.parametrize("which", ["xs", "unit"])
def test_activation_and_its_grad(name, which):
    x_np = XS if which == "xs" else UNIT
    fn = ACTIVATIONS[name]
    cot = np.random.RandomState(5).randn(*fn(
        ref, ref.to_tensor(x_np)).shape).astype(np.float32)

    def run(P):
        x = P.to_tensor(x_np, stop_gradient=False)
        out = fn(P, x)
        (out * P.to_tensor(cot)).sum().backward()
        return out.numpy(), out.dtype.name, x.grad.numpy()

    (w, wd, wg), (g, gd, gg) = run(ref), run(paddle)
    assert gd == wd
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gg, wg, rtol=GRAD_RTOL, atol=1e-6)


def _cot(k, shape):
    return np.asarray(np.random.RandomState(100 + k).randn(*shape),
                      np.float32)


def _run(P, fn, inputs, grad_idx):
    ts = []
    for i, a in enumerate(inputs):
        t = P.to_tensor(a)
        if i in grad_idx:
            t.stop_gradient = False
        ts.append(t)
    out = fn(P, *ts)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    values = [np.asarray(o.numpy()) for o in outs]
    dtypes = [o.dtype.name for o in outs]
    grads = []
    if grad_idx:
        total = None
        for k, o in enumerate(outs):
            if "float" in o.dtype.name and not o.stop_gradient:
                term = (o * P.to_tensor(_cot(k, o.shape))).sum()
                total = term if total is None else total + term
        total.backward()
        grads = [ts[i].grad.numpy() for i in grad_idx]
    return values, dtypes, grads


CASES = {
    "softmax_dtype": (lambda P, x: F(P).softmax(x, dtype="float64"),
                      [WIDE], [0]),
    "log_softmax_dtype_ignored": (lambda P, x: F(P).log_softmax(
        x, axis=0, dtype="float64"), [WIDE], [0]),
    "prelu_shared": (lambda P, x, w: F(P).prelu(x, w),
                     [IMG, np.array([0.2], np.float32)], [0, 1]),
    "prelu_channels": (lambda P, x, w: F(P).prelu(x, w),
                       [IMG, np.array([0.1, 0.2, 0.3, 0.4], np.float32)],
                       [0, 1]),
    "prelu_nhwc": (lambda P, x, w: F(P).prelu(x, w, data_format="NHWC"),
                   [IMG.transpose(0, 2, 3, 1).copy(),
                    np.array([0.1, 0.2, 0.3, 0.4], np.float32)], [0, 1]),
    "linear": (lambda P, x, w, b: F(P).linear(x, w, b),
               [SEQ, _rs.randn(8, 5).astype(np.float32),
                _rs.randn(5).astype(np.float32)], [0, 1, 2]),
    "linear_no_bias": (lambda P, x, w: F(P).linear(x, w),
                       [SEQ, _rs.randn(8, 3).astype(np.float32)], [0, 1]),
    "layer_norm_affine": (lambda P, x, w, b: F(P).layer_norm(x, 8, w, b),
                          [SEQ, _rs.randn(8).astype(np.float32),
                           _rs.randn(8).astype(np.float32)], [0, 1, 2]),
    "layer_norm_two_dims": (lambda P, x, w, b: F(P).layer_norm(
        x, [3, 8], w, b, epsilon=1e-3),
        [SEQ, _rs.randn(24).astype(np.float32),
         _rs.randn(24).astype(np.float32)], [0, 1, 2]),
    "layer_norm_default_shape": (lambda P, x: F(P).layer_norm(x), [SEQ],
                                 [0]),
    "embedding": (lambda P, i, w: F(P).embedding(i, w), [IDS, TABLE], [1]),
    "embedding_padding": (lambda P, i, w: F(P).embedding(i, w,
                                                         padding_idx=2),
                          [IDS, TABLE], [1]),
    "embedding_padding_neg": (lambda P, i, w: F(P).embedding(
        i, w, padding_idx=-1), [IDS, TABLE], [1]),
    "one_hot": (lambda P, i: F(P).one_hot(i, 7), [IDS], []),
    "one_hot_out_of_range": (lambda P, i: F(P).one_hot(i, 4), [IDS], []),
    "swce_hard": (lambda P, x, y: F(P).softmax_with_cross_entropy(x, y),
                  [LOGITS, LABELS[:, None]], [0]),
    "swce_ignored": (lambda P, x, y: F(P).softmax_with_cross_entropy(x, y),
                     [LOGITS, IGNORED], [0]),
    "swce_soft": (lambda P, x, y: F(P).softmax_with_cross_entropy(
        x, y, soft_label=True), [LOGITS, SOFT], [0, 1]),
    "swce_softmax": (lambda P, x, y: F(P).softmax_with_cross_entropy(
        x, y, return_softmax=True), [LOGITS, LABELS], [0]),
    "ce_mean": (lambda P, x, y: F(P).cross_entropy(x, y), [LOGITS, LABELS],
                [0]),
    "ce_ignored": (lambda P, x, y: F(P).cross_entropy(x, y),
                   [LOGITS, IGNORED], [0]),
    "ce_all_ignored": (lambda P, x, y: F(P).cross_entropy(x, y),
                       [LOGITS, np.full(6, -100, np.int64)], [0]),
    "ce_weight": (lambda P, x, y, w: F(P).cross_entropy(x, y, weight=w),
                  [LOGITS, LABELS, W5], [0]),
    "ce_weight_ignored": (lambda P, x, y, w: F(P).cross_entropy(
        x, y, weight=w, ignore_index=4), [LOGITS, LABELS, W5], [0]),
    "ce_sum": (lambda P, x, y: F(P).cross_entropy(x, y, reduction="sum"),
               [LOGITS, LABELS], [0]),
    "ce_none": (lambda P, x, y: F(P).cross_entropy(x, y, reduction="none"),
                [LOGITS, IGNORED], [0]),
    "ce_label_with_axis": (lambda P, x, y: F(P).cross_entropy(x, y),
                           [LOGITS, LABELS[:, None]], [0]),
    "ce_soft": (lambda P, x, y: F(P).cross_entropy(x, y, soft_label=True),
                [LOGITS, SOFT], [0, 1]),
    "ce_soft_weight": (lambda P, x, y, w: F(P).cross_entropy(
        x, y, weight=w, soft_label=True), [LOGITS, SOFT, W5], [0]),
    "ce_probs": (lambda P, x, y: F(P).cross_entropy(x, y,
                                                    use_softmax=False),
                 [PROBS, LABELS], [0]),
    "ce_axis1": (lambda P, x, y: F(P).cross_entropy(x, y, axis=1),
                 [_rs.randn(2, 5, 3).astype(np.float32),
                  _rs.randint(0, 5, (2, 3)).astype(np.int64)], [0]),
    "ce_3d_last_axis": (lambda P, x, y: F(P).cross_entropy(x, y),
                        [_rs.randn(2, 3, 5).astype(np.float32),
                         _rs.randint(0, 5, (2, 3)).astype(np.int64)], [0]),
    "mse": (lambda P, x, y: F(P).mse_loss(x, y), [XS, UNIT], [0, 1]),
    "mse_none": (lambda P, x, y: F(P).mse_loss(x, y, reduction="none"),
                 [XS, UNIT], [0]),
    "l1_sum": (lambda P, x, y: F(P).l1_loss(x, y, reduction="sum"),
               [XS, UNIT], [0, 1]),
    "smooth_l1": (lambda P, x, y: F(P).smooth_l1_loss(x, y), [XS, UNIT],
                  [0, 1]),
    "smooth_l1_delta": (lambda P, x, y: F(P).smooth_l1_loss(
        x, y, reduction="none", delta=0.5), [XS, UNIT], [0]),
    "bce": (lambda P, p, y: F(P).binary_cross_entropy(p, y), [POS, BIN],
            [0]),
    "bce_weight_none": (lambda P, p, y, w: F(P).binary_cross_entropy(
        p, y, weight=w, reduction="none"), [POS, BIN, POS[::-1].copy()],
        [0]),
    "bce_logits": (lambda P, x, y: F(P).binary_cross_entropy_with_logits(
        x, y, reduction="none"), [XS, BIN], [0]),
    "bce_logits_pos_weight": (
        lambda P, x, y, w: F(P).binary_cross_entropy_with_logits(
            x, y, pos_weight=w), [XS, BIN, np.array([1.0, 2.0, 0.5, 3.0],
                                                    np.float32)], [0]),
    "bce_logits_weight_sum": (
        lambda P, x, y, w: F(P).binary_cross_entropy_with_logits(
            x, y, weight=w, reduction="sum"), [XS, BIN, POS], [0]),
    "nll": (lambda P, x, y: F(P).nll_loss(F(P).log_softmax(x), y),
            [LOGITS, IGNORED], [0]),
    "nll_sum": (lambda P, x, y: F(P).nll_loss(x, y, reduction="sum"),
                [LOGITS, LABELS], [0]),
    "kl_div": (lambda P, x, y: F(P).kl_div(F(P).log_softmax(x), y),
               [LOGITS, SOFT], [0]),
    "kl_div_batchmean": (lambda P, x, y: F(P).kl_div(
        F(P).log_softmax(x), y, reduction="batchmean"), [LOGITS, SOFT],
        [0, 1]),
    "square_error_cost": (lambda P, x, y: F(P).square_error_cost(x, y),
                          [XS, UNIT], [0, 1]),
    "margin_ranking": (lambda P, x, y, z: F(P).margin_ranking_loss(
        x, y, z, margin=0.1), [XS, POS, np.sign(XS - POS)], [0, 1]),
    "cosine_similarity": (lambda P, a, b: F(P).cosine_similarity(a, b),
                          [SEQ, SEQ[::-1].copy()], [0, 1]),
    "cosine_similarity_axis": (lambda P, a, b: F(P).cosine_similarity(
        a, b, axis=-1), [SEQ, SEQ * 2 + 1], [0, 1]),
    "bilinear": (lambda P, a, b, w, c: F(P).bilinear(a, b, w, c),
                 [XS, UNIT[:, :3], _rs.randn(2, 4, 3).astype(np.float32),
                  _rs.randn(2).astype(np.float32)], [0, 1, 2, 3]),
    "log_loss": (lambda P, p, y: F(P).log_loss(p, y), [POS, BIN], [0]),
    "dice_loss": (lambda P, p, y: F(P).dice_loss(p, y),
                  [PROBS, LABELS[:, None]], [0]),
    "npair_loss": (lambda P, a, b, y: F(P).npair_loss(a, b, y),
                   [XS, UNIT, np.array([0, 1, 0], np.int64)], [0, 1]),
    "sigmoid_focal": (lambda P, x, y: F(P).sigmoid_focal_loss(x, y),
                      [XS, BIN], [0]),
    "sigmoid_focal_norm_mean": (lambda P, x, y, n: F(P).sigmoid_focal_loss(
        x, y, normalizer=n, gamma=1.5, reduction="mean"),
        [XS, BIN, np.array([3.0], np.float32)], [0]),
    "sdpa_causal": (lambda P, q, k, v: F(P).scaled_dot_product_attention(
        q, k, v, is_causal=True), [_rs.randn(1, 2, 5, 8).astype(np.float32)
                                   for _ in range(3)], [0, 1, 2]),
    "flash_attention": (lambda P, q, k, v: F(P).flash_attention(
        q, k, v, causal=False), [_rs.randn(2, 1, 4, 8).astype(np.float32)
                                 for _ in range(3)], [0, 1, 2]),
    "sdpa_mask": (lambda P, q, k, v, m: F(P).scaled_dot_product_attention(
        q, k, v, attn_mask=m), [_rs.randn(1, 2, 5, 8).astype(np.float32)
                                for _ in range(3)]
        + [_rs.randn(1, 1, 5, 5).astype(np.float32)], [0, 1, 2]),
    "diag_embed": (lambda P, x: F(P).diag_embed(x), [XS], []),
    "sequence_mask": (lambda P, n: F(P).sequence_mask(n, 5),
                      [np.array([0, 2, 5], np.int64)], []),
    "sequence_mask_default": (lambda P, n: F(P).sequence_mask(
        n, dtype="float32"), [np.array([[1, 3], [4, 2]], np.int64)], []),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_the_reference(name):
    fn, inputs, grad_idx = CASES[name]
    want, want_dt, want_g = _run(ref, fn, inputs, grad_idx)
    got, got_dt, got_g = _run(paddle, fn, inputs, grad_idx)
    assert got_dt == want_dt
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=1e-6)


@pytest.mark.parametrize("name", ["relu_", "elu_", "softmax_", "tanh_"])
def test_inplace_activations(name):
    def run(P):
        t = P.to_tensor(XS)
        out = getattr(F(P), name)(t)
        assert out is t
        return t.numpy()
    np.testing.assert_allclose(run(paddle), run(ref), rtol=RTOL, atol=ATOL)


def test_test_ops_nn_scenarios():
    """tests/test_ops.py::TestNNOps' softmax, layer_norm, ignored-label
    cross-entropy, BCE with logits and embedding padding goldens, in
    both packages."""
    rs = np.random.RandomState(7)
    x = rs.randn(3, 5)
    e = np.exp(x - x.max(1, keepdims=True))
    logits = rs.randn(4, 5)
    logp = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    z = (rs.rand(6) > 0.5).astype("float64")
    xb = rs.randn(6)
    for P in (ref, paddle):
        np.testing.assert_allclose(F(P).softmax(P.to_tensor(x)).numpy(),
                                   e / e.sum(1, keepdims=True), rtol=1e-5)
        y = rs.randn(2, 5)
        np.testing.assert_allclose(
            F(P).layer_norm(P.to_tensor(y), 5).numpy(),
            (y - y.mean(-1, keepdims=True))
            / np.sqrt(y.var(-1, keepdims=True) + 1e-5), rtol=1e-6)
        loss = F(P).cross_entropy(P.to_tensor(logits),
                                  P.to_tensor(np.array([1, -100, 2, -100])),
                                  ignore_index=-100)
        np.testing.assert_allclose(float(loss.numpy()),
                                   -(logp[0, 1] + logp[2, 2]) / 2, rtol=1e-5)
        out = F(P).binary_cross_entropy_with_logits(
            P.to_tensor(xb), P.to_tensor(z), reduction="none").numpy()
        np.testing.assert_allclose(
            out, np.maximum(xb, 0) - xb * z + np.log1p(np.exp(-np.abs(xb))),
            rtol=1e-6)
        w = P.to_tensor(rs.randn(5, 3).astype("float32"))
        emb = F(P).embedding(P.to_tensor(np.array([0, 2])), w, padding_idx=2)
        assert np.allclose(emb.numpy()[1], 0)


def test_cross_entropy_logits_grad():
    """test_op_grads_sweep.py::test_cross_entropy_logits and
    test_autograd.py::test_softmax_cross_entropy_grad: the grad of the
    mean cross-entropy, f64, against the reference's and the analytic
    (softmax - onehot) / n."""
    rs = np.random.RandomState(1)
    logits = rs.randn(4, 10)
    labels = rs.randint(0, 10, (4,))

    def run(P):
        x = P.to_tensor(logits, stop_gradient=False)
        F(P).cross_entropy(x, P.to_tensor(labels)).backward()
        return x.grad.numpy()

    got, want = run(paddle), run(ref)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    sm = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    np.testing.assert_allclose(got, (sm - np.eye(10)[labels]) / 4,
                               rtol=1e-10)


def test_embedding_weight_grad_scatter():
    """test_autograd.py::test_embedding_grad_scatter and
    test_op_grads_sweep.py::test_embedding_weight: the dense grad adds
    one row a lookup; with ``sparse=True`` the grad is row-sparse and
    sums to the same (tests/test_torch_sparse_grad.py)."""
    w_np = np.random.RandomState(2).randn(10, 4)
    for P in (ref, paddle):
        w = P.to_tensor(w_np, stop_gradient=False)
        F(P).embedding(P.to_tensor(np.array([1, 1, 3])), w).sum().backward()
        g = w.grad.numpy()
        assert g[1].sum() == pytest.approx(8.0)
        assert g[3].sum() == pytest.approx(4.0)
        assert g[0].sum() == 0
    w = paddle.to_tensor(w_np, stop_gradient=False)
    F(paddle).embedding(paddle.to_tensor(np.array([1, 1, 3])), w,
                        sparse=True).sum().backward()
    assert w.grad.is_sparse()
    np.testing.assert_array_equal(w.grad.numpy(), g)


# ---------------------------------------------------------------- dropout

def _keep_bound(n, p):
    return 6 * np.sqrt(p * (1 - p) / n)


def test_dropout_keep_rule_upscale_and_seed():
    """test_ops.py::test_dropout_train_eval's rules, with the keep share
    held to six binomial standard deviations of 1 - p."""
    n, p = 20000, 0.3
    for P in (ref, paddle):
        x = P.ones([n])
        P.seed(3)
        out = F(P).dropout(x, p=p, training=True).numpy()
        kept = out != 0
        assert abs(kept.mean() - (1 - p)) < _keep_bound(n, p)
        np.testing.assert_allclose(out[kept], 1 / (1 - p), rtol=1e-6)
        np.testing.assert_array_equal(
            F(P).dropout(x, p=p, training=False).numpy(), x.numpy())
        np.testing.assert_allclose(
            F(P).dropout(x, p=p, training=False,
                         mode="downscale_in_infer").numpy(), 1 - p)
        down = F(P).dropout(x, p=p, mode="downscale_in_infer").numpy()
        assert set(np.unique(down).tolist()) <= {0.0, 1.0}
    paddle.seed(3)
    a = F(paddle).dropout(paddle.ones([64]), 0.5).numpy()
    paddle.seed(3)
    np.testing.assert_array_equal(F(paddle).dropout(paddle.ones([64]),
                                                    0.5).numpy(), a)


def test_dropout_grad_follows_the_mask():
    x = paddle.to_tensor(np.ones(1000, np.float32), stop_gradient=False)
    out = F(paddle).dropout(x, p=0.4)
    out.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), out.numpy())


@pytest.mark.parametrize("fn,shape", [("dropout2d", (40, 50, 3, 2)),
                                      ("dropout3d", (40, 50, 2, 2, 2))])
def test_channel_dropout_drops_whole_channels(fn, shape):
    p = 0.25
    for P in (ref, paddle):
        out = getattr(F(P), fn)(P.ones(list(shape)), p=p).numpy()
        per = out.reshape(shape[0], shape[1], -1)
        # every channel is all kept (1 / (1 - p)) or all dropped
        assert np.all((per == 0).all(-1) | (per == 1 / (1 - p)).all(-1))
        keep = (per[..., 0] != 0).mean()
        assert abs(keep - (1 - p)) < _keep_bound(shape[0] * shape[1], p)
        np.testing.assert_array_equal(
            getattr(F(P), fn)(P.ones(list(shape)), p=p,
                              training=False).numpy(), 1.0)


def test_alpha_dropout_keeps_mean_and_variance():
    n, p = 40000, 0.2
    x_np = np.random.RandomState(4).randn(n).astype(np.float32)
    for P in (ref, paddle):
        P.seed(5)
        out = F(P).alpha_dropout(P.to_tensor(x_np), p=p).numpy()
        assert abs(out.mean()) < 0.05 and abs(out.std() - 1.0) < 0.05
        np.testing.assert_array_equal(
            F(P).alpha_dropout(P.to_tensor(x_np), p=p,
                               training=False).numpy(), x_np)


def test_dropout_on_torch_tensors_is_the_models_path():
    """The GPT's call (a torch tensor, an explicit generator) still draws
    the same mask as before, and the Tensor op the same from the same
    generator state."""
    x = torch.ones(512)
    g1 = torch.Generator().manual_seed(9)
    g2 = torch.Generator().manual_seed(9)
    a = paddle.ops.nn_ops.dropout(x, 0.3, training=True, generator=g1)
    b = F(paddle).dropout(paddle.to_tensor(x.numpy()), 0.3, generator=g2)
    assert isinstance(a, torch.Tensor)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
