"""The plain versions of the fused linear cross-entropy kernels (K5 loss
and LSE; K6 dx; K7 dW) in paddle_tpu_torch against both oracles of the
JAX reference on the CPU: the XLA composition ``_reference`` with
``jax.vjp`` at odd shapes, and the Pallas kernels themselves in
interpret mode at the shapes ``_use_pallas`` accepts. Then the port's
autograd function against ``torch.autograd`` through the plain
composition, an all-ignored batch, and the AMP cast in front of K5.
Inputs are numpy arrays from a seed, handed to both packages.

Tolerances:
- f32: loss and LSE atol/rtol 1e-5 (sums over H = 48-128 products and
  a logsumexp over <= 2048 logits of O(1), in another order); grads
  atol 2e-6, rtol 1e-4 (dW sums over up to 256 tokens of terms near
  1e-3);
- bf16 against the Pallas kernels: the same bf16 inputs on both sides,
  but the Pallas backward rounds d to bf16 before its two products
  (fused_ce.py:195, :211) where the port keeps d f32, and both round
  the grads to bf16 at the end: grads within 1e-2 of each one's largest
  |grad| (two bf16 roundings, 2 x 2^-9 each, plus sums of rounded
  terms); the loss and LSE are f32 on both sides (atol/rtol 1e-5);
- bf16 with d rounded to bf16 on both sides (the plain backward's
  ``d_dtype=torch.bfloat16``, the Pallas kernels' own arithmetic): grads
  within 4e-3 of the largest |grad|, one bf16 ulp (2^-8) at the largest
  grad. What remains is the order of the f32 sums and the final bf16
  rounding of each side, which may land one ulp apart.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops import fused_ce as jce
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.ops import fused_ce as tce

F32 = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=2e-6, rtol=1e-4)
IGNORE = -100


@pytest.fixture
def interpret_kernels():
    jce._FORCE_INTERPRET[0] = True
    yield
    jce._FORCE_INTERPRET[0] = False


def _inputs(seed, t, h, v, ignored=0.2, scale=0.5):
    """x [t, h], W [v, h] f32 and int64 labels in range with a share
    ``ignored`` of ignore_index rows, plus a per-token cotangent g."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(t, h) * scale).astype(np.float32)
    w = (rs.randn(v, h) * scale).astype(np.float32)
    labels = rs.randint(0, v, t).astype(np.int64)
    labels[rs.rand(t) < ignored] = IGNORE
    g = (rs.rand(t) + 0.5).astype(np.float32) / t
    return x, w, labels, g


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("t,h,v", [(37, 48, 211), (5, 3, 7), (64, 64, 130)])
def test_plain_matches_reference_composition_and_vjp(t, h, v):
    """Loss of K5's plain version equals ``_reference``; dx and dW of the
    plain backward equal ``jax.vjp`` of it for the same cotangent, at
    ragged shapes with ignored rows."""
    x, w, labels, g = _inputs(t, t, h, v)
    jx, jw, jl = jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels)
    ref, vjp = jax.vjp(lambda a, b: jce._reference(a, b, jl, IGNORE), jx, jw)
    rdx, rdw = vjp(jnp.asarray(g))
    tx, tw, tl, tg = _t(x, w, labels, g)
    loss, lse = tce.fused_linear_cross_entropy_plain(tx, tw, tl, IGNORE)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref), **F32)
    assert (loss.numpy()[labels == IGNORE] == 0).all()
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax.scipy.special.logsumexp(jx @ jw.T, -1)),
        **F32)
    dx, dw = tce.fused_linear_cross_entropy_backward_plain(tx, tw, tl, lse,
                                                           tg, IGNORE)
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), **GRAD)
    np.testing.assert_allclose(dw.numpy(), np.asarray(rdw), **GRAD)
    # the wrappers take the plain versions for CPU tensors
    torch.testing.assert_close(tce.fused_ce_bwd_dx(tx, tw, tl, lse, tg), dx)
    torch.testing.assert_close(tce.fused_ce_bwd_dw(tx, tw, tl, lse, tg), dw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,h,v", [(256, 128, 2048), (128, 256, 1024)])
def test_plain_matches_pallas_interpret(interpret_kernels, dtype, t, h, v):
    """K5's plain version against ``_pallas_fwd`` and K6/K7's against
    ``_pallas_bwd``, the Pallas kernels run in interpret mode (two vocab
    tiles of 1024 at V = 2048), fed the same inputs in f32 and bf16."""
    x, w, labels, g = _inputs(3, t, h, v)
    jdt = getattr(jnp, dtype)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    jl = jnp.asarray(labels)
    assert jce._use_pallas(jx, jw)
    jloss, jlse = jce._pallas_fwd(jx, jw, jl, IGNORE)
    jdx, jdw = jce._pallas_bwd(jx, jw, jl, jlse, jnp.asarray(g), IGNORE)
    tdt = getattr(torch, dtype)
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
              for a in (jx, jw))
    tl, tg = _t(labels, g)
    loss, lse = tce.fused_ce_forward(tx, tw, tl, IGNORE)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **F32)
    dx = tce.fused_ce_bwd_dx(tx, tw, tl, lse, tg, IGNORE)
    dw = tce.fused_ce_bwd_dw(tx, tw, tl, lse, tg, IGNORE)
    assert dx.dtype == tdt and dw.dtype == tdt
    for got, want in ((dx, jdx), (dw, jdw)):
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **GRAD)
        else:
            err = np.abs(got - want).max()
            assert err <= 1e-2 * np.abs(want).max(), err


BF16_D_TOL = 4e-3


@pytest.mark.parametrize("t,h,v", [(256, 128, 2048), (128, 256, 1024),
                                   (256, 64, 2048)])
def test_plain_bf16_d_matches_pallas_interpret(interpret_kernels, t, h, v):
    """The plain backward with ``d_dtype=torch.bfloat16`` rounds d as
    ``_pallas_bwd`` does before both products, so in bf16 it meets the
    Pallas kernels (interpret mode) within one bf16 ulp of the largest
    grad, closer than the f32-d default does."""
    x, w, labels, g = _inputs(3 + h, t, h, v)
    jx, jw = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w))
    jl = jnp.asarray(labels)
    _, jlse = jce._pallas_fwd(jx, jw, jl, IGNORE)
    jdx, jdw = jce._pallas_bwd(jx, jw, jl, jlse, jnp.asarray(g), IGNORE)
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
              for a in (jx, jw))
    tl, tg = _t(labels, g)
    _, lse = tce.fused_ce_forward(tx, tw, tl, IGNORE)
    errs = {}
    for d_dtype in (None, torch.bfloat16):
        grads = tce.fused_linear_cross_entropy_backward_plain(
            tx, tw, tl, lse, tg, IGNORE, d_dtype=d_dtype)
        for name, got, want in zip(("dx", "dW"), grads, (jdx, jdw)):
            assert got.dtype == torch.bfloat16
            want = np.asarray(want.astype(jnp.float32))
            err = np.abs(got.float().numpy() - want).max()
            errs[(d_dtype, name)] = err / np.abs(want).max()
    for name in ("dx", "dW"):
        assert errs[(torch.bfloat16, name)] <= BF16_D_TOL, errs
        assert errs[(torch.bfloat16, name)] <= errs[(None, name)], errs


def _plain_autograd_loss(x, w, labels):
    return torch.nn.functional.cross_entropy(
        x @ w.t(), labels, ignore_index=IGNORE, reduction="none")


@pytest.mark.parametrize("kind", ["some_ignored", "all_ignored"])
def test_autograd_function_matches_torch_autograd(kind):
    """``fused_linear_cross_entropy`` under autograd (K5 forward, K6/K7
    backward from the saved LSE; plain versions on the CPU) gives the
    loss and grads of ``torch.autograd`` through the plain composition;
    an all-ignored batch loses 0 with zero grads."""
    x, w, labels, g = _inputs(9, 37, 48, 211,
                              ignored=1.1 if kind == "all_ignored" else 0.2)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w)]
    ref_leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in (x, w)]
    tl, tg = _t(labels, g)
    loss = tce.fused_linear_cross_entropy(*leaves, tl)
    ref = _plain_autograd_loss(*ref_leaves, tl)
    torch.testing.assert_close(loss, ref, **F32)
    (loss * tg).sum().backward()
    (ref * tg).sum().backward()
    for a, b in zip(leaves, ref_leaves):
        torch.testing.assert_close(a.grad, b.grad, **GRAD)
    if kind == "all_ignored":
        assert not loss.any()
        assert not leaves[0].grad.any() and not leaves[1].grad.any()


@pytest.mark.parametrize("level,black,want", [
    ("O1", None, torch.bfloat16), ("O2", None, torch.bfloat16),
    ("O0", None, torch.float32),
    ("O1", ["fused_linear_cross_entropy"], torch.float32)])
def test_amp_casts_the_inputs_of_k5(monkeypatch, level, black, want):
    """Under ``auto_cast`` x and W reach K5 in the reference's dtype for
    the op (white list: bf16 under O1 and O2; as they come under O0 or
    when the caller black-lists it), the loss stays f32 and the grads
    come back in the leaves' f32."""
    seen = []
    real = tce.fused_ce_forward

    def spy(x, w, labels, ignore_index):
        seen.append((x.dtype, w.dtype))
        return real(x, w, labels, ignore_index)

    monkeypatch.setattr(tce, "fused_ce_forward", spy)
    x, w, labels, _ = _inputs(1, 16, 32, 50)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w)]
    with tamp.auto_cast(level=level, custom_black_list=black):
        loss = tce.fused_linear_cross_entropy(*leaves,
                                              torch.from_numpy(labels))
    assert seen == [(want, want)] and loss.dtype == torch.float32
    loss.sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in leaves)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sweep", ["tokens", "vocab"])
def test_vocab_split_walks_every_vocab_tile_once(dtype, sweep):
    """K5's vocab split as the wrapper computes it for a card of 132 SMs
    (an H100 SXM), at every T = 1 .. 8192 (V at tile edges and the GPT
    vocabularies) and every V = 7 .. 50304 (T at tile edges and the
    flagship's 8192): the splits of ``per`` tiles, the last cut at the
    vocab's end as the kernels cut it, walk every vocab tile exactly once,
    none is empty, and the grid's second dimension fits CUDA's limit."""
    tile, per_sm = tce._FWD_SPLIT[dtype]
    if sweep == "tokens":
        pairs = [(t, v) for v in (7, tile - 1, tile, tile + 1, 1000, 50257,
                                  50304) for t in range(1, 8193)]
    else:
        pairs = [(t, v) for t in (1, tile - 1, tile, tile + 1, 1000, 8192)
                 for v in range(7, 50305)]
    for t, v in pairs:
        nsplit, per = tce.vocab_split(t, v, tile, per_sm, 132)
        n_vt = -(-v // tile)
        assert nsplit >= 1 and per >= 1 and nsplit <= 65535, (t, v)
        # split s walks tiles [s per, min(n_vt, (s + 1) per)): together
        # they cover [0, n_vt) once, and the last one starts inside it
        assert (nsplit - 1) * per < n_vt <= nsplit * per, (t, v, nsplit,
                                                           per)
