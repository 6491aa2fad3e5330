"""The plain version of the flash-attention backward kernels (K2 dQ, K3
dK/dV) in paddle_tpu_torch against the JAX reference on the CPU: against
the Pallas backward kernels themselves in interpret mode (one block and
several blocks of 128 rows, causal and not), against ``jax.vjp`` of the
XLA composition at a ragged shape, and through the port's autograd
function, which on CPU tensors runs the plain versions.

Tolerance: atol 2e-5 and rtol 1e-4 in f32. Both sides compute the same
f32 products and differ only in the order of their sums; dK and dV sum
over up to 384 query rows, so values near zero carry an absolute error
of a few 1e-6.

bf16 inputs: the plain version that rounds P and dS to bf16 where the
Pallas kernels round them (``p_dtype=torch.bfloat16``) is held within
5e-3 of the largest grad (a grad that rounds to the other bf16 neighbour
is one ulp off, 2^-9 = 2.0e-3 of a largest grad of 0.97 at an element of
0.3), with at most 0.1 % of the elements more than one bf16 ulp (2^-7 of
the element) from the Pallas kernels' (an exp or a sum in another order
rounds an element of P or dS the other way now and then); the plain
version that keeps them in f32 must miss that mark (more than 5 % of the
elements beyond one ulp), so the test sees the rounding. Elements below
1e-3 of the largest grad are left out of that count: there dS = P (dP -
delta) cancels to its f32 rounding (row 0 of a causal dQ is all such).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops import attention as jattn
from paddle_tpu_torch.ops import attention as tattn

TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture
def interpret_flash():
    jattn._FORCE_INTERPRET[0] = True
    yield
    jattn._FORCE_INTERPRET[0] = False


def _inputs(seed, shape):
    """q, k, v, dO as numpy f32 arrays."""
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(4)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,block", [((2, 4, 256, 32), 512),
                                         ((1, 2, 384, 32), 128)])
def test_plain_backward_matches_pallas_interpret(interpret_flash,
                                                 monkeypatch, causal, shape,
                                                 block):
    """dq, dk, dv of the port's plain K2/K3 equal the Pallas backward
    kernels run in interpret mode, fed the same O and LSE; block 128 at
    s = 384 makes the reference walk three blocks each way (its causal
    block skip included)."""
    monkeypatch.setattr(jattn, "_BLOCK_BWD", block)
    q, k, v, do = _inputs(0, shape)
    scale = 1.0 / np.sqrt(shape[-1])
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jattn._pallas_flash_fwd(jq, jk, jv, scale, causal)
    ref = jattn._pallas_flash_bwd(jq, jk, jv, jo, jlse, jdo, scale, causal)
    tq, tk, tv, tdo, to, tlse = _t(q, k, v, do, jo, jlse)
    got = tattn.flash_attention_backward(tq, tk, tv, to, tlse, tdo, scale,
                                         causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.float32 and tuple(a.shape) == shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_reference_vjp_ragged(causal):
    """At a ragged [1, 2, 37, 16] the plain backward, fed the plain
    forward's O and LSE, equals ``jax.vjp`` of ``_reference_attention``."""
    shape = (1, 2, 37, 16)
    q, k, v, do = _inputs(1, shape)
    scale = 1.0 / np.sqrt(16)
    _, vjp = jax.vjp(lambda a, b, c: jattn._reference_attention(
        a, b, c, None, scale, causal), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = tattn.flash_attention_plain(tq, tk, tv, scale, causal)
    got = tattn.flash_attention_backward(tq, tk, tv, o, lse, tdo, scale,
                                         causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(2, 4, 256, 32), (1, 2, 37, 16)])
def test_cpu_autograd_function_gives_plain_grads(shape):
    """``scaled_dot_product_attention`` on CPU tensors goes through the
    flash autograd function: its grads are the plain backward's, bit for
    bit, and agree with ``jax.vjp`` of the reference; the wrappers count
    no launch on the CPU."""
    q, k, v, do = _inputs(2, shape)
    scale = 1.0 / np.sqrt(shape[-1])
    tq, tk, tv, tdo = (t.requires_grad_(i < 3)
                       for i, t in enumerate(_t(q, k, v, do)))
    n2, n3 = tattn.flash_bwd_dq.launches, tattn.flash_bwd_dkv.launches
    out = tattn.scaled_dot_product_attention(tq, tk, tv, is_causal=True)
    out.backward(tdo)
    with torch.no_grad():
        o, lse = tattn.flash_attention_plain(tq, tk, tv, scale, True)
        delta = (tdo * o).sum(-1)[:, :, None, :]
        plain = tattn.flash_attention_backward_plain(tq, tk, tv, lse, tdo,
                                                     delta, scale, True)
    _, vjp = jax.vjp(lambda a, b, c: jattn._reference_attention(
        a, b, c, None, scale, True), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    for t, p, r in zip((tq, tk, tv), plain, ref):
        assert torch.equal(t.grad, p)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **TOL)
    assert tattn.flash_bwd_dq.launches == n2
    assert tattn.flash_bwd_dkv.launches == n3


def test_strided_grad_reaches_the_backward_contiguous():
    """The model hands the attention output through transpose/reshape,
    so the grad arrives strided; the backward gives the same grads as
    for a contiguous one."""
    q, k, v, _ = _inputs(3, (1, 2, 20, 8))
    grads = []
    for strided in (False, True):
        tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
        out = tattn.scaled_dot_product_attention(tq, tk, tv, is_causal=True)
        if strided:
            loss = (out.transpose(1, 2).reshape(1, 20, 16) ** 2).sum()
        else:
            loss = (out ** 2).sum()
        loss.backward()
        grads.append([t.grad for t in (tq, tk, tv)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


BF16_ULP = 2.0 ** -7


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,block", [((1, 2, 256, 64), 128),
                                         ((2, 4, 256, 32), 512)])
def test_plain_backward_rounding_p_and_ds_matches_pallas_bf16(
        interpret_flash, monkeypatch, causal, shape, block):
    """bf16 q, k, v, dO through the Pallas forward and backward kernels
    in interpret mode, and through the plain backward fed the same LSE
    and delta: with ``p_dtype=torch.bfloat16`` its grads are the Pallas
    kernels' to within a stray rounding; with P and dS kept f32 they are
    not."""
    monkeypatch.setattr(jattn, "_BLOCK_BWD", block)
    q, k, v, do = (jnp.asarray(a).astype(jnp.bfloat16)
                   for a in _inputs(4, shape))
    scale = 1.0 / np.sqrt(shape[-1])
    jo, jlse = jattn._pallas_flash_fwd(q, k, v, scale, causal)
    ref = [np.asarray(g.astype(jnp.float32)) for g in
           jattn._pallas_flash_bwd(q, k, v, jo, jlse, do, scale, causal)]
    tq, tk, tv, tdo = (t.to(torch.bfloat16) for t in _t(*(
        a.astype(jnp.float32) for a in (q, k, v, do))))
    # delta as the reference computes it outside its kernels
    delta = jnp.sum(do.astype(jnp.float32) * jo.astype(jnp.float32),
                    axis=-1)[:, :, None, :]
    tlse, tdelta = _t(jlse, delta)
    beyond = {}
    for p_dtype in (torch.bfloat16, None):
        got = tattn.flash_attention_backward_plain(
            tq, tk, tv, tlse, tdo, tdelta, scale, causal, p_dtype=p_dtype)
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            assert a.dtype == torch.bfloat16 and tuple(a.shape) == shape
            diff = np.abs(a.float().numpy() - b)
            top = np.abs(b).max()
            beyond[p_dtype, name] = np.mean(
                (diff > BF16_ULP * np.abs(b)) & (np.abs(b) >= 1e-3 * top))
            if p_dtype is not None:
                assert diff.max() <= 5e-3 * top, name
    for name in ("dq", "dk", "dv"):
        assert beyond[torch.bfloat16, name] <= 1e-3, (name, beyond)
        assert beyond[None, name] > 0.05, (name, beyond)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_p_dtype_f32_gives_the_same_bits(dtype, causal):
    """``p_dtype=torch.float32`` rounds nothing: the grads are those of
    ``p_dtype=None``, bit for bit, for f32 and bf16 inputs."""
    q, k, v, do = (t.to(dtype) for t in _t(*_inputs(5, (1, 3, 70, 16))))
    o, lse = tattn.flash_attention_plain(q, k, v, 0.25, causal)
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    args = (q, k, v, lse, do, delta, 0.25, causal)
    for a, b in zip(tattn.flash_attention_backward_plain(*args),
                    tattn.flash_attention_backward_plain(
                        *args, p_dtype=torch.float32)):
        assert torch.equal(a, b)
