"""paddle_tpu_torch's CUDA kernels on the card, against their plain
PyTorch versions on the same inputs. Marked ``cuda``: without a CUDA
device every test skips. On a machine with a card and no JAX, run them
without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: 1e-5 (K4) and 2e-5 (K1) in f32, where only the summation
order differs; 2e-2 for bf16 inputs, whose outputs are rounded to bf16.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import attention as attn
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


def test_flash_kernel_rejects_and_has_no_backward(dev):
    q = torch.randn(1, 2, 16, 96, device=dev)
    with pytest.raises(ValueError):
        attn.flash_attention_forward(q, q, q, 0.1, True)
    q = torch.randn(1, 2, 16, 64, device=dev, requires_grad=True)
    out = attn.scaled_dot_product_attention(q, q.detach(), q.detach(),
                                            is_causal=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()
    with pytest.raises(NotImplementedError):
        attn.scaled_dot_product_attention(q, q, q, attn_mask=q[0, 0])


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
