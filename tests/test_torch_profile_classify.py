"""The port's profilers sort device kernels into classes by name
(``tools/profile_port_serving.py::classify``, which the training profiler
shares): every kernel of ``paddle_tpu_torch/csrc`` lands in its own
class, in both dtypes, and a library kernel does not."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from profile_port_serving import classify  # noqa: E402


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::flash_fwd_kernel<64>(float const*)",
     "K1 flash forward"),
    ("void (anonymous namespace)::flash_fwd_mma_kernel<64>(__nv_bfloat16 "
     "const*)", "K1 flash forward"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<__nv_bfloat16, 64>()",
     "K2 flash backward dQ"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<float, 128>()",
     "K3 flash backward dK/dV"),
    ("void (anonymous namespace)::flash_bwd_dq_f32_kernel<64>(float const*)",
     "K2 flash backward dQ"),
    ("void (anonymous namespace)::flash_bwd_dkv_f32_kernel<128>(float "
     "const*)", "K3 flash backward dK/dV"),
    ("_ZN45_GLOBAL__N__8bcb2f8f_12_flash_bwd_cu_a50b7cef23flash_bwd_dq_f32_"
     "kernelILi64EEEvPKfS2_S2_S2_S2_S2_Pfiffii", "K2 flash backward dQ"),
    ("void (anonymous namespace)::flash_fwd_f32_kernel<64, 4>(float "
     "const*)", "K1 flash forward"),
    ("_ZN42_GLOBAL__N__5e3a7c1b_12_flash_fwd_cu_0c8a2d4f20flash_fwd_f32_"
     "kernelILi64ELi1EEEvPKfS2_S2_PfS3_ifii", "K1 flash forward"),
    ("void (anonymous namespace)::paged_decode_kernel<float, 64>()",
     "K4 paged decode attention"),
    ("void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16, 128>("
     "__nv_bfloat16 const*)", "K4 paged decode attention"),
    ("void (anonymous namespace)::paged_decode_combine<float, 64>(float "
     "const*, int const*, float*, int, int, int, int, int, int)",
     "K4 paged decode attention"),
    ("_ZN45_GLOBAL__N__2f1c9e0a_15_paged_decode_cu_7d3b1e5a20paged_decode_"
     "combineI13__nv_bfloat16Li64EEEvPKfPKiPT_iiiiii",
     "K4 paged decode attention"),
    ("void (anonymous namespace)::fused_ce_fwd_kernel<long>(float const*)",
     "K5 fused CE forward"),
    ("void (anonymous namespace)::fused_ce_fwd_f32_kernel<int>(float "
     "const*)", "K5 fused CE forward"),
    ("void (anonymous namespace)::fused_ce_fwd_mma_kernel<long>("
     "__nv_bfloat16 const*)", "K5 fused CE forward"),
    ("void (anonymous namespace)::fused_ce_fwd_combine<int>(float const*)",
     "K5 fused CE forward"),
    ("void (anonymous namespace)::fused_ce_bwd_mma_kernel<long, true>()",
     "K6 fused CE dx"),
    ("void (anonymous namespace)::fused_ce_bwd_mma_kernel<long, false>()",
     "K7 fused CE dW"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "matmul (cuBLAS)"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>>()", "elementwise and copies"),
])
def test_classify_sorts_every_port_kernel(name, want):
    assert classify(name) == want
