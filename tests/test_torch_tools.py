"""The forward and train profilers' kernel grouping, and their refusal to run
without a CUDA device."""

import pytest
import torch

from editor_tpu_torch.tools import profile_forward as pf
from editor_tpu_torch.tools import profile_train as pt


@pytest.mark.parametrize("name, label", [
    ("attention_qkv_kernel(__nv_bfloat16 const*, ...)", "K1 attention_qkv"),
    ("rollout_chain_kernel(__nv_bfloat16 const*, float*, int, int, int)", "K2 rollout_chain"),
    ("masked_attention_kernel(__nv_bfloat16 const*, float const*, ...)", "K3 masked_attention"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "patch conv (cuDNN)"),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopB_TNN", "GEMM (cuBLAS)"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm>", "GEMM (cuBLAS)"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float>",
     "LayerNorm"),
    ("void at::native::vectorized_elementwise_kernel<4, GeluCUDAKernelImpl>", "GELU"),
    ("void editor_kernels::attention_bwd_kernel<false>(__nv_bfloat16 const*, ...)",
     "K4 attention_qkv_bwd"),
    ("void editor_kernels::attention_bwd_kernel<true>(__nv_bfloat16 const*, ...)",
     "K5 masked_attention_bwd"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<TensorListMetadata<3>>",
     "optimizer (foreach)"),
    ("sm90_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "patch conv (cuDNN)"),
    ("void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernel<float, float>",
     "LayerNorm"),
    ("void editor_kernels::(anonymous namespace)::masked_attention_tiled_kernel(...)",
     "K6 masked_attention_tiled"),
    ("void editor_kernels::(anonymous namespace)::masked_attention_tiled_bwd_kernel(...)",
     "K7 masked_attention_tiled_bwd"),
    ("void editor_kernels::(anonymous namespace)::masked_attention_kernel(...)",
     "K3 masked_attention"),
    ("void editor_kernels::(anonymous namespace)::ln_matmul_kernel(...)", "K8 ln_matmul"),
    # a dtype conversion is not a convolution
    ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda, convert>",
     pf.OTHER),
])
def test_kernel_categories(name, label):
    assert pf.category(name) == label


@pytest.mark.parametrize("main", [pf.main, pt.main], ids=["forward", "train"])
def test_exits_without_cuda(monkeypatch, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        main([])
    assert exc.value.code != 0
