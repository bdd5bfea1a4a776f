"""The forward and train profilers' kernel grouping, the refusal of the
profilers and the design-variant tools to run without a CUDA device,
kernel_sass's reading of ptxas and cuobjdump output, and the bf16 ulp and
K1 comparison helpers of _bench and kernel_digest."""

import pytest
import torch

from editor_tpu_torch.tools import (bench_attn, bench_attn2, bench_attn_layer,
                                    bench_full_kernel, bench_rollout, bench_rollout2,
                                    kernel_digest)
from editor_tpu_torch.tools import profile_forward as pf
from editor_tpu_torch.tools import profile_train as pt


@pytest.mark.parametrize("name, label", [
    ("attention_fwd_mma_kernel<FwdForm::kQkv, 4, 9, true>(__nv_bfloat16 const*, ...)",
     "K1 attention_qkv"),
    ("rollout_chain_kernel(__nv_bfloat16 const*, float*, int, int, int)", "K2 rollout_chain"),
    ("attention_fwd_mma_kernel<(FwdForm)1, 4, 9, false>(__nv_bfloat16 const*, float const*, ...)",
     "K3 masked_attention"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "patch conv (cuDNN)"),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopB_TNN", "GEMM (cuBLAS)"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm>", "GEMM (cuBLAS)"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float>",
     "LayerNorm"),
    ("void at::native::vectorized_elementwise_kernel<4, GeluCUDAKernelImpl>", "GELU"),
    ("void editor_kernels::(anonymous namespace)::attention_bwd_mma_kernel<"
     "(editor_kernels::(anonymous namespace)::BwdForm)0, 4, 9, true>(__nv_bfloat16 const*, ...)",
     "K4 attention_qkv_bwd"),
    ("void editor_kernels::(anonymous namespace)::attention_bwd_mma_kernel<"
     "(editor_kernels::(anonymous namespace)::BwdForm)2, 4, 9, true>(__nv_bfloat16 const*, ...)",
     "K5 masked_attention_bwd"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<TensorListMetadata<3>>",
     "optimizer (foreach)"),
    ("sm90_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "patch conv (cuDNN)"),
    ("void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernel<float, float>",
     "LayerNorm"),
    ("void editor_kernels::(anonymous namespace)::attention_fwd_mma_kernel<"
     "(editor_kernels::(anonymous namespace)::FwdForm)2, 4, 9, false>(...)",
     "K6 masked_attention_tiled"),
    ("void editor_kernels::(anonymous namespace)::attention_bwd_mma_kernel<"
     "(editor_kernels::(anonymous namespace)::BwdForm)1, 2, 9, true>(...)",
     "K7 masked_attention_tiled_bwd"),
    ("void editor_kernels::(anonymous namespace)::attention_fwd_mma_kernel<"
     "editor_kernels::(anonymous namespace)::FwdForm::kFull, 4, 9, true>(...)",
     "K3 masked_attention"),
    ("void editor_kernels::(anonymous namespace)::ln_matmul_kernel(...)", "K8 ln_matmul"),
    # K4's chunked and resident instances, the enum argument by name; the
    # walk kernels of T6 (K3's and K5's forms) and of K6's group sweep
    ("void editor_kernels::(anonymous namespace)::attention_bwd_mma_kernel<"
     "BwdForm::kQkv, 8, 2, false>(__nv_bfloat16 const*, ...)", "K4 attention_qkv_bwd"),
    ("void editor_kernels::(anonymous namespace)::attention_bwd_mma_kernel<"
     "(BwdForm)0, 4, 9, true>(__nv_bfloat16 const*, ...)", "K4 attention_qkv_bwd"),
    ("void editor_kernels::(anonymous namespace)::attention_bwd_mma_walk_kernel<"
     "(editor_kernels::(anonymous namespace)::BwdForm)2, 4, 2, false>(__nv_bfloat16 const*, "
     "...)", "K5 masked_attention_bwd"),
    ("void editor_kernels::(anonymous namespace)::attention_fwd_mma_walk_kernel<"
     "(editor_kernels::(anonymous namespace)::FwdForm)1, 4, 9, true>(...)",
     "K3 masked_attention"),
    ("void editor_kernels::(anonymous namespace)::attention_fwd_mma_walk_kernel<"
     "FwdForm::kTiled, 4, 9, false>(...)", "K6 masked_attention_tiled"),
    ("void editor_kernels::(anonymous namespace)::attention_bwd_mma_kernel<"
     "BwdForm::kTiled, 8, 5, true>(...)", "K7 masked_attention_tiled_bwd"),
    # K7 and K5 on the tensor cores: the form, head-dim tiles, key tiles and
    # the resident form are template arguments; not each other's category
    ("void editor_kernels::(anonymous namespace)::attention_bwd_mma_kernel<"
     "(editor_kernels::(anonymous namespace)::BwdForm)1, 4, 9, true>"
     "(__nv_bfloat16 const*, float const*, __nv_bfloat16 const*, __nv_bfloat16*, "
     "__nv_bfloat16*, __nv_bfloat16*, int, int, float, float, int)",
     "K7 masked_attention_tiled_bwd"),
    ("void editor_kernels::(anonymous namespace)::attention_bwd_mma_kernel<"
     "(editor_kernels::(anonymous namespace)::BwdForm)2, 4, 2, false>(...)",
     "K5 masked_attention_bwd"),
    # K1, K3 and K6 on the tensor cores: the form (an enum argument,
    # demangled as "(...FwdForm)0" or by name), head-dim tiles, key tiles and
    # the resident form are template arguments; not each other's category
    ("void editor_kernels::(anonymous namespace)::attention_fwd_mma_kernel<"
     "(editor_kernels::(anonymous namespace)::FwdForm)0, 4, 9, true>"
     "(__nv_bfloat16 const*, float const*, __nv_bfloat16*, __nv_bfloat16*, int, int, float, "
     "float, int, int, int, int, int)", "K1 attention_qkv"),
    ("void editor_kernels::(anonymous namespace)::attention_fwd_mma_kernel<"
     "FwdForm::kTiled, 8, 5, false>(...)", "K6 masked_attention_tiled"),
    # the design variants T1-T5
    # T2 and T1 on K1's tensor-core body: the forms kNoMax and kSplit
    ("void editor_kernels::(anonymous namespace)::attention_fwd_mma_kernel<"
     "(editor_kernels::(anonymous namespace)::FwdForm)3, 4, 9, true>(__nv_bfloat16 const*, "
     "float const*, __nv_bfloat16*, __nv_bfloat16*, int, int, float, float, int, int, int, "
     "int, int, editor_kernels::(anonymous namespace)::FwdWalk)", "T1/T2 attention variants"),
    ("void editor_kernels::(anonymous namespace)::attention_fwd_mma_kernel<"
     "(editor_kernels::(anonymous namespace)::FwdForm)4, 8, 5, false>(...)",
     "T1/T2 attention variants"),
    ("void editor_kernels::(anonymous namespace)::attention_fwd_mma_kernel<"
     "FwdForm::kNoMax, 4, 9, false>(...)", "T1/T2 attention variants"),
    ("void editor_kernels::(anonymous namespace)::attention_fwd_mma_kernel<"
     "FwdForm::kSplit, 2, 9, true>(...)", "T1/T2 attention variants"),
    ("void editor_kernels::(anonymous namespace)::attn_layer_kernel(...)", "T3 attn_layer"),
    ("void editor_kernels::(anonymous namespace)::rollout_variant_kernel<true, 2>(...)",
     "T4 rollout variants"),
    ("void editor_kernels::(anonymous namespace)::rollout_rows_kernel<1>(...)",
     "T4 rollout variants"),
    ("void editor_kernels::(anonymous namespace)::rollout_multi_kernel<4>(...)",
     "T5 rollout_multi"),
    ("void editor_kernels::(anonymous namespace)::rollout_chain_kernel(...)",
     "K2 rollout_chain"),
    # a dtype conversion is not a convolution
    ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda, convert>",
     pf.OTHER),
])
def test_kernel_categories(name, label):
    assert pf.category(name) == label


@pytest.mark.parametrize("main", [pf.main, pt.main, bench_attn.main, bench_attn2.main,
                                  bench_attn_layer.main, bench_rollout.main,
                                  bench_rollout2.main, bench_full_kernel.main,
                                  kernel_digest.main],
                         ids=["forward", "train", "bench_attn", "bench_attn2",
                              "bench_attn_layer", "bench_rollout", "bench_rollout2",
                              "bench_full_kernel", "kernel_digest"])
def test_exits_without_cuda(monkeypatch, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        main([])
    assert exc.value.code != 0


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z20attention_qkv_kernelPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _Z20attention_qkv_kernelPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z20rollout_chain_kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z20rollout_chain_kernelv
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 26 registers, used 1 barriers, 4128 bytes smem
"""
SASS = """\
\tcode for sm_90a
\t\tFunction : _Z20rollout_chain_kernelv
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/              @!P0 BRA `(.L_x_1) ;                 /* 0x0000000000088947 */
        /*0020*/                   FFMA R0, R2, R3, R0 ;           /* 0x0000000302007223 */
        /*0030*/               @P1 LDG.E.U16 R4, desc[UR4][R2.64] ; /* 0x0000000402041981 */
        /*0040*/                   FFMA.FTZ R5, R2, R3, R5 ;       /* 0x0000000302057223 */
\t\tFunction : _Z20attention_qkv_kernelPK13__nv_bfloat16
        /*0000*/                   EXIT ;                          /* 0x000000000000794d */
"""


def test_kernel_sass_reads_ptxas_and_sass():
    from editor_tpu_torch.tools import kernel_sass

    info = kernel_sass.ptxas_info(PTXAS_LOG)
    assert info["_Z20attention_qkv_kernelPK13__nv_bfloat16"] == dict(
        spill_stores=0, spill_loads=0, registers=32, smem=0)
    assert info["_Z20rollout_chain_kernelv"] == dict(
        spill_stores=8, spill_loads=4, registers=26, smem=4128)
    ops = kernel_sass.sass_opcodes(SASS)
    assert ops["_Z20rollout_chain_kernelv"] == {"LDC": 1, "BRA": 1, "FFMA": 2, "LDG": 1}
    assert ops["_Z20attention_qkv_kernelPK13__nv_bfloat16"] == {"EXIT": 1}


def test_kernel_sass_demangle_without_cufilt(tmp_path):
    from editor_tpu_torch.tools import kernel_sass

    names = ["_Z20rollout_chain_kernelv"]
    assert kernel_sass.demangle(names, str(tmp_path / "cu++filt")) == {names[0]: names[0]}
    assert kernel_sass.demangle([], str(tmp_path / "cu++filt")) == {}


def test_bf16_ulp():
    from editor_tpu_torch.tools import _bench

    t = torch.tensor([1.0, 1.5, 0.75, -3.0, 0.0, 2.0 ** -20])
    assert _bench.bf16_ulp(t).tolist() == [2.0 ** -7, 2.0 ** -7, 2.0 ** -8, 2.0 ** -6, 0.0,
                                           2.0 ** -27]


def test_kernel_digest_diff(tmp_path):
    """--diff of two checkouts' saved K1 tensors: the largest difference, the
    share of elements that differ and the largest difference in bf16 ulps."""
    a = torch.tensor([[1.0, 0.5], [0.25, 0.0]]).bfloat16()
    b = a.clone()
    b[0, 0] = 1.0078125  # one bf16 step above 1
    torch.save({"out": a, "probs": a}, tmp_path / "a.pt")
    torch.save({"out": b, "probs": a}, tmp_path / "b.pt")
    res = kernel_digest.diff(str(tmp_path / "a.pt"), str(tmp_path / "b.pt"))
    assert res["out"] == dict(max_abs=0.0078125, share_differing=0.25, max_bf16_ulps=1.0,
                              share_over_one_ulp=0.0)
    assert res["probs"] == dict(max_abs=0.0, share_differing=0.0, max_bf16_ulps=0.0,
                                share_over_one_ulp=0.0)
