"""The frozen arithmetic: bounds and operation counts reproduce the figures
on record, the kernel categories classify the port's kernel names, and the
trace reduction adds up."""

import pytest

from benchmark.yardstick import categories as cat
from benchmark.yardstick import flops as F
from benchmark.yardstick import trace as tr
from benchmark.yardstick.peaks import bound_s


def flagship(stride=16):
    return F.ModelShape(img=(256, 128), patch=16, stride=(stride, stride), dim=768, depth=12,
                        heads=12, mlp_ratio=4.0, fusion_mlp_ratio=4.0, modalities=3,
                        num_classes=171, al=True)


def test_k1_bound_at_the_flagship_shape():
    # PERF.md's table: K1 at [384, 129, 2304] with probs, 0.137 ms, bytes-bound, 0.458 GB
    fl, nb = F.qkv_attention_call(384, 129, 768, 12)
    assert nb == pytest.approx(0.458e9, rel=2e-3) and fl == pytest.approx(19.6e9, rel=3e-3)
    assert bound_s(fl, nb) * 1e3 == pytest.approx(0.137, abs=5e-4)
    assert nb / 3.35e12 > fl / 989e12


def test_k4_and_stride12_bounds():
    # K4 at [384, 129]: 0.159 ms (0.533 GB); at N = 211: K1 0.271 ms, K4 0.260 ms
    assert bound_s(*F.qkv_attention_call(384, 129, 768, 12, backward=True)) * 1e3 == \
        pytest.approx(0.159, abs=5e-4)
    assert bound_s(*F.qkv_attention_call(384, 211, 768, 12)) * 1e3 == pytest.approx(0.271, abs=5e-4)
    assert bound_s(*F.qkv_attention_call(384, 211, 768, 12, backward=True)) * 1e3 == \
        pytest.approx(0.260, abs=5e-4)


def test_k8_operations():
    # K8 at [49536, 768] -> 2304 and -> 3072: 409.0 GFLOP
    total = F.linear_flops(49536, 768, 2304) + F.linear_flops(49536, 768, 3072)
    assert round(total / 1e9, 1) == 409.0


@pytest.mark.parametrize("stride,tokens", [(16, 129), (12, 211)])
def test_train_step_is_three_forwards(stride, tokens):
    s = flagship(stride)
    assert s.tokens == tokens
    fwd = F.forward_flops(s, 128, 128 * 70.0, 128 * 70.0 ** 2, training=True)
    assert F.train_step_flops(s, 128, 128 * 70.0, 128 * 70.0 ** 2) == pytest.approx(3 * fwd)
    # the backbone is most of it: 3 images of ~22.7 (N = 129) or ~37.7 GFLOP (N = 211)
    per_image = F.backbone_image_flops(s) / 1e9
    assert per_image == pytest.approx(22.7 if stride == 16 else 37.7, rel=0.01)


def test_attention_bound_counts_kept_tokens():
    s = flagship()
    full = F.attention_bound_s(s, 64, 64 * 88.0, 64 * 88.0 ** 2, training=False)
    kept = F.attention_bound_s(s, 64, 64 * 40.0, 64 * 40.0 ** 2, training=False)
    backbone = 12 * bound_s(*F.qkv_attention_call(3 * 64, 129, 768, 12))
    assert backbone < kept < full


KERNELS = {
    "void attention_fwd_mma_kernel<(FwdForm)0, 64, 12>(AttnParams)": "K1 attention_qkv",
    "void attention_fwd_mma_kernel<(FwdForm)1, 64, 12>(AttnParams)": "K3 masked_attention",
    "void attention_fwd_mma_kernel<(FwdForm)2, 64, 8>(AttnParams)": "K6 masked_attention_tiled",
    "void attention_bwd_mma_kernel<(BwdForm)0, 64>(BwdParams)": "K4 attention_qkv_bwd",
    "void attention_bwd_mma_kernel<(BwdForm)1, 64>(BwdParams)": "K7 masked_attention_tiled_bwd",
    "void attention_bwd_mma_kernel<(BwdForm)2, 64>(BwdParams)": "K5 masked_attention_bwd",
    "void attention_bwd_mma_kernel<BwdForm::kFull, 64>(BwdParams)": "K5 masked_attention_bwd",
    "void rollout_chain_kernel<64>(float const*, float*, int, int, int)": "K2 rollout_chain",
    "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT": "GEMM (cuBLAS)",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "GEMM (cuBLAS)",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>":
        "LayerNorm",
    "void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl>":
        "GELU",
    "void at::native::multi_tensor_apply_kernel<FOREACH>": "optimizer (foreach)",
    "void cudnn::cnn::conv2d_grouped_direct_kernel": "patch conv (cuDNN)",
    "void at::native::elementwise_kernel<128, 2, at::native::direct_copy_kernel_cuda>":
        cat.OTHER,
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>": cat.OTHER,
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_categories_classify_the_ports_kernels(name):
    assert cat.category(name) == KERNELS[name]
    assert cat.is_attention(name) == ("attention" in KERNELS[name])


def test_categories_are_the_programs_table_frozen():
    from editor_tpu_torch.tools.profile_forward import CATEGORIES, OTHER
    assert cat.CATEGORIES == CATEGORIES and cat.OTHER == OTHER


def test_trace_reduction():
    device = [(0.0, 10.0, "a"), (5.0, 20.0, "attention_fwd_mma_kernel<(FwdForm)0>"),
              (30.0, 40.0, "b"), (60.0, 70.0, "c")]
    host = [(0.0, 100.0, "bench.stretch"), (18.0, 35.0, "bench.step"), (19.0, 25.0, "aten::mm"),
            (45.0, 65.0, "bench.feed")]
    assert tr.busy_s(device, 0.0, 100.0) == pytest.approx(40e-6)
    assert tr.attention_s(device, 0.0, 100.0) == pytest.approx(15e-6)
    gaps = tr.idle_gaps(device, host, 0.0, 100.0)
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 20e-6, 10e-6])
    assert gaps[0][0] == "bench.stretch / bench.stretch"
    assert gaps[1][0] == "bench.stretch / bench.stretch"
    assert gaps[2][0] == "bench.step / aten::mm"
    assert tr.gaps_by_label(gaps)[0] == ["bench.stretch / bench.stretch (x2)", pytest.approx(50e-6)]


def test_user_annotations_are_no_device_work():
    # a record_function range reaches the device's timeline as an interval
    # over every kernel under it; counted, it would read the device as busy
    device = [(0.0, 100.0, "bench.stretch"), (10.0, 20.0, "bench.step"), (12.0, 18.0, "k")]
    host = [(0.0, 100.0, "bench.stretch"), (10.0, 20.0, "bench.step"), (11.0, 12.0, "aten::mm")]
    ops = tr.device_operations(device, host)
    assert ops == [(12.0, 18.0, "k")]
    assert tr.busy_s(ops, 0.0, 100.0) == pytest.approx(6e-6)
