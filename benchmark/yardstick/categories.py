"""Device-kernel categories, frozen here so that later changes to the
program cannot move them.

``CATEGORIES`` is a copy of ``editor_tpu_torch/tools/profile_forward.py``'s
table: the first pattern that matches the lower-case kernel name wins.
``ATTENTION`` is the broad pattern the attention roofline divides by: it
maps any kernel that does attention (the port's tensor-core bodies, a
library's fused or flash attention) to attention, so the roofline reads the
same work whatever kernel does it. The rollout chain (K2) is not attention
work and does not match it.
"""

from __future__ import annotations

import re

CATEGORIES = (
    ("K1 attention_qkv", r"attention_fwd_mma_kernel<[^,]*fwdform(\)0|::kqkv)"),
    ("K2 rollout_chain", r"rollout_chain_kernel"),
    ("K3 masked_attention", r"attention_fwd_mma(_walk)?_kernel<[^,]*fwdform(\)1|::kfull)"),
    ("K4 attention_qkv_bwd", r"attention_bwd_mma_kernel<[^,]*bwdform(\)0|::kqkv)"),
    ("K5 masked_attention_bwd",
     r"attention_bwd_mma(_walk)?_kernel<[^,]*bwdform(\)2|::kfull)"),
    ("K6 masked_attention_tiled", r"attention_fwd_mma(_walk)?_kernel<[^,]*fwdform(\)2|::ktiled)"),
    ("K7 masked_attention_tiled_bwd", r"attention_bwd_mma_kernel<[^,]*bwdform(\)1|::ktiled)"),
    ("K8 ln_matmul", r"ln_matmul_kernel"),
    ("T1/T2 attention variants",
     r"attention_fwd_mma_kernel<[^,]*fwdform(\)[34]|::knomax|::ksplit)"),
    ("T3 attn_layer", r"attn_layer_kernel"),
    ("T4 rollout variants", r"rollout_variant_kernel|rollout_rows_kernel"),
    ("T5 rollout_multi", r"rollout_multi_kernel"),
    ("optimizer (foreach)", r"multi_tensor_apply|foreach"),
    ("patch conv (cuDNN)", r"fprop|dgrad|wgrad|cudnn|nchw|nhwc|conv(?!ert)"),
    ("GEMM (cuBLAS)", r"gemm|nvjet|xmma|cutlass|cublas"),
    ("LayerNorm", r"layer_?norm|gamma_?beta"),
    ("GELU", r"gelu"),
)
OTHER = "other elementwise / copy / reduce"
ATTENTION = r"attention|attn|fmha|flash|sdpa|mha"


def category(kernel_name: str) -> str:
    name = kernel_name.lower()
    for label, pattern in CATEGORIES:
        if re.search(pattern, name):
            return label
    return OTHER


def is_attention(kernel_name: str) -> bool:
    return re.search(ATTENTION, kernel_name.lower()) is not None
