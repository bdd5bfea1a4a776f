"""Attention ops of the eval and train paths, each a hand-written CUDA kernel
for Hopper beside its plain PyTorch version.

| wrapper | kernel source | plain version |
| --- | --- | --- |
| :func:`attention_qkv` (K1) | ``csrc/attention_qkv.cu`` | :func:`attention_qkv_plain` |
| :func:`rollout_chain` (K2) | ``csrc/rollout_chain.cu`` | :func:`rollout_from_probs_plain` |
| :func:`masked_attention_qkv` (K3) | ``csrc/masked_attention.cu`` | :func:`masked_attention_qkv_plain` |
| :func:`attention_qkv_bwd` (K4) | ``csrc/attention_qkv_bwd.cu`` | :func:`attention_qkv_bwd_plain` |
| :func:`masked_attention_qkv_bwd` (K5) | ``csrc/masked_attention_bwd.cu`` | :func:`masked_attention_qkv_bwd_plain` |

A wrapper runs its plain version for a CPU tensor; for a CUDA tensor it
launches its kernel (built on first use by :mod:`._build`) or raises. Each
wrapper counts its kernel launches in its ``launches`` attribute.
:func:`attention_qkv_fn` (K1 + K4) and :func:`masked_attention_qkv_fn`
(K3 + K5) are the autograd forms the train step uses.
"""

from editor_tpu_torch.ops.fused_attention import (attention_qkv, attention_qkv_bwd,
                                                  attention_qkv_bwd_plain,
                                                  attention_qkv_fn, attention_qkv_plain)
from editor_tpu_torch.ops.masked_attention import (MASK_FILL, masked_attention_qkv,
                                                   masked_attention_qkv_bwd,
                                                   masked_attention_qkv_bwd_plain,
                                                   masked_attention_qkv_fn,
                                                   masked_attention_qkv_plain)
from editor_tpu_torch.ops.rollout import rollout_chain, rollout_from_probs_plain

KERNEL_WRAPPERS = (attention_qkv, rollout_chain, masked_attention_qkv,
                   attention_qkv_bwd, masked_attention_qkv_bwd)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


__all__ = ["MASK_FILL", "KERNEL_WRAPPERS", "attention_qkv", "attention_qkv_bwd",
           "attention_qkv_bwd_plain", "attention_qkv_fn", "attention_qkv_plain",
           "masked_attention_qkv", "masked_attention_qkv_bwd",
           "masked_attention_qkv_bwd_plain", "masked_attention_qkv_fn",
           "masked_attention_qkv_plain", "reset_launch_counts", "rollout_chain",
           "rollout_from_probs_plain"]
