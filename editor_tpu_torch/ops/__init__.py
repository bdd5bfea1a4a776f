"""Attention and fused-linear ops of the eval and train paths, each a
hand-written CUDA kernel for Hopper beside its plain PyTorch version.

| wrapper | kernel source | plain version |
| --- | --- | --- |
| :func:`attention_qkv` (K1) | ``csrc/attention_qkv.cu`` | :func:`attention_qkv_plain` (the kernel's form: :func:`attention_qkv_tpu_plain`) |
| :func:`rollout_chain` (K2) | ``csrc/rollout_chain.cu`` | :func:`rollout_from_probs_plain` |
| :func:`masked_attention_qkv` (K3) | ``csrc/masked_attention.cu`` | :func:`masked_attention_qkv_plain` (the kernel's form: :func:`masked_attention_qkv_tpu_plain`) |
| :func:`attention_qkv_bwd` (K4) | ``csrc/attention_qkv_bwd.cu`` | :func:`attention_qkv_bwd_plain` |
| :func:`masked_attention_qkv_bwd` (K5) | ``csrc/masked_attention_bwd.cu`` | :func:`masked_attention_qkv_bwd_plain` |
| :func:`masked_attention_tiled` (K6) | ``csrc/masked_attention.cu`` | :func:`masked_attention_tiled_plain` |
| :func:`masked_attention_tiled_bwd` (K7) | ``csrc/masked_attention_bwd.cu`` | :func:`masked_attention_tiled_bwd_plain` |
| :func:`ln_matmul` (K8) | ``csrc/ln_matmul.cu`` | :func:`ln_matmul_plain` |

K1, K3 and K6 share the tensor-core forward body of
``csrc/attention_fwd_mma.cuh`` (K1 unmasked with probs and an fp32 cls key,
K3 masked with every exp rounded and lazy normalisation, K6 as K3 with each
tile's cls key in fp32). K4, K7 and K5 share the tensor-core backward body of
``csrc/attention_bwd_mma.cuh`` (K4 unmasked with one cls key, K7 masked with
a cls key a tile, K5 masked with none); the tensor-core bodies use the
helpers of ``csrc/mma.cuh``. A wrapper runs its plain version for a CPU
tensor; for a CUDA tensor it launches its kernel (built on first use by
:mod:`._build`) or raises. Each wrapper counts its kernel launches in its
``launches`` attribute. :func:`attention_qkv_fn` (K1 + K4),
:func:`masked_attention_qkv_fn` (K3 + K5), :func:`masked_attention_tiled_fn`
(K6 + K7) and :func:`ln_matmul_fn` (K8, plain backward) are the autograd
forms; :func:`masked_attention_from_qkv` picks the fusion block's pair (K6/K7
for 1 + 128-token tiles, else K3/K5). K8 is on no model path, as in the JAX
package. The raw K3, K5 and K6 wrappers (:data:`GROUP_WRAPPERS`) take
``group=``, the sequences a block walks: 0 on the model paths; g >= 1 serves
the group sweeps of the design-variant tools in ``editor_tpu_torch/tools/``
(T6 is K3 and K5 at the JAX tool's groups; the kernels T1-T6 sit beside
their plain versions there), gives group 0's output bit for bit, and counts
in ``variant_launches``, not ``launches``. Under
``utils.profiling.cost_analysis`` each of K1-K8's wrappers counts its
operations from its shapes, once, on the card and on the CPU (:mod:`._flops`).

Beside the kernels, as in the JAX package's ``ops``: the wavelet transforms
of :mod:`.wavelets` (``wavedec2`` / ``waverec2``, ``wavedec1`` /
``waverec1``, ``swt2`` / ``iswt2``), plain PyTorch convolutions as they are
XLA convolutions there, and :mod:`.dtcwt` (the dual-tree complex wavelet
transform and the scattering layers on them; a module of its own, as in
JAX). JAX's ``ops`` also re-exports its pre-split-heads
``masked_attention`` function under its submodule's name, which hides the
submodule; here ``ops.masked_attention`` stays the module.
"""

from editor_tpu_torch.ops.fused_attention import (attention_qkv, attention_qkv_bwd,
                                                  attention_qkv_bwd_plain,
                                                  attention_qkv_fn, attention_qkv_plain,
                                                  attention_qkv_tpu_plain)
from editor_tpu_torch.ops.fused_linear import ln_matmul, ln_matmul_fn, ln_matmul_plain
from editor_tpu_torch.ops.masked_attention import (MASK_FILL, masked_attention_from_qkv,
                                                   masked_attention_qkv,
                                                   masked_attention_qkv_bwd,
                                                   masked_attention_qkv_bwd_plain,
                                                   masked_attention_qkv_fn,
                                                   masked_attention_qkv_plain,
                                                   masked_attention_qkv_tpu_plain,
                                                   masked_attention_route,
                                                   masked_attention_tiled,
                                                   masked_attention_tiled_bwd,
                                                   masked_attention_tiled_bwd_plain,
                                                   masked_attention_tiled_fn,
                                                   masked_attention_tiled_plain)
from editor_tpu_torch.ops.rollout import rollout_chain, rollout_from_probs_plain
from editor_tpu_torch.ops.wavelets import iswt2, swt2, wavedec1, wavedec2, waverec1, waverec2

KERNEL_WRAPPERS = (attention_qkv, rollout_chain, masked_attention_qkv,
                   attention_qkv_bwd, masked_attention_qkv_bwd, masked_attention_tiled,
                   masked_attention_tiled_bwd, ln_matmul)
GROUP_WRAPPERS = (masked_attention_qkv, masked_attention_qkv_bwd, masked_attention_tiled)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for fn in GROUP_WRAPPERS:
        fn.variant_launches = 0


__all__ = ["MASK_FILL", "KERNEL_WRAPPERS", "GROUP_WRAPPERS", "attention_qkv",
           "attention_qkv_bwd", "attention_qkv_bwd_plain", "attention_qkv_fn", "attention_qkv_plain",
           "attention_qkv_tpu_plain",
           "iswt2", "ln_matmul", "ln_matmul_fn", "ln_matmul_plain",
           "masked_attention_from_qkv",
           "masked_attention_qkv", "masked_attention_qkv_bwd",
           "masked_attention_qkv_bwd_plain", "masked_attention_qkv_fn",
           "masked_attention_qkv_plain", "masked_attention_qkv_tpu_plain",
           "masked_attention_route", "masked_attention_tiled",
           "masked_attention_tiled_bwd", "masked_attention_tiled_bwd_plain",
           "masked_attention_tiled_fn", "masked_attention_tiled_plain",
           "reset_launch_counts", "rollout_chain", "rollout_from_probs_plain", "swt2",
           "wavedec1", "wavedec2", "waverec1", "waverec2"]
