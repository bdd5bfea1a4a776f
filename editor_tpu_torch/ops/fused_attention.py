"""Multi-head self-attention straight from the raw qkv projection (K1).

Counterpart of ``editor_tpu/ops/fused_attention.py``. The backbone calls
:func:`attention_qkv` once per block with ``probs_out`` set, so each layer's
post-softmax maps land in one preallocated ``[L, B, H, N, N]`` buffer that the
rollout (K2, :mod:`editor_tpu_torch.ops.rollout`) reads.

On a CUDA tensor :func:`attention_qkv` launches the hand-written kernel
``csrc/attention_qkv.cu`` (bf16 only) or raises; on a CPU tensor it runs
:func:`attention_qkv_plain`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from editor_tpu_torch.ops._checks import check_kernel_tensor, compute_dtype


def attention_qkv_plain(qkv: torch.Tensor, num_heads: int, scale: float,
                        with_probs: bool):
    """qkv: [B, N, 3C] -> out [B, N, C] (+ probs [B, H, N, N] in qkv.dtype).

    Same math as ``_xla_attention_qkv``: fp32 logits and softmax for
    bf16/fp32 inputs (fp64 for fp64), probabilities cast to qkv.dtype before
    the p.v product, output cast back to qkv.dtype."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    H, D = num_heads, C // num_heads
    cd = compute_dtype(qkv.dtype)
    qkv5 = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)  # [3, B, H, N, D]
    q, k, v = qkv5[0].to(cd), qkv5[1].to(cd), qkv5[2]
    attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    probs = attn.to(qkv.dtype)
    out = torch.matmul(probs.to(cd), v.to(cd)).to(qkv.dtype)
    out = out.transpose(1, 2).reshape(B, N, C)
    return (out, probs) if with_probs else out


def attention_qkv(qkv: torch.Tensor, num_heads: int, scale: float,
                  probs_out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention from the raw qkv; returns (out [B, N, C], probs_out).

    ``probs_out``: optional [B, H, N, N] tensor of qkv's dtype and device
    that receives the post-softmax probabilities (a per-layer slice of the
    backbone's stacked buffer)."""
    B, N, C3 = qkv.shape
    if C3 % (3 * num_heads):
        raise ValueError(f"qkv width {C3} is not 3 x heads ({num_heads}) x D")
    D = C3 // 3 // num_heads
    if probs_out is not None and (probs_out.shape != (B, num_heads, N, N)
                                  or probs_out.dtype != qkv.dtype
                                  or probs_out.device != qkv.device):
        raise ValueError(
            f"probs_out {tuple(probs_out.shape)} {probs_out.dtype} "
            f"{probs_out.device} does not fit qkv {tuple(qkv.shape)} "
            f"{qkv.dtype} {qkv.device}")
    if qkv.device.type == "cpu":
        if probs_out is None:
            return attention_qkv_plain(qkv, num_heads, scale, False), None
        out, probs = attention_qkv_plain(qkv, num_heads, scale, True)
        probs_out.copy_(probs)
        return out, probs_out
    check_kernel_tensor("attention_qkv", qkv, 3, D, N, align=4)
    if probs_out is not None:
        check_kernel_tensor("attention_qkv probs_out", probs_out, 4)
    from editor_tpu_torch.ops import _build

    out = torch.empty((B, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    lib = _build.library()
    code = lib.editor_attention_qkv(
        qkv.data_ptr(), out.data_ptr(),
        probs_out.data_ptr() if probs_out is not None else None,
        B, N, num_heads, D, float(scale),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(code, "attention_qkv")
    attention_qkv.launches += 1
    return out, probs_out


attention_qkv.launches = 0
