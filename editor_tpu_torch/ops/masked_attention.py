"""Masked multi-head attention from the raw qkv projection (K3).

Counterpart of ``editor_tpu/ops/masked_attention.py``, the hot op of the HMA
fusion block: logits are filled with ``mask_fill`` (-65504) where
``mask_q * mask_k == 0``, softmaxed, and output rows multiplied by the query
mask, so fully masked rows come out 0.

On a CUDA tensor :func:`masked_attention_qkv` launches
``csrc/masked_attention.cu`` (bf16 qkv, any N <= 512) or raises; on a CPU
tensor it runs :func:`masked_attention_qkv_plain`. The TPU's tiled kernel
for 1+128-token tiles (COMPACT_TAIL off) is not ported: every sequence of the
compact-tail eval path goes through the full-logits kernel.
"""

from __future__ import annotations

import torch

from editor_tpu_torch.ops._checks import check_kernel_tensor, compute_dtype

MASK_FILL = -65504.0  # reference: vit_pytorch.py:252


def masked_attention_qkv_plain(qkv: torch.Tensor, mask: torch.Tensor,
                               num_heads: int, scale: float,
                               mask_fill: float = MASK_FILL) -> torch.Tensor:
    """qkv: [B, N, 3C], mask: [B, N] (1 = keep) -> [B, N, C].

    Same math as ``_xla_masked_from_qkv``: at-least-fp32 logits, masked
    pairs replaced by ``mask_fill``, softmax, query rows re-masked, weights
    cast to qkv.dtype before the product with v."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    H, D = num_heads, C // num_heads
    cd = compute_dtype(qkv.dtype)
    qkv5 = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)  # [3, B, H, N, D]
    q, k, v = qkv5[0].to(cd), qkv5[1].to(cd), qkv5[2].to(cd)
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    m = mask.to(cd)
    pair = m[:, None, :, None] * m[:, None, None, :]
    logits = torch.where(pair == 0, torch.full_like(logits, mask_fill), logits)
    attn = torch.softmax(logits, dim=-1) * m[:, None, :, None]
    out = torch.matmul(attn.to(qkv.dtype).to(cd), v).to(qkv.dtype)
    return out.transpose(1, 2).reshape(B, N, C)


def masked_attention_qkv(qkv: torch.Tensor, mask: torch.Tensor,
                         num_heads: int, scale: float,
                         mask_fill: float = MASK_FILL) -> torch.Tensor:
    """Masked attention from the raw qkv; ``mask`` [B, N] in any dtype."""
    B, N, C3 = qkv.shape
    if C3 % (3 * num_heads):
        raise ValueError(f"qkv width {C3} is not 3 x heads ({num_heads}) x D")
    if mask.shape != (B, N):
        raise ValueError(f"mask {tuple(mask.shape)} != {(B, N)}")
    if qkv.device.type == "cpu":
        return masked_attention_qkv_plain(qkv, mask, num_heads, scale, mask_fill)
    D = C3 // 3 // num_heads
    check_kernel_tensor("masked_attention_qkv", qkv, 3, D, N, align=4)
    if mask.device != qkv.device:
        raise ValueError(f"mask on {mask.device}, qkv on {qkv.device}")
    from editor_tpu_torch.ops import _build

    mask32 = mask.to(torch.float32).contiguous()
    out = torch.empty((B, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    code = _build.library().editor_masked_attention(
        qkv.data_ptr(), mask32.data_ptr(), out.data_ptr(), B, N, num_heads, D,
        float(scale), float(mask_fill),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(code, "masked_attention_qkv")
    masked_attention_qkv.launches += 1
    return out


masked_attention_qkv.launches = 0
