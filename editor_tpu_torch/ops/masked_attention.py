"""Masked multi-head attention from the raw qkv projection (K3).

Counterpart of ``editor_tpu/ops/masked_attention.py``, the hot op of the HMA
fusion block: logits are filled with ``mask_fill`` (-65504) where
``mask_q * mask_k == 0``, softmaxed, and output rows multiplied by the query
mask, so fully masked rows come out 0.

On a CUDA tensor :func:`masked_attention_qkv` launches
``csrc/masked_attention.cu`` (bf16 qkv, any N <= 512) or raises; on a CPU
tensor it runs :func:`masked_attention_qkv_plain`. The TPU's tiled kernel
for 1+128-token tiles (COMPACT_TAIL off) is not ported: every sequence of the
compact-tail path goes through the full-logits kernel.

Its VJP (K5) is :func:`masked_attention_qkv_bwd`: ``csrc/masked_attention_bwd.cu``
on a CUDA tensor, :func:`masked_attention_qkv_bwd_plain` on a CPU tensor.
:func:`masked_attention_qkv_fn` joins the two under autograd for the train
step; the mask gets no gradient.
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


def masked_attention_qkv_bwd_plain(qkv: torch.Tensor, mask: torch.Tensor,
                                   g: torch.Tensor, num_heads: int, scale: float,
                                   mask_fill: float = MASK_FILL) -> torch.Tensor:
    """The VJP of :func:`masked_attention_qkv_plain` in qkv: qkv [B, N, 3C],
    mask [B, N], g [B, N, C] -> dqkv [B, N, 3C] in qkv.dtype.

    Explicit VJP in at least fp32 (the math of ``jax.vjp`` of
    ``_xla_masked_from_qkv``) in the TPU kernel's form
    (``_qkv_masked_full_bwd_kernel``): r0 = sum(dat * e) / sum(e) over the
    row, dl = attn * (dat - r0) * scale with attn already re-masked, attn
    and dl rounded to qkv.dtype before the products."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    H, D = num_heads, C // num_heads
    cd = compute_dtype(qkv.dtype)
    q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4).to(cd)  # [B, H, N, D]
    gh = g.reshape(B, N, H, D).transpose(1, 2).to(cd)
    m = mask.to(cd)
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    pair = m[:, None, :, None] * m[:, None, None, :]
    logits = torch.where(pair == 0, torch.full_like(logits, mask_fill), logits)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    inv = 1.0 / e.sum(-1, keepdim=True)
    attn = e * inv * m[:, None, :, None]
    dat = torch.matmul(gh, v.transpose(-1, -2))
    r0 = (dat * e).sum(-1, keepdim=True) * inv
    dl = (attn * (dat - r0) * scale).to(qkv.dtype).to(cd)
    ab = attn.to(qkv.dtype).to(cd)
    dq = torch.matmul(dl, k)
    dk = torch.matmul(dl.transpose(-1, -2), q)
    dv = torch.matmul(ab.transpose(-1, -2), gh)
    return torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(
        B, N, C3).to(qkv.dtype)


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


def masked_attention_qkv_bwd(qkv: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                             num_heads: int, scale: float,
                             mask_fill: float = MASK_FILL) -> torch.Tensor:
    """K5: dqkv [B, N, 3C] from qkv, the mask [B, N] and the output's
    cotangent g [B, N, C]. CUDA: ``csrc/masked_attention_bwd.cu`` (bf16,
    contiguous); CPU: :func:`masked_attention_qkv_bwd_plain`."""
    B, N, C3 = qkv.shape
    if C3 % (3 * num_heads):
        raise ValueError(f"qkv width {C3} is not 3 x heads ({num_heads}) x D")
    if mask.shape != (B, N):
        raise ValueError(f"mask {tuple(mask.shape)} != {(B, N)}")
    if g.shape != (B, N, C3 // 3):
        raise ValueError(f"g {tuple(g.shape)} != {(B, N, C3 // 3)}")
    if qkv.device.type == "cpu":
        return masked_attention_qkv_bwd_plain(qkv, mask, g, num_heads, scale, mask_fill)
    D = C3 // 3 // num_heads
    check_kernel_tensor("masked_attention_qkv_bwd qkv", qkv, 3, D, N, align=4)
    check_kernel_tensor("masked_attention_qkv_bwd g", g, 3, D, N, align=4)
    if mask.device != qkv.device:
        raise ValueError(f"mask on {mask.device}, qkv on {qkv.device}")
    from editor_tpu_torch.ops import _build

    mask32 = mask.to(torch.float32).contiguous()
    dqkv = torch.empty_like(qkv)
    # per-(b, h) scratch of the rounded attn and dl rows (csrc/attention_bwd.cuh)
    pst = torch.empty((B * num_heads, N, N), dtype=qkv.dtype, device=qkv.device)
    dlst = torch.empty_like(pst)
    code = _build.library().editor_masked_attention_bwd(
        qkv.data_ptr(), mask32.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
        pst.data_ptr(), dlst.data_ptr(), B, N, num_heads, D, float(scale),
        float(mask_fill), torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(code, "masked_attention_qkv_bwd")
    masked_attention_qkv_bwd.launches += 1
    return dqkv


masked_attention_qkv_bwd.launches = 0


class _MaskedAttentionQKV(torch.autograd.Function):
    """K3 forward, K5 backward; no gradient for the mask."""

    @staticmethod
    def forward(ctx, qkv, mask, num_heads, scale, mask_fill):
        ctx.save_for_backward(qkv, mask)
        ctx.num_heads, ctx.scale, ctx.mask_fill = num_heads, scale, mask_fill
        return masked_attention_qkv(qkv, mask, num_heads, scale, mask_fill)

    @staticmethod
    def backward(ctx, g_out):
        qkv, mask = ctx.saved_tensors
        dqkv = masked_attention_qkv_bwd(qkv, mask, g_out.contiguous(), ctx.num_heads,
                                        ctx.scale, ctx.mask_fill)
        return dqkv, None, None, None, None


def masked_attention_qkv_fn(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
                            scale: float, mask_fill: float = MASK_FILL) -> torch.Tensor:
    """:func:`masked_attention_qkv` under autograd, with
    :func:`masked_attention_qkv_bwd` as its backward."""
    return _MaskedAttentionQKV.apply(qkv, mask.detach(), num_heads, scale, mask_fill)
