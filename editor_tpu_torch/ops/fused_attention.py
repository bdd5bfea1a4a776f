"""Multi-head self-attention straight from the raw qkv projection (K1).

Counterpart of ``editor_tpu/ops/fused_attention.py``. The backbone calls
:func:`attention_qkv` once per block with ``probs_out`` set, so each layer's
post-softmax maps land in one preallocated ``[L, B, H, N, N]`` buffer that the
rollout (K2, :mod:`editor_tpu_torch.ops.rollout`) reads.

On a CUDA tensor :func:`attention_qkv` launches the hand-written kernel
``csrc/attention_qkv.cu`` (bf16 only) or raises; on a CPU tensor it runs
:func:`attention_qkv_plain`. Its VJP (K4) is :func:`attention_qkv_bwd`:
``csrc/attention_qkv_bwd.cu`` on a CUDA tensor, the unmasked instance of the
tensor-core body that K7 runs masked (``csrc/attention_bwd_mma.cuh``), and
:func:`attention_qkv_bwd_plain` on a CPU tensor. :func:`attention_qkv_fn`
joins the two under autograd for the train step; the probabilities it writes
carry no gradient, as in the JAX ``custom_vjp`` (they only feed the
rollout's top-k).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from editor_tpu_torch.ops import _flops
from editor_tpu_torch.ops._checks import (check_kernel_tensor, check_probs_out,
                                          compute_dtype)


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


def attention_qkv_tpu_plain(qkv: torch.Tensor, num_heads: int, scale: float,
                            with_probs: bool):
    """K1's function in the TPU kernel's form (``_head_split_softmax_av``),
    which the CUDA kernel follows: qkv [B, N, 3C] -> out [B, N, C] (+ probs
    [B, H, N, N]) in qkv.dtype.

    Logits in at least fp32 times ``scale``; row max, exp and sum in fp32;
    ``p = e * (1 / sum)``; probs are ``p`` rounded to qkv.dtype. Before the
    p.v product the patch keys' (m >= 1) ``p`` is rounded to qkv.dtype, the
    cls key's (m = 0) is not: it differs from :func:`attention_qkv_plain`
    only there (and at f64 not at all)."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    H, D = num_heads, C // num_heads
    cd = compute_dtype(qkv.dtype)
    q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4).to(cd)  # [B, H, N, D]
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = e * (1.0 / e.sum(-1, keepdim=True))
    cls_key = torch.arange(N, device=qkv.device) == 0
    pr = torch.where(cls_key, p, p.to(qkv.dtype).to(cd))
    out = torch.matmul(pr, v).to(qkv.dtype).transpose(1, 2).reshape(B, N, C)
    return (out, p.to(qkv.dtype)) if with_probs else out


def attention_qkv_bwd_plain(qkv: torch.Tensor, g: torch.Tensor, num_heads: int,
                            scale: float) -> torch.Tensor:
    """The VJP of :func:`attention_qkv_plain`'s output: qkv [B, N, 3C], g
    [B, N, C] -> dqkv [B, N, 3C] in qkv.dtype.

    Explicit softmax VJP in at least fp32 (the math of ``jax.vjp`` of
    ``_xla_attention_qkv``), rounded to qkv.dtype where the TPU kernel
    ``_qkv_bwd_kernel`` rounds: the patch-key probabilities before p^T g and
    the logit cotangents before dq and dk; the cls key's stay unrounded."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    H, D = num_heads, C // num_heads
    cd = compute_dtype(qkv.dtype)
    q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4).to(cd)  # [B, H, N, D]
    gh = g.reshape(B, N, H, D).transpose(1, 2).to(cd)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    cls_key = torch.arange(N, device=qkv.device) == 0

    def rnd(t):  # the TPU kernel's rounding, cls-key column kept
        return torch.where(cls_key, t, t.to(qkv.dtype).to(cd))

    dv = torch.matmul(rnd(p).transpose(-1, -2), gh)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    dl = rnd(p * (dp - (dp * p).sum(-1, keepdim=True)) * scale)
    dq = torch.matmul(dl, k)
    dk = torch.matmul(dl.transpose(-1, -2), q)
    return torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(
        B, N, C3).to(qkv.dtype)


K1_MAX_HEAD_DIM = 128  # the widest head editor_attention_qkv dispatches


def _check_head_dim(name: str, D: int) -> None:
    if D % 16 or not 0 < D <= K1_MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} is not a multiple of 16 "
                         f"up to {K1_MAX_HEAD_DIM}")


def check_k1_head_dim(D: int) -> None:
    """Raise unless K1's CUDA kernel takes head dim ``D``: its tensor-core
    tiles are 16 deep, so a multiple of 16 up to 128."""
    _check_head_dim("attention_qkv", D)


def check_k4_head_dim(D: int) -> None:
    """Raise unless K4's CUDA kernel takes head dim ``D``: the head dims K1
    takes (:func:`check_k1_head_dim`), at every N up to 512."""
    _check_head_dim("attention_qkv_bwd", D)


@_flops.counted(_flops.attention)
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
    check_probs_out("attention_qkv", probs_out, qkv, B, num_heads, N)
    if qkv.device.type == "cpu":
        if probs_out is None:
            return attention_qkv_plain(qkv, num_heads, scale, False), None
        out, probs = attention_qkv_plain(qkv, num_heads, scale, True)
        probs_out.copy_(probs)
        return out, probs_out
    check_k1_head_dim(D)
    # 16-byte cp.async copies of the head's rows (3C * 2 bytes apart)
    check_kernel_tensor("attention_qkv", qkv, 3, D, N, align=16)
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


@_flops.counted(_flops.attention_bwd)
def attention_qkv_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int,
                      scale: float) -> torch.Tensor:
    """K4: dqkv [B, N, 3C] from qkv [B, N, 3C] and the output's cotangent g
    [B, N, C]. CUDA: ``csrc/attention_qkv_bwd.cu`` (bf16, contiguous, qkv
    and g 16-byte aligned, :func:`check_k4_head_dim`), with a [B H, Np, Np]
    bf16 scratch pair where its chunked instance needs one (the kernel's
    ``editor_attention_qkv_bwd_scratch`` gives Np); CPU:
    :func:`attention_qkv_bwd_plain`."""
    B, N, C3 = qkv.shape
    if C3 % (3 * num_heads):
        raise ValueError(f"qkv width {C3} is not 3 x heads ({num_heads}) x D")
    if g.shape != (B, N, C3 // 3):
        raise ValueError(f"g {tuple(g.shape)} != {(B, N, C3 // 3)}")
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_plain(qkv, g, num_heads, scale)
    D = C3 // 3 // num_heads
    check_k4_head_dim(D)
    # 16-byte cp.async copies of the head's rows
    check_kernel_tensor("attention_qkv_bwd qkv", qkv, 3, D, N, align=16)
    check_kernel_tensor("attention_qkv_bwd g", g, 3, D, N, align=16)
    from editor_tpu_torch.ops import _build

    lib = _build.library()
    side = ctypes.c_int()
    _build.check(lib.editor_attention_qkv_bwd_scratch(N, D, ctypes.byref(side)),
                 "attention_qkv_bwd")
    dqkv = torch.empty_like(qkv)
    scratch = [None, None]
    if side.value:  # per-(b, h) scratch of the rounded attn and dl
        scratch = [torch.empty((B * num_heads, side.value, side.value), dtype=qkv.dtype,
                               device=qkv.device) for _ in range(2)]
    code = lib.editor_attention_qkv_bwd(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in scratch),
        B, N, num_heads, D, float(scale), torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(code, "attention_qkv_bwd")
    attention_qkv_bwd.launches += 1
    return dqkv


attention_qkv_bwd.launches = 0


class _AttentionQKV(torch.autograd.Function):
    """K1 forward, K4 backward; the probs output is non-differentiable."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, probs_box):
        out, probs = attention_qkv(qkv, num_heads, scale, probs_box[0])
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        if probs is None:
            return out
        ctx.mark_non_differentiable(probs)
        return out, probs

    @staticmethod
    def backward(ctx, g_out, *_g_probs):  # the probs cotangent is dropped
        (qkv,) = ctx.saved_tensors
        dqkv = attention_qkv_bwd(qkv, g_out.contiguous(), ctx.num_heads, ctx.scale)
        return dqkv, None, None, None


def attention_qkv_fn(qkv: torch.Tensor, num_heads: int, scale: float,
                     probs_out: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`attention_qkv` under autograd, with :func:`attention_qkv_bwd` as
    its backward. Returns (out, probs_out); the probabilities written into
    ``probs_out`` carry no gradient. (``probs_out`` rides in a tuple so that
    autograd does not count the buffer as an input of the graph.)"""
    res = _AttentionQKV.apply(qkv, num_heads, scale, (probs_out,))
    if probs_out is None:
        return res, None
    return res
