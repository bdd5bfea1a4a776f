"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

MAX_TOKENS = 512  # kMaxTokens in csrc/common.cuh
# Largest K of the tensor-core GEMM body (kGemmMaxK in csrc/ln_gemm_mma.cuh),
# the C of K8 and T3: its LayerNorm pre-pass holds each lane's share of two
# rows (K / 256 16-byte chunks a row) in registers while it normalises them
GEMM_MAX_C = 1536


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least fp32: bf16/fp16/fp32 compute in fp32, fp64 stays fp64
    (``jnp.promote_types(dtype, jnp.float32)``)."""
    return torch.promote_types(dtype, torch.float32)


def check_kernel_tensor(name: str, t: torch.Tensor, ndim: int,
                        head_dim: int = 0, tokens: int = 0, align: int = 2) -> None:
    """Raise unless ``t`` is what the CUDA kernels take: a contiguous bf16
    tensor on the current CUDA device whose data is ``align``-byte aligned
    (4 where the kernel moves bf16 pairs), a head dim that is a multiple of 4
    and at most MAX_TOKENS tokens."""
    _check_cuda_bf16(name, t)
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    _check_layout(name, t, head_dim, tokens, align)


def check_rows_tensor(name: str, t: torch.Tensor, head_dim: int) -> int:
    """Raise unless ``t`` [B, N, C] is a bf16 CUDA tensor whose rows a kernel
    reads with 16-byte copies (:func:`rows_stride`). Returns the row stride
    in elements."""
    _check_cuda_bf16(name, t)
    return rows_stride(name, t, head_dim)


def rows_stride(name: str, t: torch.Tensor, head_dim: int) -> int:
    """The row stride in elements of ``t`` [B, N, C], whose rows a kernel
    reads with 16-byte copies: unit element stride, sequences N rows apart,
    a 16-byte aligned base and a row stride of a multiple of 16 bytes (a
    column view of the packed qkv qualifies); else raise. Checks neither
    device nor dtype."""
    if t.dim() != 3:
        raise ValueError(f"{name}: expected 3 dims, got {tuple(t.shape)}")
    B, N, _ = t.shape
    ld = t.stride(1)
    if (t.stride(2) != 1 or (B > 1 and t.stride(0) != N * ld)
            or ld * t.element_size() % 16):
        raise ValueError(f"{name}: strides {t.stride()} are not rows of one stride "
                         "of a multiple of 16 bytes")
    _check_layout(name, t, head_dim, N, 16)
    return ld


def check_probs_out(name: str, probs_out, like: torch.Tensor, B: int, H: int,
                    N: int) -> None:
    """Raise unless ``probs_out`` is None or a [B, H, N, N] tensor of
    ``like``'s dtype and device (where an attention writes its maps)."""
    if probs_out is not None and (probs_out.shape != (B, H, N, N)
                                  or probs_out.dtype != like.dtype
                                  or probs_out.device != like.device):
        raise ValueError(
            f"{name} probs_out {tuple(probs_out.shape)} {probs_out.dtype} "
            f"{probs_out.device} does not fit {B} x {H} heads x {N} tokens of "
            f"{like.dtype} {like.device}")


def _check_cuda_bf16(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensor on {t.device}, but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")


def _check_layout(name: str, t: torch.Tensor, head_dim: int, tokens: int,
                  align: int) -> None:
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer is not {align}-byte aligned")
    if head_dim and head_dim % 4:
        raise ValueError(f"{name}: head dim {head_dim} is not a multiple of 4")
    if tokens > MAX_TOKENS:
        raise ValueError(f"{name}: {tokens} tokens > {MAX_TOKENS}, the most "
                         "a block stages in shared memory")
