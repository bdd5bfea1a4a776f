"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

MAX_TOKENS = 512  # kMaxTokens in csrc/common.cuh


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
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensor on {t.device}, but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer is not {align}-byte aligned")
    if head_dim and head_dim % 4:
        raise ValueError(f"{name}: head dim {head_dim} is not a multiple of 4")
    if tokens > MAX_TOKENS:
        raise ValueError(f"{name}: {tokens} tokens > {MAX_TOKENS}, the most "
                         "a block stages in shared memory")
