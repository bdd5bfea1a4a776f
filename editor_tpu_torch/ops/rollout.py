"""Attention rollout: cls row of the chain product of per-layer maps (K2).

Counterpart of ``editor_tpu/ops/rollout.py``. SFTS needs row 0 of
A_{L-1} @ ... @ A_0 (reference chain order ``last_map = att[i] @ last_map``),
computed as a reverse vector chain v <- v . A_l: L N^2 work per (b, h) pair
instead of L matrix products.

The maps are stored full, ``[L, B, H, N, N]``: the TPU's split cls/patch
layout existed only for its 128-lane padding. On a CUDA tensor
:func:`rollout_chain` launches ``csrc/rollout_chain.cu`` (bf16 only) or
raises; on a CPU tensor it runs :func:`rollout_from_probs_plain`. Gradient
free: the rollout only feeds a discrete top-k.
"""

from __future__ import annotations

import torch

from editor_tpu_torch.ops import _flops
from editor_tpu_torch.ops._checks import check_kernel_tensor, compute_dtype


@torch.no_grad()
def rollout_from_probs_plain(probs: torch.Tensor) -> torch.Tensor:
    """probs: [L, B, H, N, N] post-softmax maps (row = query) -> the
    [B, H, N-1] patch part of the rollout cls row, in at least fp32."""
    cd = compute_dtype(probs.dtype)
    v = probs[-1][:, :, 0, :].to(cd)  # cls row of the last layer seeds the chain
    for a in reversed(probs[:-1]):
        v = torch.einsum("bhn,bhnm->bhm", v, a.to(cd))
    return v[:, :, 1:]


@torch.no_grad()
@_flops.counted(_flops.rollout)
def rollout_chain(probs: torch.Tensor) -> torch.Tensor:
    """Rollout from the stacked maps ``[L, B, H, N, N]`` -> ``[B, H, N-1]``."""
    L, B, H, N, N2 = probs.shape
    if N != N2:
        raise ValueError(f"maps must be square, got {tuple(probs.shape)}")
    if probs.device.type == "cpu":
        return rollout_from_probs_plain(probs)
    check_kernel_tensor("rollout_chain", probs, 5, tokens=N)
    from editor_tpu_torch.ops import _build

    out = torch.empty((B, H, N - 1), dtype=torch.float32, device=probs.device)
    code = _build.library().editor_rollout_chain(
        probs.data_ptr(), out.data_ptr(), L, B * H, N,
        torch.cuda.current_stream(probs.device).cuda_stream)
    _build.check(code, "rollout_chain")
    rollout_chain.launches += 1
    return out


rollout_chain.launches = 0
