"""Gradient reducers of the explicit data-parallel step: counterpart of
``editor_tpu/parallel/compression.py`` (reference: ddp_comm_hooks/
``allreduce``, ``fp16_compress``/``bf16_compress``, quantization_hooks.py,
powerSGD_hook.py).

A :class:`Reducer` maps each rank's gradients to their mean over the group,
leaf by leaf as the JAX reducers do (not in torch DDP's buckets): ``grads``
is an ordered ``{leaf name: tensor}``, ``reduce(grads, state, group)``
returns the averaged leaves and the new state; ``elementwise`` says that an
element's result depends on that element alone (so a slice of a leaf
reduces to the slice of the leaf's result). The reducers:

* ``allreduce``: the mean (the sum over the group size, as ``lax.pmean``);
* ``fp16``/``bf16``: cast, mean in that dtype, cast back;
* ``int8``: one symmetric scale a leaf (``max|g| / 127 + 1e-12``), the
  rounded int8 values and the scales all-gathered, dequantised, then the
  mean over ranks;
* ``powersgd``: a leaf that :func:`_compressible` passes is reshaped to
  ``[-1, last]`` and sent as the rank-r factors ``P`` (orthogonalised by
  Gram-Schmidt) and ``Q`` (warm-started from the last step), with error
  feedback; every other leaf goes through the mean. Its state ``{leaf:
  {"q", "error"}}`` is carried across steps; ``q`` is the same on every
  rank, ``error`` is the rank's own.

Where a leaf's layout matters (the int8 scale and PowerSGD's matrix), the
data-parallel step hands the reducers the JAX package's leaves
(:class:`editor_tpu_torch.parallel.ddp.LeafLayout`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from editor_tpu_torch.parallel import collectives as C

Grads = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Reducer:
    init: Callable[[Grads], Any]                              # template -> state
    reduce: Callable[[Grads, Any, Any], Tuple[Grads, Any]]    # (grads, state, group)
    name: str
    elementwise: bool = False


def _no_state(_):
    return ()


def _mean(g: torch.Tensor, group) -> torch.Tensor:
    return C.all_reduce(g.detach(), group, "mean")


def allreduce_reducer() -> Reducer:
    """The mean all-reduce (default_hooks.py ``allreduce_hook``)."""
    def reduce(grads, state, group):
        return {k: _mean(g, group) for k, g in grads.items()}, state
    return Reducer(_no_state, reduce, "allreduce", elementwise=True)


def _to_half(g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``g`` in the 16-bit ``dtype`` as JAX converts it. From float64 JAX
    rounds to float16 once, where torch goes through float32 and can round
    twice; so a float64 tensor goes through float32 rounded to odd
    (truncated, the last bit set where inexact), after which the second
    rounding is the correct one. To bfloat16 both round through float32."""
    if g.dtype != torch.float64 or dtype != torch.float16:
        return g.to(dtype)
    r = g.to(torch.float32)
    r = torch.where(r.to(torch.float64).abs() > g.abs(), torch.nextafter(r, torch.zeros_like(r)),
                    r)
    odd = r.view(torch.int32) | (r.to(torch.float64) != g).to(torch.int32)
    return odd.view(torch.float32).to(dtype)


def cast_compress_reducer(dtype: torch.dtype) -> Reducer:
    """Cast, mean in ``dtype``, cast back (default_hooks.py
    ``fp16_compress_hook``/``bf16_compress_hook``): half the bytes."""
    def reduce(grads, state, group):
        return {k: _mean(_to_half(g, dtype), group).to(g.dtype) for k, g in grads.items()}, state
    return Reducer(_no_state, reduce, f"cast_{str(dtype).split('.')[-1]}", elementwise=True)


def int8_quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, fp32 scale) of one leaf: symmetric, one scale a tensor."""
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_quantize_reducer() -> Reducer:
    """Quantise, all-gather the int8 values and scales, dequantise, mean
    over ranks (quantization_hooks.py semantics). The mean adds the ranks'
    dequantised values in rank order as the JAX reducer's compiled mean
    does: rank 0's product rounded, each later one fused into the running
    sum with one rounding (a multiply-add, done in float64 for float32
    leaves), then the division by W."""
    def reduce(grads, state, group):
        out = {}
        for k, g in grads.items():
            q, scale = int8_quantize(g.detach())
            qs = C.all_gather(q, group, tiled=False).to(g.dtype)          # [W, ...]
            scales = C.all_gather(scale.reshape(1), group).to(g.dtype)    # [W]
            acc = qs[0] * scales[0]
            wide = torch.float64 if g.dtype != torch.float64 else g.dtype
            for r in range(1, qs.shape[0]):
                acc = (qs[r].to(wide) * scales[r].to(wide) + acc.to(wide)).to(g.dtype)
            out[k] = acc / qs.shape[0]
        return out, state
    return Reducer(_no_state, reduce, "int8")


def _orthogonalize(m: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Gram-Schmidt over the columns of m [n, r] (powerSGD_hook.py
    ``_orthogonalize``), in the JAX function's order of operations: each
    column is normalised, then its projection is taken out of the later
    columns."""
    m = m.clone()
    r = m.shape[1]
    for i in range(r):
        col = m[:, i:i + 1]
        col = col / (torch.linalg.vector_norm(col) + eps)
        proj = (m * col).sum(dim=0, keepdim=True)  # [1, r]
        keep = (torch.arange(r, device=m.device)[None, :] <= i).to(m.dtype)
        m = m - col @ (proj * (1 - keep))
        m[:, i:i + 1] = col
    return m


def _compressible(shape, rank: int, min_compression_rate: float) -> bool:
    if len(shape) < 2:
        return False
    n = int(np.prod(shape[:-1]))
    m = int(shape[-1])
    return n * m / max((n + m) * rank, 1) >= min_compression_rate


def powersgd_reducer(rank: int = 4, seed: int = 0,
                     min_compression_rate: float = 2.0) -> Reducer:
    """Low-rank compression with error feedback and a warm-started Q
    (powerSGD_hook.py): matrix leaves as rank-``rank`` P Q^T, the rest
    through the mean. ``init`` draws each compressible leaf's Q [last, rank]
    from a normal generator seeded with ``seed``, in leaf order."""

    def init(template: Grads):
        gen = torch.Generator().manual_seed(seed)
        state = {}
        for name, leaf in template.items():
            if _compressible(tuple(leaf.shape), rank, min_compression_rate):
                q = torch.randn((leaf.shape[-1], rank), generator=gen, dtype=torch.float32)
                state[name] = {"q": q.to(leaf.device),
                               "error": torch.zeros(leaf.shape, dtype=torch.float32,
                                                    device=leaf.device)}
        return state

    def reduce(grads, state, group):
        new_state = dict(state)
        out = {}
        for name, g in grads.items():
            g = g.detach()
            if name not in state:
                out[name] = _mean(g, group)
                continue
            st = state[name]
            last = g.shape[-1]
            mtx = g.to(torch.float32).reshape(-1, last) + st["error"].reshape(-1, last)
            p = _orthogonalize(_mean(mtx @ st["q"], group))     # [n, r]
            q_new = _mean(mtx.T @ p, group)                      # [m, r]
            approx = p @ q_new.T
            new_state[name] = {"q": q_new, "error": (mtx - approx).reshape(g.shape)}
            out[name] = approx.reshape(g.shape).to(g.dtype)
        return out, new_state

    return Reducer(init, reduce, f"powersgd{rank}")


REDUCERS = ("none", "allreduce", "fp16", "bf16", "int8", "powersgd")


def make_reducer(name: str, **kw) -> Reducer:
    """The reducer of ``TPU.GRAD_COMPRESSION``: 'none' or 'allreduce',
    'fp16', 'bf16', 'int8', 'powersgd' (``rank=`` ``TPU.POWERSGD_RANK``)."""
    if name in ("none", "allreduce"):
        return allreduce_reducer()
    if name == "fp16":
        return cast_compress_reducer(torch.float16)
    if name == "bf16":
        return cast_compress_reducer(torch.bfloat16)
    if name == "int8":
        return int8_quantize_reducer()
    if name == "powersgd":
        return powersgd_reducer(rank=kw.get("rank", 4))
    raise ValueError(f"unknown reducer '{name}'")
