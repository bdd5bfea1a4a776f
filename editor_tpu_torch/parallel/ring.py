"""Sequence parallelism: ring attention and Ulysses, counterpart of
``editor_tpu/parallel/ring.py``.

Each function takes the full q, k, v [B, H, N, D] (and mask [B, N]) on
every rank of ``mesh``'s 'seq' group of S ranks (a ``DeviceMesh`` with a
'seq' dimension, or a process group), as JAX's take a global array: rank r
keeps the sequence block ``r*N/S:(r+1)*N/S``, the schedule runs on the
blocks, and the output blocks come back all-gathered into [B, H, N, D]. A
sequence the group does not divide raises (uncompacted N = 129 at S = 2).

* :func:`ring_attention` / :func:`ring_masked_attention`: q stays, and the
  k and v blocks (with the key mask) rotate one hop around the group
  (``batch_isend_irecv``) S times; each step folds its block into a running
  max, denominator and accumulator in fp32 (the online softmax). The masked
  form replaces the logits of pairs with ``mask_q * mask_k == 0`` by -65504
  and re-masks the query rows: the reference's masked attention.
* :func:`ulysses_attention` / :func:`ulysses_masked_attention`: one
  ``all_to_all`` from sequence- to head-sharded (H divisible by S), full
  attention over the gathered sequence for H/S heads, one ``all_to_all``
  back. The masked form's attention is K3 (``ops.masked_attention_qkv_fn``,
  with K5 as its backward) on the card, JAX's ``_xla_masked_attention`` on
  the CPU; the unmasked one plain PyTorch, as JAX's.

Every collective is differentiable (``collectives``), so gradients flow to
q, k and v; a rank's gradient is that of the sum of every rank's loss: where
every rank computes the same loss, the mean of the ranks' gradients is its
gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from editor_tpu_torch.ops._checks import compute_dtype
from editor_tpu_torch.parallel import collectives as C

MASK_FILL = -65504.0


def _group(mesh):
    from editor_tpu_torch.parallel.mesh import axis_group
    return axis_group(mesh, "seq")


def _check(q: torch.Tensor, S: int, heads: bool) -> None:
    if heads and q.shape[1] % S:
        raise ValueError(f"heads {q.shape[1]} not divisible by seq={S}")
    if q.shape[2] % S:
        raise ValueError(f"sequence {q.shape[2]} not divisible by seq={S}")


def _block(t: torch.Tensor, pg, S: int, dim: int) -> torch.Tensor:
    n = t.shape[dim] // S
    return t.narrow(dim, dist.get_rank(pg) * n, n)


def _ring_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pg, S: int,
                         scale: float, mask: Optional[torch.Tensor] = None,
                         mask_fill: float = MASK_FILL) -> torch.Tensor:
    """The ring on this rank's blocks (q, k, v [B, H, n, D], mask [B, n]):
    this rank's output block [B, H, n, D] in q's dtype (``_ring_shard``,
    ``_ring_masked_shard``)."""
    B, H, nq, D = q.shape
    cd = compute_dtype(q.dtype)  # fp32 for bf16, as JAX's carries
    m = torch.full((B, H, nq), float("-inf"), dtype=cd, device=q.device)
    den = torch.zeros((B, H, nq), dtype=cd, device=q.device)
    acc = torch.zeros((B, H, nq, D), dtype=cd, device=q.device)
    mq = mk = None
    if mask is not None:
        mq = mk = mask.to(cd)
    for step in range(S):
        logits = torch.matmul(q.to(cd), k.to(cd).transpose(-1, -2)) * scale
        if mask is not None:
            pair = mq[:, None, :, None] * mk[:, None, None, :]
            logits = torch.where(pair == 0, torch.full_like(logits, mask_fill), logits)
        # the running max only stabilises: the result does not depend on it
        m_new = torch.maximum(m, logits.detach().amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        den = den * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p.to(v.dtype).to(cd), v.to(cd))
        m = m_new
        if step + 1 < S:  # JAX's last rotation only returns the blocks home
            k = C.ppermute_shift(k, pg)
            v = C.ppermute_shift(v, pg)
            if mask is not None:
                mk = C.ppermute_shift(mk, pg)
    out = acc / den[..., None]
    if mask is not None:
        out = out * mq[:, None, :, None]
    return out.to(q.dtype)


def _ring(q, k, v, mesh, scale, mask=None, mask_fill=MASK_FILL):
    pg, S = _group(mesh)
    _check(q, S, heads=False)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qs, ks, vs = (_block(t, pg, S, 2) for t in (q, k, v))
    ms = None if mask is None else _block(mask.detach(), pg, S, 1)
    out = _ring_local(qs, ks, vs, pg, S, scale, ms, mask_fill)
    return C.all_gather(out, pg, axis=2)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over ``mesh``'s 'seq' group (module docstring)."""
    return _ring(q, k, v, mesh, scale)


def ring_masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor, mesh, scale: Optional[float] = None,
                          mask_fill: float = MASK_FILL) -> torch.Tensor:
    """The HMA masked attention (mask [B, N], 1 = keep) as the masked ring
    over ``mesh``'s 'seq' group: the key mask rotates with k and v."""
    return _ring(q, k, v, mesh, scale, mask, mask_fill)


def _full_attention(q, k, v, scale):
    cd = compute_dtype(q.dtype)
    p = torch.softmax(torch.matmul(q.to(cd), k.to(cd).transpose(-1, -2)) * scale, dim=-1)
    return torch.matmul(p.to(v.dtype).to(cd), v.to(cd)).to(q.dtype)


def _ulysses(q, k, v, mesh, scale, mask=None, mask_fill=MASK_FILL):
    from editor_tpu_torch import ops
    pg, S = _group(mesh)
    _check(q, S, heads=True)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    # sequence-sharded -> head-sharded: [B, H/S, N, D] for the whole sequence
    qh, kh, vh = (C.all_to_all(_block(t, pg, S, 2), pg, 1, 2) for t in (q, k, v))
    if mask is None:
        out = _full_attention(qh, kh, vh, scale)
    else:
        B, Hs, N, D = qh.shape
        qkv = torch.cat([t.transpose(1, 2).reshape(B, N, Hs * D) for t in (qh, kh, vh)],
                        dim=-1)
        out = ops.masked_attention_qkv_fn(qkv, mask.detach(), Hs, scale, mask_fill)
        out = out.reshape(B, N, Hs, D).transpose(1, 2)
    out = C.all_to_all(out, pg, 2, 1)  # head-sharded -> sequence-sharded
    return C.all_gather(out, pg, axis=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Ulysses over ``mesh``'s 'seq' group (module docstring)."""
    return _ulysses(q, k, v, mesh, scale)


def ulysses_masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             mask: torch.Tensor, mesh, scale: Optional[float] = None,
                             mask_fill: float = MASK_FILL) -> torch.Tensor:
    """Ulysses with the HMA masked attention on the gathered sequence, the
    full mask [B, N] on every rank (K3 on the card)."""
    return _ulysses(q, k, v, mesh, scale, mask, mask_fill)
