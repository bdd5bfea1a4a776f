"""k-reciprocal re-ranking on the features' device: batched, fixed-k, masked.

Counterpart of ``editor_tpu/evals/reranking_jax.py`` (``_rerank_core``,
``k_reciprocal_rerank_jax``). The set algebra of the reference algorithm
(utils/reranking.py:29-100) as dense masked linear algebra:

  * forward top-(k+1) lists -> boolean membership matrix F (scatter),
  * k-reciprocal mask R = F & F^T,
  * expansion: E = R | ((R & cond^T) @ R_half > 0), where cond thresholds
    the |R_half(j) & R(i)| overlap computed as one matmul,
  * V = row-normalised exp(-d) under E; query expansion V = G @ V with G the
    top-k2 averaging matrix,
  * the Jaccard min-sum in tiles of ``q_block`` queries against every row.

The JAX version is plain XLA ops outside any Pallas kernel; this one is
plain PyTorch ops (``torch.topk``, ``scatter_``, ``@``) on the features'
device. Memory is O(n^2) for the masks and V plus ``q_block`` x n x n fp32
for a tile's min-sum (n = queries + gallery: 1.43 GB at n = 1672). Nothing
routes to it: the evaluator and the gallery re-rank through
``native.rerank_auto``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from editor_tpu_torch.models.editor import default_device


def _membership(rank_idx: torch.Tensor, n: int) -> torch.Tensor:
    """[n, k] neighbour indices -> [n, n] bool membership matrix."""
    out = torch.zeros((n, n), dtype=torch.bool, device=rank_idx.device)
    return out.scatter_(1, rank_idx, True)


def _rerank_core(original: torch.Tensor, nq: int, k1: int, k2: int,
                 lambda_value: float, q_block: int = 128) -> torch.Tensor:
    """original: [n, n] fp32 (rescaled and transposed distances) -> [nq, n - nq]."""
    n = original.shape[0]
    half = int(round(k1 / 2))

    neg = -original
    fwd_k1 = torch.topk(neg, k1 + 1, dim=1).indices
    fwd_half = torch.topk(neg, half + 1, dim=1).indices
    fwd_k2 = torch.topk(neg, k2, dim=1).indices

    F = _membership(fwd_k1, n)
    R = F & F.T
    Fh = _membership(fwd_half, n)
    Rh = Fh & Fh.T

    Rf = R.to(torch.float32)
    Rhf = Rh.to(torch.float32)
    overlap = Rhf @ Rf.T  # overlap[j, i] = |Rh(j) & R(i)|
    sizes = Rhf.sum(dim=1, keepdim=True)
    cond = overlap > (2.0 / 3.0) * sizes  # [j, i]
    extra = ((R & cond.T).to(torch.float32) @ Rhf) > 0
    E = R | extra

    V = torch.where(E, torch.exp(-original), torch.zeros((), device=original.device))
    V = V / V.sum(dim=1, keepdim=True)
    # local query expansion
    G = _membership(fwd_k2, n).to(torch.float32) / k2
    V = G @ V

    rows = []
    for lo in range(0, nq, q_block):
        v_tile = V[lo:min(lo + q_block, nq)]
        minsum = torch.minimum(v_tile[:, None, :], V[None, :, :]).sum(dim=-1)
        jac = 1.0 - minsum / (2.0 - minsum)
        rows.append(jac * (1.0 - lambda_value) + original[lo:lo + len(v_tile)] * lambda_value)
    return torch.cat(rows)[:, nq:]


def k_reciprocal_rerank_device(prob_feat, gal_feat, k1: int = 20, k2: int = 6,
                               lambda_value: float = 0.3, device=None) -> np.ndarray:
    """Re-ranking on a device; the numpy and native versions' contract:
    [nq, ng] float32 distances as numpy. Tensors run on their own device;
    numpy features on ``device`` (by default the current CUDA device)."""
    if isinstance(prob_feat, torch.Tensor):
        device = prob_feat.device
    else:
        device = default_device(device)

    def tensor(x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    q, g = tensor(prob_feat), tensor(gal_feat)
    with torch.inference_mode():
        feat = torch.cat([q, g])
        sq = (feat * feat).sum(dim=1)
        d = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * feat @ feat.T, min=0.0)
        original = (d / d.max(dim=0, keepdim=True).values).T.contiguous()
        return _rerank_core(original, q.shape[0], k1, k2, lambda_value).cpu().numpy()
