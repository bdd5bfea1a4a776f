"""k-reciprocal re-ranking (Zhong et al., CVPR 2017): the port's copy of
``editor_tpu/evals/reranking.py`` (reference: utils/reranking.py, invoked
with k1=50, k2=15, lambda=0.3 by the evaluator).

  1. union distmat over query+gallery, rows rescaled by column max,
  2. k-reciprocal neighbor sets R(p) = {q : q in topk1(p) and p in topk1(q)},
  3. expansion: add R_half(q) (k1/2 sets) when it overlaps R(p) by > 2/3,
  4. Gaussian-weighted sparse membership vectors V,
  5. local query expansion: V <- mean of V over top-k2 neighbors,
  6. Jaccard distance from min/sum of V overlaps via inverted index,
  7. final = lambda * original + (1 - lambda) * jaccard.

Host-side numpy with fp32 accumulation (the reference's fp16 is a memory
optimisation that loses precision).
"""

from __future__ import annotations

import numpy as np


def _squared_distmat(feat: np.ndarray) -> np.ndarray:
    sq = np.sum(feat ** 2, axis=1)
    d = sq[:, None] + sq[None, :] - 2.0 * feat @ feat.T
    return np.maximum(d, 0.0)


def _k_reciprocal_set(rank: np.ndarray, i: int, k: int) -> np.ndarray:
    """Indices q with q in topk(i) and i in topk(q)."""
    forward = rank[i, : k + 1]
    backward = rank[forward, : k + 1]
    return forward[np.any(backward == i, axis=1)]


def k_reciprocal_rerank(prob_feat: np.ndarray, gal_feat: np.ndarray,
                        k1: int = 20, k2: int = 6,
                        lambda_value: float = 0.3,
                        local_distmat: np.ndarray | None = None,
                        only_local: bool = False) -> np.ndarray:
    """Returns the re-ranked [num_query, num_gallery] distance matrix."""
    nq = prob_feat.shape[0]
    if only_local:
        original = np.asarray(local_distmat, dtype=np.float32)
    else:
        feat = np.concatenate([np.asarray(prob_feat, np.float32),
                               np.asarray(gal_feat, np.float32)], axis=0)
        original = _squared_distmat(feat)
        if local_distmat is not None:
            original = original + local_distmat
    n = original.shape[0]
    original = (original / np.max(original, axis=0, keepdims=True)).T.astype(np.float32)
    rank = np.argsort(original, axis=1).astype(np.int32)

    half = int(np.around(k1 / 2))
    V = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        r_set = _k_reciprocal_set(rank, i, k1)
        expansion = [r_set]
        for q in r_set:
            r_half = _k_reciprocal_set(rank, int(q), half)
            if len(np.intersect1d(r_half, r_set)) > (2.0 / 3.0) * len(r_half):
                expansion.append(r_half)
        idx = np.unique(np.concatenate(expansion))
        w = np.exp(-original[i, idx])
        V[i, idx] = w / np.sum(w)

    original = original[:nq]
    if k2 != 1:
        Vq = np.empty_like(V)
        for i in range(n):
            Vq[i] = V[rank[i, :k2]].mean(axis=0)
        V = Vq

    nonzero_rows = [np.nonzero(V[:, j])[0] for j in range(n)]

    jaccard = np.zeros((nq, n), dtype=np.float32)
    for i in range(nq):
        overlap = np.zeros(n, dtype=np.float32)
        cols = np.nonzero(V[i])[0]
        for j in cols:
            rows = nonzero_rows[j]
            overlap[rows] += np.minimum(V[i, j], V[rows, j])
        jaccard[i] = 1.0 - overlap / (2.0 - overlap)

    final = jaccard * (1.0 - lambda_value) + original * lambda_value
    return final[:, nq:]
