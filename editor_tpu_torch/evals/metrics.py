"""ReID retrieval metrics: mAP and CMC as masked cumulative algebra on the
device that holds the features.

Counterpart of ``editor_tpu/evals/metrics.py`` (reference: utils/metrics.py
``eval_func``, ``eval_func_msrv``, ``R1_mAP_eval``). The whole protocol is
one stable argsort of the [Q, G] distances, gathers and cumsums: junk gallery
entries (same pid and camid, or same pid and scene for MSVR310) are skipped
through each entry's effective rank = cumsum(keep), so no array is
compacted. The sort must be stable, as ``jnp.argsort`` is: with tied
distances (duplicate gallery images) any other order moves CMC and mAP. The
distances are the fp32 expansion |q|^2 + |g|^2 - 2 q.g of the JAX package,
so rankings match. The MSVR310 rank-list file sorts a host copy with numpy's
default sort, as the JAX package does, so the file is the same.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _concat(parts) -> np.ndarray:
    return np.concatenate([_numpy(x) for x in parts])


def euclidean_distmat(qf: torch.Tensor, gf: torch.Tensor) -> torch.Tensor:
    """Squared-euclidean distance matrix in fp32 (the squared form is
    monotonic, so rankings are those of the distance)."""
    qf, gf = qf.to(torch.float32), gf.to(torch.float32)
    return (qf.mul(qf).sum(1, keepdim=True) + gf.mul(gf).sum(1, keepdim=True).T
            - 2.0 * (qf @ gf.T))


def rank_order(distmat: torch.Tensor) -> torch.Tensor:
    """Gallery indices of each query row by ascending distance, ties in index
    order."""
    return torch.argsort(distmat, dim=1, stable=True)


def _cmc_map_sums(distmat: torch.Tensor, q_pids: torch.Tensor, g_pids: torch.Tensor,
                  remove_mask: torch.Tensor, max_rank: int = 50):
    """(the CMC hits [max_rank] and AP summed over the valid queries, the
    number of valid queries), fp32 on distmat's device. ``remove_mask``
    [Q, G]: gallery entries to discard per query."""
    Q, G = distmat.shape
    order = rank_order(distmat)
    sorted_match = g_pids[order] == q_pids[:, None]
    sorted_keep = ~torch.gather(remove_mask, 1, order)
    eff_rank = torch.cumsum(sorted_keep.to(torch.int32), dim=1)  # 1-based
    match_valid = sorted_match & sorted_keep
    num_rel = match_valid.sum(dim=1)
    valid_q = num_rel > 0

    # CMC: the first effective rank at which a valid match occurs
    first_rank = torch.where(match_valid, eff_rank,
                             torch.full_like(eff_rank, G + 1)).amin(dim=1)
    ranks = torch.arange(1, max_rank + 1, device=distmat.device)[None, :]
    cmc_per_q = (first_rank[:, None] <= ranks).to(torch.float32)
    cmc = torch.where(valid_q[:, None], cmc_per_q, 0.0).sum(dim=0)

    # AP: precision at each match, averaged over the matches
    cum_match = torch.cumsum(match_valid.to(torch.float32), dim=1)
    prec = cum_match / eff_rank.to(torch.float32).clamp_min(1.0)
    ap = (torch.where(match_valid, prec, 0.0).sum(dim=1)
          / num_rel.to(torch.float32).clamp_min(1.0))
    return cmc, torch.where(valid_q, ap, 0.0).sum(), valid_q.to(torch.float32).sum()


def _cmc_map_core(distmat: torch.Tensor, q_pids: torch.Tensor, g_pids: torch.Tensor,
                  remove_mask: torch.Tensor, max_rank: int = 50):
    """(cmc [max_rank] fp32, mAP, number of valid queries), on distmat's
    device. ``remove_mask`` [Q, G]: gallery entries to discard per query."""
    cmc, ap, n_valid = _cmc_map_sums(distmat, q_pids, g_pids, remove_mask, max_rank)
    return cmc / n_valid, ap / n_valid, n_valid


def sharded_cmc_map(qf, gf, q_pids, g_pids, remove_mask, mesh, max_rank: int = 50):
    """CMC and mAP with the queries sharded over ``mesh``'s data axis and the
    gallery replicated (the JAX ``sharded_cmc_map``, for galleries whose
    [Q, G] distances are the large tensor). Every rank passes the same
    arguments; Q is padded to a multiple of W with queries that never match
    (pid -1, every gallery entry removed), each rank scores its block of
    rows, and the CMC hits, AP sums and valid counts are all-reduced. Returns
    (numpy cmc, float mAP) on every rank."""
    from editor_tpu_torch.parallel import collectives as C
    from editor_tpu_torch.parallel.mesh import data_rank, data_size

    W, r = data_size(mesh), data_rank(mesh)
    dev = qf.device if isinstance(qf, torch.Tensor) else torch.device("cpu")
    qf, gf = _tensor(qf, dev), _tensor(gf, dev)
    q_pids, g_pids = _tensor(q_pids, dev), _tensor(g_pids, dev)
    remove_mask = _tensor(remove_mask, dev)
    pad = (-qf.shape[0]) % W
    if pad:
        qf = torch.cat([qf, qf.new_zeros((pad, qf.shape[1]))])
        q_pids = torch.cat([q_pids, q_pids.new_full((pad,), -1)])
        remove_mask = torch.cat([remove_mask, remove_mask.new_ones((pad, remove_mask.shape[1]))])
    rows = slice(r * (qf.shape[0] // W), (r + 1) * (qf.shape[0] // W))
    cmc, ap, n_valid = _cmc_map_sums(euclidean_distmat(qf[rows], gf), q_pids[rows], g_pids,
                                     remove_mask[rows], max_rank)
    sums = C.all_reduce(torch.cat([cmc, ap[None], n_valid[None]]), mesh, "sum")
    n_valid = sums[-1]
    if float(n_valid) == 0:
        raise RuntimeError("all query identities absent from gallery")
    return _numpy(sums[:max_rank] / n_valid), float(sums[max_rank] / n_valid)


def _protocol(distmat, q_pids, g_pids, q_other, g_other, max_rank: int):
    """Drop the gallery entries that share the query's pid and ``other``
    (camid or sceneid); CMC and mAP over the rest."""
    distmat = distmat if isinstance(distmat, torch.Tensor) else torch.as_tensor(
        np.asarray(distmat))
    dev = distmat.device
    q_pids, g_pids = _tensor(q_pids, dev), _tensor(g_pids, dev)
    remove = ((g_pids[None, :] == q_pids[:, None])
              & (_tensor(g_other, dev)[None, :] == _tensor(q_other, dev)[:, None]))
    cmc, mAP, n_valid = _cmc_map_core(distmat, q_pids, g_pids, remove,
                                      min(max_rank, distmat.shape[1]))
    if float(n_valid) == 0:
        raise RuntimeError("all query identities absent from gallery")
    return _numpy(cmc), float(mAP)


def cmc_map(distmat, q_pids, g_pids, q_camids, g_camids,
            max_rank: int = 50) -> Tuple[np.ndarray, float]:
    """Market1501 protocol: discard gallery entries with the query's (pid,
    camid) (reference eval_func)."""
    return _protocol(distmat, q_pids, g_pids, q_camids, g_camids, max_rank)


def cmc_map_msvr(distmat, q_pids, g_pids, q_camids, g_camids, q_sceneids, g_sceneids,
                 max_rank: int = 50) -> Tuple[np.ndarray, float]:
    """MSVR310 protocol: discard same (pid, sceneid) (reference eval_func_msrv)."""
    return _protocol(distmat, q_pids, g_pids, q_sceneids, g_sceneids, max_rank)


def write_rank_list(path: str, distmat, q_pids, g_pids, q_camids, g_camids,
                    q_sceneids, g_sceneids, max_rank: int = 50) -> None:
    """The MSVR310 per-query rank-list file (the reference's ``re.txt``): a
    header line, then per query ``{pid}_s{scene}_v{cam}:`` and its top
    ``max_rank`` kept gallery entries in the same format."""
    distmat = _numpy(distmat)
    order = np.argsort(distmat, axis=1)
    with open(path, "w") as f:
        f.write("rank list file\n")
        for qi in range(distmat.shape[0]):
            o = order[qi]
            keep = ~((g_pids[o] == q_pids[qi]) & (g_sceneids[o] == q_sceneids[qi]))
            f.write(f"{q_pids[qi]}_s{q_sceneids[qi]}_v{q_camids[qi]}:\n")
            f.write("".join(f"{g_pids[i]}_s{g_sceneids[i]}_v{g_camids[i]}  "
                            for i in o[keep][:max_rank]))
            f.write("\n")


class R1mAPEvaluator:
    """Feature accumulator and metric computation (reference R1_mAP_eval;
    MSVR310 variant R1_mAP). Features stay on their device, and the metric
    runs there; ids go to the host.

    ``rank_list_path``: with the MSVR310 protocol, write the rank-list file
    there. ``reranking``: k-reciprocal re-ranking (k1=50, k2=15, lambda 0.3)
    of the host copies of the features through ``native.rerank_auto`` (C++
    if its library builds, else numpy), as the JAX evaluator."""

    def __init__(self, num_query: int, max_rank: int = 50, feat_norm: bool = True,
                 reranking: bool = False, msvr_protocol: bool = False,
                 rank_list_path: Optional[str] = None):
        self.num_query = num_query
        self.max_rank = max_rank
        self.feat_norm = feat_norm
        self.reranking = reranking
        self.msvr_protocol = msvr_protocol
        self.rank_list_path = rank_list_path
        self.reset()

    def reset(self):
        self.feats: List[torch.Tensor] = []
        self.pids: List = []
        self.camids: List = []
        self.sceneids: List = []

    def update(self, feat, pid, camid, sceneid=None):
        """Keeps the batch as given: ids on the device stay there until
        ``compute``, so an update does not wait for the batch's forward."""
        self.feats.append(feat if isinstance(feat, torch.Tensor) else torch.as_tensor(
            np.asarray(feat)))
        self.pids.append(pid)
        self.camids.append(camid)
        if sceneid is not None:
            self.sceneids.append(sceneid)

    def compute(self):
        """(cmc, mAP, distmat, pids, camids, qf, gf): numpy cmc, distmat and
        ids, float mAP, the (normalised) query and gallery features."""
        feats = torch.cat(self.feats, dim=0)
        if self.feat_norm:
            feats = feats / torch.linalg.norm(feats, dim=1, keepdim=True)
        nq = self.num_query
        qf, gf = feats[:nq], feats[nq:]
        pids, camids = _concat(self.pids), _concat(self.camids)
        q_pids, g_pids = pids[:nq], pids[nq:]
        q_camids, g_camids = camids[:nq], camids[nq:]
        if self.reranking:
            from editor_tpu_torch.native import rerank_auto
            distmat = torch.as_tensor(
                rerank_auto(_numpy(qf), _numpy(gf), k1=50, k2=15, lambda_value=0.3),
                device=feats.device)
        else:
            distmat = euclidean_distmat(qf, gf)
        if self.msvr_protocol:
            sceneids = _concat(self.sceneids)
            cmc, mAP = cmc_map_msvr(distmat, q_pids, g_pids, q_camids, g_camids,
                                    sceneids[:nq], sceneids[nq:], self.max_rank)
            if self.rank_list_path:
                write_rank_list(self.rank_list_path, distmat, q_pids, g_pids, q_camids,
                                g_camids, sceneids[:nq], sceneids[nq:], self.max_rank)
        else:
            cmc, mAP = cmc_map(distmat, q_pids, g_pids, q_camids, g_camids, self.max_rank)
        return cmc, mAP, _numpy(distmat), pids, camids, qf, gf
