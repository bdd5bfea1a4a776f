"""ReID retrieval metrics (CMC, mAP) and k-reciprocal re-ranking."""

from editor_tpu_torch.evals.metrics import (R1mAPEvaluator, cmc_map, cmc_map_msvr,
                                            euclidean_distmat, write_rank_list)
from editor_tpu_torch.evals.reranking import k_reciprocal_rerank

__all__ = ["R1mAPEvaluator", "cmc_map", "cmc_map_msvr", "euclidean_distmat",
           "k_reciprocal_rerank", "write_rank_list"]
