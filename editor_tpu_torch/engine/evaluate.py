"""Inference engine: feature extraction and the R1/mAP evaluation.

Counterpart of ``editor_tpu/engine/evaluate.py`` (reference:
engine/processor.py ``do_inference``): ``build_eval_step`` extracts the
``cls4t`` features of a batch, ``do_inference`` runs it over a loader and
scores query against gallery with :class:`~editor_tpu_torch.evals.metrics.R1mAPEvaluator`
on the features' device.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

from editor_tpu_torch.evals.metrics import R1mAPEvaluator
from editor_tpu_torch.models.editor import MODALITIES, Editor


def build_eval_step(model: Editor, compute_dtype: torch.dtype = torch.bfloat16
                    ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Returns extract(batch) -> [B, M*dim] float32 features.

    ``batch`` holds normalised NHWC images under 'RGB', 'NI' and optionally
    'TI' (on the model's device), and optionally 'camid' [B]. The images are
    cast to ``compute_dtype`` and the model runs in inference mode."""

    def extract(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        images = {k: batch[k].to(compute_dtype) for k in MODALITIES if k in batch}
        with torch.inference_mode():
            feat = model(images, cam_ids=batch.get("camid"), training=False)
        return feat.to(torch.float32)

    return extract


def do_inference(model: Editor, val_loader: Iterable, num_query: int,
                 feat_norm: bool = True, reranking: bool = False,
                 msvr_protocol: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 rank_list_path: Optional[str] = None):
    """Extract the features of the query + gallery set and compute CMC and
    mAP: ``R1mAPEvaluator.compute``'s (cmc, mAP, distmat, pids, camids, qf, gf).

    ``val_loader`` yields batches of normalised images under 'RGB', 'NI',
    'TI' (tensors on the model's device) with 'pid', 'camid' and, for
    MSVR310, 'sceneid'; the first ``num_query`` rows are the queries.
    ``rank_list_path``: where the MSVR310 protocol writes its rank list."""
    evaluator = R1mAPEvaluator(num_query, feat_norm=feat_norm, reranking=reranking,
                               msvr_protocol=msvr_protocol, rank_list_path=rank_list_path)
    step = build_eval_step(model, compute_dtype)
    for batch in val_loader:
        evaluator.update(step(batch), batch["pid"], batch["camid"], batch.get("sceneid"))
    return evaluator.compute()
