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


def build_eval_step(model: Editor, compute_dtype: torch.dtype = torch.bfloat16, mesh=None
                    ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Returns extract(batch) -> [B, M*dim] float32 features.

    ``batch`` holds normalised NHWC images under 'RGB', 'NI' and optionally
    'TI' (on the model's device), and optionally 'camid' [B]. The images are
    cast to ``compute_dtype`` and the model runs in inference mode.

    ``mesh`` (a ``DeviceMesh``): every rank passes the same batch, runs its
    block of the rows (the batch padded to a multiple of W, the data axis's
    size, by repeating its last row) and gets every rank's features,
    all-gathered, with the padding trimmed (the JAX step's data-sharded
    batch). With a model axis above 1 the backbone runs tensor-parallel
    over it (the model cut by ``parallel.tp.shard_editor``). On a data
    axis above 1 the model sees the data group, so a MoE model routes the
    global batch, as JAX's jitted step does: slots in global order, the
    padding last, and the capacity from the real rows' tokens
    (``Editor.forward(batch_group=, valid_rows=)``); the features are the
    one-device eval's."""
    from editor_tpu_torch.parallel.mesh import data_size, model_size, shard_batch
    tp_mesh = mesh if model_size(mesh) > 1 else None
    group = mesh if mesh is not None and data_size(mesh) > 1 else None

    def run(batch: Dict[str, torch.Tensor], rows: Optional[int] = None) -> torch.Tensor:
        images = {k: batch[k].to(compute_dtype) for k in MODALITIES if k in batch}
        with torch.inference_mode():
            feat = model(images, cam_ids=batch.get("camid"), training=False,
                         tp_mesh=tp_mesh, batch_group=group, valid_rows=rows)
        return feat.to(torch.float32)

    if mesh is None:
        return run
    from editor_tpu_torch.parallel import collectives as C

    W = data_size(mesh)

    def extract(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        n = len(next(iter(batch.values())))
        pad = (-n) % W
        if pad:
            batch = {k: torch.cat([v, v[-1:].expand((pad,) + v.shape[1:])])
                     for k, v in batch.items()}
        feat = run(shard_batch(mesh, {k: v for k, v in batch.items()
                                      if k in MODALITIES or k == "camid"}), n)
        with torch.inference_mode():
            return C.all_gather(feat, mesh)[:n]

    return extract


def do_inference(model: Editor, val_loader: Iterable, num_query: int,
                 feat_norm: bool = True, reranking: bool = False,
                 msvr_protocol: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 rank_list_path: Optional[str] = None, mesh=None):
    """Extract the features of the query + gallery set and compute CMC and
    mAP: ``R1mAPEvaluator.compute``'s (cmc, mAP, distmat, pids, camids, qf, gf).

    ``val_loader`` yields batches of normalised images under 'RGB', 'NI',
    'TI' (tensors on the model's device) with 'pid', 'camid' and, for
    MSVR310, 'sceneid'; the first ``num_query`` rows are the queries.
    ``rank_list_path``: where the MSVR310 protocol writes its rank list.
    ``mesh``: every rank iterates the same batches, extracts its rows of
    each (``build_eval_step(mesh=)``) and scores all of them, so every rank
    returns the same metric."""
    evaluator = R1mAPEvaluator(num_query, feat_norm=feat_norm, reranking=reranking,
                               msvr_protocol=msvr_protocol, rank_list_path=rank_list_path)
    step = build_eval_step(model, compute_dtype, mesh)
    for batch in val_loader:
        evaluator.update(step(batch), batch["pid"], batch["camid"], batch.get("sceneid"))
    return evaluator.compute()
