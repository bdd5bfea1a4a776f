"""Feature extraction step of the eval engine.

Counterpart of ``build_eval_step`` in ``editor_tpu/engine/evaluate.py``.
``do_inference`` and the R1/mAP evaluator are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

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
