"""SFTS: spatial-frequency token selection.

Counterpart of ``editor_tpu/models/sfts.py``: per-head top-k of each
modality's rollout cls row, OR-ed over heads, across modalities and with the
frequency mask; the union multiplies the patch tokens. In training,
:func:`bcc_loss` adds the background consistency loss (``sfts_select``'s
``bcc``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from editor_tpu_torch.models.frequency import topk_bool_mask


def part_attention_mask(rollout_cls: torch.Tensor, keep_per_head: int) -> torch.Tensor:
    """[B, H, P] rollout cls rows -> [B, P] bool: per-head top-k, OR over heads."""
    B, H, P = rollout_cls.shape
    per_head = topk_bool_mask(rollout_cls.reshape(B * H, P), keep_per_head)
    return per_head.reshape(B, H, P).any(dim=1)


def sfts_select(feats: List[torch.Tensor], rollouts: List[torch.Tensor],
                mask_fre: torch.Tensor, keep_per_head: int
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """feats: per-modality [B, 1+P, C]; rollouts: per-modality [B, H, P];
    mask_fre: [B, P] bool. Returns (masked feats with the cls token kept,
    index [B, P, 1] in the feats' dtype)."""
    union = mask_fre
    for r in rollouts:
        union = union | part_attention_mask(r, keep_per_head)
    index = union[:, :, None].to(feats[0].dtype)
    masked = [torch.cat([f[:, :1], f[:, 1:] * index], dim=1) for f in feats]
    return masked, index


def bcc_loss(feats: List[torch.Tensor], index: torch.Tensor) -> torch.Tensor:
    """Background consistency (BCC): the sum over modality pairs of the mean
    squared difference of their background patch tokens (patches outside the
    union ``index`` [B, P, 1]), from the unmasked per-modality [B, 1+P, C]
    tokens. In fp32 whatever the tokens' dtype, as the JAX function computes
    it (so an fp64 run rounds here too)."""
    bg = (1.0 - index).to(torch.float32)
    bgs = [f[:, 1:].to(torch.float32) * bg for f in feats]
    loss = torch.zeros((), dtype=torch.float32, device=index.device)
    for i in range(len(bgs)):
        for j in range(i + 1, len(bgs)):
            loss = loss + (bgs[i] - bgs[j]).square().mean()
    return loss
