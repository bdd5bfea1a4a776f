"""The model's operations and the attention bound, counted from a
configuration's shapes, frozen in the benchmark so that the program's own
counters (``ops/_flops.py``, ``utils/profiling.py``) cannot move them.

Conventions (``chip_smoke.py``'s bound, ``tools/_bench.py``):

* a product of [r, k] by [k, n] is 2 r k n operations;
* attention counts every query-key pair of the backbone (q k^T and p v,
  4 N^2 C per sequence forward, 10 N^2 C backward); the fusion block's
  masked attention and its products count the tokens its mask keeps, which
  is what these inputs need;
* an attention call's bytes are its inputs read once and its outputs
  written once in bf16 (K1 also writes its probabilities);
* training counts three times the forward; recompute is not counted.

``valid`` below is, per sample, 1 + the patch tokens the fusion's mask keeps
(the same for every modality), passed as its sum and its sum of squares
over the rows of one forward.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from benchmark.yardstick.peaks import bound_s


@dataclasses.dataclass(frozen=True)
class ModelShape:
    img: Tuple[int, int]
    patch: int
    stride: Tuple[int, int]
    dim: int
    depth: int
    heads: int
    mlp_ratio: float
    fusion_mlp_ratio: float
    modalities: int
    num_classes: int
    al: bool

    @classmethod
    def from_config(cls, cfg: dict) -> "ModelShape":
        m = cfg["model"]
        return cls(img=tuple(m["img_size"]), patch=m["patch_size"],
                   stride=tuple(m["stride_size"]), dim=m["embed_dim"], depth=m["depth"],
                   heads=m["num_heads"], mlp_ratio=m["mlp_ratio"],
                   fusion_mlp_ratio=m["fusion_mlp_ratio"],
                   modalities=m["modalities"], num_classes=cfg["num_classes"],
                   al=bool(m["al"]))

    @property
    def patches(self) -> int:
        gh = (self.img[0] - self.patch) // self.stride[0] + 1
        gw = (self.img[1] - self.patch) // self.stride[1] + 1
        return gh * gw

    @property
    def tokens(self) -> int:
        return self.patches + 1

    @property
    def hidden(self) -> int:
        return int(self.dim * self.mlp_ratio)

    @property
    def fusion_hidden(self) -> int:
        return int(self.dim * self.fusion_mlp_ratio)


def linear_flops(rows: int, d_in: int, d_out: int) -> float:
    return 2.0 * rows * d_in * d_out


def backbone_image_flops(s: ModelShape) -> float:
    """One image through the patch embedding, the blocks and the rollout."""
    C, N = s.dim, s.tokens
    conv = linear_flops(s.patches, 3 * s.patch * s.patch, C)
    block = (linear_flops(N, C, 3 * C) + 4.0 * N * N * C + linear_flops(N, C, C)
             + linear_flops(N, C, s.hidden) + linear_flops(N, s.hidden, C))
    rollout = 2.0 * (s.depth - 1) * s.heads * N * N
    return conv + s.depth * block + rollout


def fusion_flops(s: ModelShape, sum_valid: float, sum_valid_sq: float) -> float:
    """The fusion block at the kept tokens: the per-modality blocks and the
    joint block over the modalities' kept tokens together."""
    C, M = s.dim, s.modalities
    per_token = 2.0 * C * (3 * C + C + 2 * s.fusion_hidden)
    modal = M * (per_token * sum_valid + 4.0 * C * sum_valid_sq)
    joint = per_token * M * sum_valid + 4.0 * C * M * M * sum_valid_sq
    return modal + joint


def head_flops(s: ModelShape, rows: int, training: bool) -> float:
    """The reduce heads; in training the BN-neck classifiers too."""
    C, M, K = s.dim, s.modalities, s.num_classes
    out = M * linear_flops(rows, 2 * C, C)
    if training:
        out += linear_flops(rows, M * C, K)
        out += linear_flops(rows, M * C, K) if s.al else M * linear_flops(rows, C, K)
    return out


def forward_flops(s: ModelShape, rows: int, sum_valid: float, sum_valid_sq: float,
                  training: bool = False) -> float:
    return (s.modalities * rows * backbone_image_flops(s)
            + fusion_flops(s, sum_valid, sum_valid_sq) + head_flops(s, rows, training))


def train_step_flops(s: ModelShape, rows: int, sum_valid: float, sum_valid_sq: float) -> float:
    return 3.0 * forward_flops(s, rows, sum_valid, sum_valid_sq, training=True)


def qkv_attention_call(seqs: int, N: int, C: int, H: int, backward: bool = False
                       ) -> Tuple[float, float]:
    """(operations, bytes) of one backbone attention call over ``seqs``
    sequences of N tokens: K1 reads qkv and writes out and its probs; K4
    reads qkv and the output's cotangent and writes dqkv."""
    if backward:
        return 10.0 * seqs * N * N * C, 2.0 * seqs * N * (3 * C + C + 3 * C)
    return 4.0 * seqs * N * N * C, 2.0 * (seqs * N * 3 * C + seqs * N * C + seqs * H * N * N)


def masked_attention_call(tokens: float, pairs: float, C: int, backward: bool = False
                          ) -> Tuple[float, float]:
    """(operations, bytes) of one masked attention call over its kept
    ``tokens`` and kept query-key ``pairs``."""
    if backward:
        return 10.0 * C * pairs, 2.0 * tokens * (3 * C + C + 3 * C)
    return 4.0 * C * pairs, 2.0 * tokens * (3 * C + C)


def attention_bound_s(s: ModelShape, rows: int, sum_valid: float, sum_valid_sq: float,
                      training: bool) -> float:
    """The least time of one forward's attention work (and, in training, of
    its backward): the backbone's ``depth`` calls over the modality-major
    batch and the fusion's two masked calls, each call bounded alone."""
    C, M = s.dim, s.modalities
    passes: Sequence[bool] = (False, True) if training else (False,)
    total = 0.0
    for bwd in passes:
        total += s.depth * bound_s(*qkv_attention_call(M * rows, s.tokens, C, s.heads, bwd))
        total += bound_s(*masked_attention_call(M * sum_valid, M * sum_valid_sq, C, bwd))
        total += bound_s(*masked_attention_call(M * sum_valid, M * M * sum_valid_sq, C, bwd))
    return total
