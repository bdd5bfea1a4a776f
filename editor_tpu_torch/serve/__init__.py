"""Feature serving: request batching and a retrieval gallery.

Counterpart of ``editor_tpu/serve/__init__.py``:

* :class:`FeatureExtractor` runs the eval step on request batches: full
  chunks at ``batch_size``, a short tail (or a short request) padded only to
  the next power of two and trimmed, so a single query costs one image of
  compute. The buckets bound the set of batch shapes, which a shape-keyed
  cache (CUDA graphs) needs; the eager forward gains nothing from them and
  pays for up to almost twice the images of a tail (17 runs as 32);
* :class:`GalleryIndex` is an in-memory float32 feature index with the
  offline-eval squared-euclidean distance over (optionally L2-normalised)
  features, saved and loaded as ``.npz``.

Not ported yet: k-reciprocal re-ranking (``search(reranking=True)``) and the
HTTP ``RetrievalServer``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from editor_tpu_torch.data.transforms import make_eval_transform
from editor_tpu_torch.engine.evaluate import build_eval_step
from editor_tpu_torch.models.editor import MODALITIES, Editor

__all__ = ["FeatureExtractor", "GalleryIndex"]


class FeatureExtractor:
    """Pad-and-trim wrapper around the eval step for uint8 request images.

    ``input_cfg``: the INPUT section of a :class:`~editor_tpu_torch.config.Config`
    (as the JAX extractor takes ``cfg.INPUT``): the images are normalised with
    its ``PIXEL_MEAN``/``PIXEL_STD`` and ``size_hw`` is its ``SIZE_TEST``.
    Without it: mean and std 0.5 and the model's input size."""

    def __init__(self, model: Editor, batch_size: int = 32,
                 compute_dtype: torch.dtype = torch.bfloat16, input_cfg=None):
        self.model = model
        self.batch_size = int(batch_size)
        self.device = next(model.parameters()).device
        self._step = build_eval_step(model, compute_dtype)
        if input_cfg is None:
            self._transform = make_eval_transform()
            self.size_hw = tuple(model.cfg.vit.img_size)
        else:
            self._transform = make_eval_transform(tuple(input_cfg.PIXEL_MEAN),
                                                  tuple(input_cfg.PIXEL_STD))
            self.size_hw = tuple(input_cfg.SIZE_TEST)

    @property
    def feat_dim(self) -> int:
        cfg = self.model.cfg
        return cfg.num_modalities * cfg.vit.embed_dim

    def __call__(self, images: Dict[str, np.ndarray],
                 camids: Optional[np.ndarray] = None) -> np.ndarray:
        """images: {modality: [N, H, W, 3] uint8}; returns [N, feat_dim] f32."""
        mods = [m for m in MODALITIES if m in images]
        if not mods:
            raise ValueError("no modalities in request")
        n = len(images[mods[0]])
        if n == 0:
            return np.zeros((0, self.feat_dim), np.float32)
        if camids is None:
            camids = np.zeros((n,), np.int32)
        feats = []
        B = self.batch_size
        for lo in range(0, n, B):
            chunk = {m: images[m][lo:lo + B] for m in mods}
            cam = np.asarray(camids[lo:lo + B], np.int32)
            take = len(cam)
            if take < B:  # pad to the next power-of-two bucket <= B
                bucket = 1
                while bucket < take:
                    bucket *= 2
                chunk = {m: np.concatenate([v, np.repeat(v[-1:], bucket - take, axis=0)])
                         for m, v in chunk.items()}
                cam = np.concatenate([cam, np.full(bucket - take, cam[-1], np.int32)])
            batch = {m: self._transform(torch.from_numpy(np.ascontiguousarray(v))
                                        .to(self.device)) for m, v in chunk.items()}
            batch["camid"] = torch.from_numpy(cam).to(self.device)
            feats.append(self._step(batch)[:take].cpu().numpy())
        return np.concatenate(feats, axis=0)


class GalleryIndex:
    """Feature gallery with the offline-eval retrieval semantics:
    squared-euclidean distance over (optionally L2-normalised) float32
    features, as ``evals.metrics.euclidean_distmat``."""

    def __init__(self, feat_dim: int, feat_norm: bool = True):
        self.feat_dim = int(feat_dim)
        self.feat_norm = bool(feat_norm)
        self._feats: List[np.ndarray] = []
        self._pids: List[int] = []
        self._camids: List[int] = []
        self._paths: List[str] = []
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._pids)

    @staticmethod
    def _norm(f: np.ndarray) -> np.ndarray:
        return f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)

    def add(self, feats: np.ndarray, pids: Sequence[int],
            camids: Optional[Sequence[int]] = None,
            paths: Optional[Sequence[str]] = None) -> None:
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 2 or feats.shape[1] != self.feat_dim:
            raise ValueError(f"features {feats.shape} != (N, {self.feat_dim})")
        n = len(feats)
        camids = list(camids) if camids is not None else [0] * n
        paths = list(paths) if paths is not None else [""] * n
        if not (len(pids) == len(camids) == len(paths) == n):
            raise ValueError("length mismatch")
        with self._lock:
            self._feats.append(feats)
            self._pids.extend(int(p) for p in pids)
            self._camids.extend(int(c) for c in camids)
            self._paths.extend(paths)

    def _gallery(self) -> np.ndarray:
        with self._lock:
            if not self._feats:
                return np.zeros((0, self.feat_dim), np.float32)
            if len(self._feats) > 1:
                self._feats = [np.concatenate(self._feats, axis=0)]
            return self._feats[0]

    def search(self, qf: np.ndarray, topk: int = 5,
               reranking: bool = False) -> List[List[dict]]:
        """qf: [Q, feat_dim] -> per-query ranked matches (best first)."""
        if reranking:
            raise NotImplementedError("k-reciprocal re-ranking is not ported yet")
        gf = self._gallery()
        if len(gf) == 0:
            return [[] for _ in range(len(qf))]
        qf = np.asarray(qf, np.float32)
        if self.feat_norm:
            qf, gf = self._norm(qf), self._norm(gf)
        dist = (np.square(qf).sum(1)[:, None] + np.square(gf).sum(1)[None, :]
                - 2.0 * (qf @ gf.T))
        k = min(int(topk), len(gf))
        order = np.argsort(dist, axis=1)[:, :k]
        return [[{"pid": self._pids[gi], "camid": self._camids[gi],
                  "path": self._paths[gi], "dist": float(dist[qi, gi])}
                 for gi in row] for qi, row in enumerate(order)]

    def save(self, path: str) -> None:
        gf = self._gallery()
        np.savez_compressed(
            path, feats=gf, pids=np.asarray(self._pids, np.int64),
            camids=np.asarray(self._camids, np.int64),
            paths=np.asarray(self._paths, dtype=np.str_),
            feat_norm=np.asarray(self.feat_norm))

    @classmethod
    def load(cls, path: str) -> "GalleryIndex":
        """Reads the port's files (``paths`` as ``np.str_``) and the JAX
        package's (``paths`` as ``dtype=object``, which only a pickle-enabled
        load can read). Pickle is enabled for ``paths`` of the second kind
        alone; every other key is read without it."""
        with np.load(path) as z:
            idx = cls(int(z["feats"].shape[1]), bool(z["feat_norm"]))
            try:
                paths = z["paths"]
            except ValueError:  # an object array: the JAX package's layout
                with np.load(path, allow_pickle=True) as zp:
                    paths = zp["paths"]
            idx.add(z["feats"], z["pids"].tolist(), z["camids"].tolist(),
                    [str(p) for p in paths.tolist()])
        return idx
