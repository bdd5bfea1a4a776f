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
  features, or k-reciprocal re-ranking of it, saved and loaded as ``.npz``;
* :class:`RetrievalServer` is a stdlib threaded HTTP JSON API (``GET
  /healthz``, ``POST /query``, ``POST /gallery/add``) for multi-modal
  (RGB/NI/TI) query images sent as base64 JPEG/PNG.

The handler threads share one extractor: its forward runs under a lock, one
request at a time on the device's stream, so the kernels' launch counters
and the eager forward see no concurrent call. Run the server with
``python -m editor_tpu_torch.cli.serve``.
"""

from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from editor_tpu_torch.data.transforms import make_eval_transform
from editor_tpu_torch.engine.evaluate import build_eval_step
from editor_tpu_torch.models.editor import MODALITIES, Editor

__all__ = ["FeatureExtractor", "GalleryIndex", "RetrievalServer"]


class FeatureExtractor:
    """Pad-and-trim wrapper around the eval step for uint8 request images.

    ``input_cfg``: the INPUT section of a :class:`~editor_tpu_torch.config.Config`
    (as the JAX extractor takes ``cfg.INPUT``): the images are normalised with
    its ``PIXEL_MEAN``/``PIXEL_STD`` and ``size_hw`` is its ``SIZE_TEST``.
    Without it: mean and std 0.5 and the model's input size.

    ``mesh`` (a ('data', 'model') ``DeviceMesh``, as JAX's extractor takes):
    each request's rows are cut over the data axis and, with a model axis
    above 1, the backbone runs tensor-parallel (the model cut by
    ``parallel.tp.shard_editor``). Every rank must make the same calls; the
    tail is padded to ``batch_size`` (the power-of-two buckets are the
    one-device path's). ``cli.serve`` serves on one device."""

    def __init__(self, model: Editor, batch_size: int = 32,
                 compute_dtype: torch.dtype = torch.bfloat16, input_cfg=None, mesh=None):
        self.model = model
        self.batch_size = int(batch_size)
        self.device = next(model.parameters()).device
        self._step = build_eval_step(model, compute_dtype, mesh)
        self._bucketed = mesh is None
        self._lock = threading.Lock()
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
                bucket = 1 if self._bucketed else B
                while bucket < take:
                    bucket *= 2
                chunk = {m: np.concatenate([v, np.repeat(v[-1:], bucket - take, axis=0)])
                         for m, v in chunk.items()}
                cam = np.concatenate([cam, np.full(bucket - take, cam[-1], np.int32)])
            batch = {m: self._transform(torch.from_numpy(np.ascontiguousarray(v))
                                        .to(self.device)) for m, v in chunk.items()}
            batch["camid"] = torch.from_numpy(cam).to(self.device)
            with self._lock:
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
        """qf: [Q, feat_dim] -> per-query ranked matches (best first).
        ``reranking``: k-reciprocal re-ranking over the queries and the
        gallery through ``native.rerank_auto``, with k1 = min(50, G),
        k2 = min(15, G), lambda 0.3 (the JAX index's call)."""
        gf = self._gallery()
        if len(gf) == 0:
            return [[] for _ in range(len(qf))]
        qf = np.asarray(qf, np.float32)
        if self.feat_norm:
            qf, gf = self._norm(qf), self._norm(gf)
        if reranking:
            from editor_tpu_torch.native import rerank_auto
            dist = rerank_auto(qf, gf, k1=min(50, len(gf)), k2=min(15, len(gf)),
                               lambda_value=0.3)
        else:
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


def _decode_b64_image(data: str, size_hw) -> np.ndarray:
    """A base64 JPEG/PNG -> uint8 [H, W, 3] RGB at ``size_hw`` (bicubic
    resize where the size differs), through PIL."""
    from PIL import Image
    img = Image.open(io.BytesIO(base64.b64decode(data))).convert("RGB")
    h, w = size_hw
    if img.size != (w, h):
        img = img.resize((w, h), Image.BICUBIC)
    return np.asarray(img, np.uint8)


class RetrievalServer:
    """Threaded HTTP JSON retrieval service (stdlib only).

    Endpoints:
      GET  /healthz            -> {"status", "gallery_size", "feat_dim"}
      POST /query              -> {"images": {mod: b64}, "topk", "camid",
                                   "reranking"} -> {"matches": [...]}
      POST /gallery/add        -> {"images": ..., "pid", "camid", "path"}
    Images: base64 JPEG/PNG per modality; a missing NI is filled from RGB
    and a missing TI from NI (the reference's 2-modal NI->TI duplication,
    make_dataloader.py:190-216). A request that fails answers 400 with
    {"error": "<type>: <message>"}; an unknown path 404."""

    def __init__(self, extractor: FeatureExtractor, index: GalleryIndex,
                 host: str = "127.0.0.1", port: int = 0):
        self.extractor = extractor
        self.index = index
        serve = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"status": "ok", "gallery_size": len(serve.index),
                                      "feat_dim": serve.index.feat_dim})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == "/query":
                        self._reply(200, serve._query(req))
                    elif self.path == "/gallery/add":
                        self._reply(200, serve._add(req))
                    else:
                        self._reply(404, {"error": "not found"})
                except Exception as e:  # noqa: BLE001 -- reported to the client
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        return self._httpd.server_address

    def _images_from(self, req: dict) -> Dict[str, np.ndarray]:
        enc = req.get("images") or {}
        if "RGB" not in enc:
            raise ValueError("request needs at least an RGB image")
        size = self.extractor.size_hw
        imgs = {m: _decode_b64_image(enc[m], size) for m in MODALITIES if m in enc}
        # 2-modal requests duplicate NI into TI like the dataset collate;
        # RGB fills in only when NI is absent too
        imgs.setdefault("NI", imgs["RGB"])
        imgs.setdefault("TI", imgs["NI"])
        return {m: v[None] for m, v in imgs.items()}

    def _query(self, req: dict) -> dict:
        imgs = self._images_from(req)
        cam = np.asarray([int(req.get("camid", 0))], np.int32)
        feat = self.extractor(imgs, cam)
        matches = self.index.search(feat, topk=int(req.get("topk", 5)),
                                    reranking=bool(req.get("reranking", False)))[0]
        return {"matches": matches}

    def _add(self, req: dict) -> dict:
        imgs = self._images_from(req)
        cam = np.asarray([int(req.get("camid", 0))], np.int32)
        feat = self.extractor(imgs, cam)
        self.index.add(feat, [int(req.get("pid", -1))], [int(req.get("camid", 0))],
                       [str(req.get("path", ""))])
        return {"ok": True, "gallery_size": len(self.index)}

    def start(self) -> None:
        """Serve from a daemon thread (``shutdown`` stops it)."""
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd.server_close()
