"""Host-side data loading: decode, batch assembly and prefetch.

The port's copy of ``editor_tpu/data/loader.py`` (reference:
data/datasets/make_dataloader.py, bases.py ``read_image`` with the wide-JPEG
256-px modality crop; 2-modal datasets duplicate NI as TI). The host only
decodes and resizes (PIL in a thread pool, or a caller's ``decode_fn``) and
hands out uint8 numpy batches that a background thread keeps one batch ahead;
the training loop makes the pinned host-to-device copy, and the augmentation
runs on the device inside the train step (``data/transforms.py``).

With ``DATALOADER.NATIVE_DECODE`` (and no ``decode_fn``) one call of the
native libjpeg codec (``native/imagecodec.cpp``, OpenMP) decodes and resizes
a whole batch; it needs no PIL. Where the codec is unavailable the loader
logs one warning and decodes with PIL; a batch whose decode fails goes
through PIL alone, and three such batches in a row turn the codec off, as in
the JAX loader. PIL is imported where an image is read: the card's machine
is not promised it. Without PIL, the codec and a ``decode_fn``, the first
decode raises.
"""

from __future__ import annotations

import logging
import os.path as osp
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from editor_tpu_torch.data.datasets import DatasetSplits, load_dataset
from editor_tpu_torch.data.sampler import PKSampler, SoftmaxSampler

MODALITY_KEYS = ("RGB", "NI", "TI")
WIDE_TILE_W = 256  # wide-JPEG modality tile width (bases.py:21-26)
WIDE_TILE_H = 128


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("decoding an image needs PIL (Pillow) or a decode_fn; "
                           "neither is present") from e
    return Image


def _read_image(path: str, retries: int = 20):
    """PIL open with an IOError retry loop (reference read_image,
    bases.py:9-41: keeps retrying truncated or locked files)."""
    Image = _pil_image()
    if not osp.exists(path):
        raise IOError(f"{path} does not exist")
    last_err = None
    for _ in range(retries):
        try:
            return Image.open(path).convert("RGB")
        except IOError as e:  # transient filesystem failures
            last_err = e
    raise last_err


def decode_item(paths, size_hw: Tuple[int, int], wide_jpeg: bool,
                num_modalities: int) -> List[np.ndarray]:
    """Decode one item into per-modality uint8 [H, W, 3] arrays, resized
    bicubic to ``size_hw`` (reference transform Resize(..., 3))."""
    Image = _pil_image()
    h, w = size_hw
    out: List[np.ndarray] = []
    if wide_jpeg:
        img = _read_image(paths)
        for i in range(min(img.size[0] // WIDE_TILE_W, num_modalities)):
            tile = img.crop((WIDE_TILE_W * i, 0, WIDE_TILE_W * (i + 1), WIDE_TILE_H))
            out.append(np.asarray(tile.resize((w, h), Image.BICUBIC)))
    else:
        for p in paths[:num_modalities]:
            out.append(np.asarray(_read_image(p).resize((w, h), Image.BICUBIC)))
    while len(out) < 3:  # 2-modal: duplicate NI as TI (collate semantics)
        out.append(out[-1])
    return out


def decode_batch_native(items, size_hw: Tuple[int, int], wide_jpeg: bool,
                        num_modalities: int) -> List[List[np.ndarray]]:
    """Decode and bicubic-resize a batch of items in one native call: per
    item, one uint8 [H, W, 3] array a modality (2-modal items repeat NI as
    TI). ``RuntimeError`` if the codec is unavailable or a decode fails."""
    from editor_tpu_torch.native import decode_resize_batch, decode_resize_multicrop
    h, w = size_hw
    n = len(items)
    if wide_jpeg:  # decode each wide JPEG once, one crop a modality tile
        crops = [[t * WIDE_TILE_W for t in range(num_modalities)] for _ in items]
        arr = decode_resize_multicrop([it[0] for it in items], (h, w), crops,
                                      crop_w=WIDE_TILE_W, crop_h=WIDE_TILE_H)
    else:
        arr = decode_resize_batch([p for it in items for p in it[0][:num_modalities]], (h, w))
    arr = arr.reshape(n, num_modalities, h, w, 3)
    out = [[arr[i, m] for m in range(num_modalities)] for i in range(n)]
    for mods in out:
        while len(mods) < 3:  # 2-modal: duplicate NI as TI
            mods.append(mods[-1])
    return out


class BatchLoader:
    """Assembles index lists into uint8 numpy batches with prefetch."""

    def __init__(self, splits_items: Sequence, size_hw: Tuple[int, int],
                 wide_jpeg: bool, num_modalities: int,
                 has_sceneid: bool = False, num_workers: int = 8,
                 prefetch: int = 2,
                 decode_fn: Optional[Callable] = None,
                 native_decode: bool = False):
        self.items = splits_items
        self.size_hw = size_hw
        self.wide_jpeg = wide_jpeg
        self.num_modalities = num_modalities
        self.has_sceneid = has_sceneid
        # NUM_WORKERS 0 means synchronous decode in torch; one thread here
        self.pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
        self.prefetch = prefetch
        self.decode_fn = decode_fn or (lambda item: decode_item(
            item[0], self.size_hw, self.wide_jpeg, self.num_modalities))
        # the native batch decode applies to the default path only (a
        # decode_fn keeps its per-item semantics)
        self.native_decode = native_decode and decode_fn is None
        self._native_fail_streak = 0

    def _decode_native(self, items) -> Optional[List[List[np.ndarray]]]:
        """The batch through the codec, or None (PIL decodes it): the codec
        unavailable turns the native path off with one warning; a failed
        decode falls back for this batch, and three in a row turn it off."""
        try:
            decoded = decode_batch_native(items, self.size_hw, self.wide_jpeg,
                                          self.num_modalities)
        except RuntimeError as e:
            log = logging.getLogger("editor_tpu_torch.data")
            if "unavailable" in str(e):
                self.native_decode = False
                log.warning("native decode unavailable (%s); using the PIL path", e)
            else:
                self._native_fail_streak += 1
                if self._native_fail_streak >= 3:
                    self.native_decode = False
                log.warning("native batch decode failed (%s); PIL fallback for this batch%s", e,
                            "" if self.native_decode else
                            " — disabling native decode after 3 consecutive failures")
            return None
        self._native_fail_streak = 0
        return decoded

    def _assemble(self, idxs: np.ndarray) -> Dict[str, np.ndarray]:
        items = [self.items[i] for i in idxs]
        decoded = self._decode_native(items) if self.native_decode else None
        if decoded is None:
            decoded = list(self.pool.map(self.decode_fn, items))
        batch: Dict[str, np.ndarray] = {}
        for m, key in enumerate(MODALITY_KEYS):
            batch[key] = np.stack([d[m] for d in decoded]).astype(np.uint8)
        batch["pid"] = np.asarray([it[1] for it in items], np.int32)
        batch["camid"] = np.asarray([it[2] for it in items], np.int32)
        if self.has_sceneid:
            batch["sceneid"] = np.asarray([it[3] for it in items], np.int32)
        return batch

    def batches(self, index_list: np.ndarray,
                batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        """Yield prefetched batches over ``index_list`` (drops the remainder).
        A decode error reaches the caller; a caller that stops early (closes
        the generator) stops the producer thread."""
        n = len(index_list) // batch_size
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = threading.Event()
        end = object()

        def put(item) -> bool:
            while not done.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(n):
                    if not put(self._assemble(index_list[b * batch_size:(b + 1) * batch_size])):
                        return
            except Exception as e:  # handed to the consumer, which raises it
                put(e)
                return
            put(end)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            done.set()
            t.join(timeout=60)


class ReIDDataModule:
    """make_dataloader equivalent (reference: make_dataloader.py:244-308):
    ``train_epoch(epoch)`` batches, ``val_batches()``, ``num_query``,
    ``num_classes``, ``cam_num``. ``splits`` replaces the dataset read from
    ``DATASETS``; ``decode_fn(item)`` replaces the image decode."""

    def __init__(self, cfg: Any, splits: Optional[DatasetSplits] = None,
                 decode_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.splits = splits or load_dataset(cfg.DATASETS.NAMES, cfg.DATASETS.ROOT_DIR)
        s = self.splits
        self.num_classes = s.num_train_pids
        self.cam_num = s.num_train_cams
        self.num_query = s.num_query
        nw = cfg.DATALOADER.NUM_WORKERS
        native = bool(cfg.DATALOADER.NATIVE_DECODE)
        self.train_loader = BatchLoader(
            s.train, tuple(cfg.INPUT.SIZE_TRAIN), s.wide_jpeg, s.num_modalities,
            num_workers=nw, decode_fn=decode_fn, native_decode=native)
        self.val_items = list(s.query) + list(s.gallery)
        self.val_loader = BatchLoader(
            self.val_items, tuple(cfg.INPUT.SIZE_TEST), s.wide_jpeg, s.num_modalities,
            has_sceneid=s.has_sceneid, num_workers=nw, decode_fn=decode_fn,
            native_decode=native)
        if cfg.DATALOADER.SAMPLER in ("softmax_triplet", "triplet"):
            self.sampler = PKSampler(s.train, cfg.SOLVER.IMS_PER_BATCH,
                                     cfg.DATALOADER.NUM_INSTANCE, seed=cfg.SOLVER.SEED)
        else:
            self.sampler = SoftmaxSampler(len(s.train), cfg.SOLVER.IMS_PER_BATCH,
                                          seed=cfg.SOLVER.SEED)
        self.val_pad = 0

    def train_epoch(self, epoch: int):
        return self.train_loader.batches(self.sampler.epoch_indices(epoch),
                                         self.cfg.SOLVER.IMS_PER_BATCH)

    def val_batches(self, batch_size: Optional[int] = None):
        """Query then gallery items; the tail batch is padded by repeating the
        last item (``val_pad`` items), so every batch has one shape."""
        bs = batch_size or self.cfg.TEST.IMS_PER_BATCH
        n = len(self.val_items)
        idxs = np.arange(n)
        pad = (-n) % bs
        if pad:
            idxs = np.concatenate([idxs, np.full(pad, n - 1)])
        self.val_pad = pad
        return self.val_loader.batches(idxs, bs)
