"""Host input pipeline: ``BatchLoader`` samples per second over a tri-modal
256x128 tree written from a seed, for each decode path that can run.

    python3 -m editor_tpu_torch.tools.bench_loader [num_ids] [num_workers]

Counterpart of ``tools/bench_loader.py``. It writes an RGBNT201-layout tree
(``RGBNT201/train_171/{RGB,NI,TI}/``, ``num_ids`` ids (default 32) x 8
items, uniform random uint8 pixels from seed 0, in JAX's order) into a
temporary directory: JPEGs (quality 90) where PIL can encode them, and the
same pixels as raw ``.npy`` files beside them. Then, for each path, one
warm epoch and the best of 3 epochs (host clock around each epoch's
batches; B = 128 as 16 ids x 8, ``num_workers`` decode threads, default 8):

* the native libjpeg codec (``DATALOADER.NATIVE_DECODE``, one call a batch),
  where the codec builds and the tree is JPEG;
* the PIL pool, where PIL is present;
* a ``decode_fn`` reading the raw files (``np.load``; no codec), the form of
  decode the loop's callers pass and the one that runs everywhere.

One line a path: samples (tri-modal items) and decodes per second, or what
kept it from running. Without PIL no JPEG encoder is present: the tree is
raw only, and the ``decode_fn`` path runs alone. A path that fails prints
``FAIL`` and its error, and the tool then exits non-zero; it exits non-zero
without a CUDA device (the card's host is the one measured).
"""

from __future__ import annotations

import importlib.util
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from editor_tpu_torch.data.loader import MODALITY_KEYS
from editor_tpu_torch.tools import _bench

PER_ID = 8
BATCH = 128  # 16 ids x PER_ID, as JAX's


def make_tree(root: str, ids: int = 32, per_id: int = PER_ID, jpeg: bool = True) -> list:
    """Write the tree under ``root`` and return the raw files' items
    (``(paths, pid, camid, -1)``, paths in ``MODALITY_KEYS`` order)."""
    Image = None
    if jpeg:
        from PIL import Image
    rng = np.random.RandomState(0)
    names = [f"{pid:06d}_cam{k % 4 + 1}_{k}" for pid in range(ids) for k in range(per_id)]
    for mod in MODALITY_KEYS:
        d = os.path.join(root, "RGBNT201", "train_171", mod)
        raw = os.path.join(root, "raw", mod)
        os.makedirs(d, exist_ok=True)
        os.makedirs(raw, exist_ok=True)
        for name in names:
            arr = rng.randint(0, 255, (256, 128, 3), np.uint8)
            np.save(os.path.join(raw, name + ".npy"), arr)
            if Image is not None:
                Image.fromarray(arr).save(os.path.join(d, name + ".jpg"), quality=90)
    return [(tuple(os.path.join(root, "raw", m, n + ".npy") for m in MODALITY_KEYS),
             int(n[:6]), int(n.split("_")[1][3]) - 1, -1) for n in names]


def read_raw(item) -> list:
    """The ``decode_fn`` path: each modality's raw uint8 array."""
    return [np.load(p) for p in item[0]]


def _best(dm, repeats: int) -> float:
    """Samples per second of the best of ``repeats`` epochs after a warm one."""
    list(dm.train_epoch(epoch=0))  # the thread pool and the page cache
    best = 0.0
    for _ in range(repeats):
        n, t0 = 0, time.perf_counter()
        for batch in dm.train_epoch(epoch=1):
            n += batch["RGB"].shape[0]
        best = max(best, n / (time.perf_counter() - t0))
    return best


def run(ids: int = 32, workers: int = 8, repeats: int = 3, root: Optional[str] = None
        ) -> Tuple[Dict[str, Optional[float]], List[str]]:
    """One line a decode path; returns ({path: samples/s, or None where it
    failed or could not run}, the labels of the paths that failed). The
    tree goes to ``root``, by default a temporary directory removed after."""
    if root is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run(ids, workers, repeats, tmp)
    from editor_tpu_torch.config import Config
    from editor_tpu_torch.data.datasets import DatasetSplits
    from editor_tpu_torch.data.loader import ReIDDataModule
    from editor_tpu_torch.native import load_imagecodec

    pil = importlib.util.find_spec("PIL") is not None
    codec = load_imagecodec() is not None if pil else False
    raw_items = make_tree(root, ids, jpeg=pil)
    cfg = Config()
    cfg.DATASETS.NAMES = "RGBNT201"
    cfg.DATASETS.ROOT_DIR = root
    cfg.INPUT.SIZE_TRAIN = [256, 128]
    cfg.INPUT.SIZE_TEST = [256, 128]
    cfg.DATALOADER.NUM_WORKERS = workers
    cfg.SOLVER.IMS_PER_BATCH = BATCH
    cfg.DATALOADER.NUM_INSTANCE = PER_ID
    print(f"tree: {ids} ids x {PER_ID} x {len(MODALITY_KEYS)} modalities 256x128, "
          f"{'JPEG q90 and raw .npy' if pil else 'raw .npy only (no PIL: no JPEG encoder)'}; "
          f"PIL {'yes' if pil else 'no'}, native codec {'yes' if codec else 'no'}, "
          f"workers={workers}, cores={os.cpu_count()}", flush=True)

    def jpeg(native: bool) -> float:
        cfg.DATALOADER.NATIVE_DECODE = native
        dm = ReIDDataModule(cfg)
        best = _best(dm, repeats)
        if native and not dm.train_loader.native_decode:
            raise RuntimeError("the codec failed a batch and the loader turned it off")
        return best

    paths = (("native codec", codec, lambda: jpeg(True),
              "not run: " + ("the libjpeg codec is unavailable (no headers or no build)"
                             if pil else "no JPEG tree without PIL")),
             ("PIL pool", pil, lambda: jpeg(False), "not run: PIL is not present"),
             ("decode_fn (np.load)", True, lambda: _best(ReIDDataModule(
                 cfg, splits=DatasetSplits(raw_items, [], [], ids, 4), decode_fn=read_raw),
                 repeats), ""))
    failed: List[str] = []
    out: Dict[str, Optional[float]] = {}
    for label, can, fn, why in paths:
        if not can:
            out[label] = None
            print(f"{label}: {why}", flush=True)
            continue
        out[label] = best = _bench.case(label, fn, failed)
        if best is not None:
            print(f"{label}: best {best:9.1f} samples/s ({3 * best:9.1f} decodes/s)", flush=True)
    return out, failed


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    _bench.start("bench_loader")
    _, failed = run(int(argv[0]) if argv else 32, int(argv[1]) if len(argv) > 1 else 8)
    _bench.finish("bench_loader", failed)


if __name__ == "__main__":
    main()
