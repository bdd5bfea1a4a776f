"""Logging: stream and file handlers, and a JSONL metric stream.

The port's copy of ``editor_tpu/utils/logger.py`` (reference:
utils/logger.py ``setup_logger``): the same file names (``train_log.txt``,
``metrics.jsonl``) and line formats. ``MetricWriter`` mirrors its records
into TensorBoard event files under ``OUTPUT_DIR/tb`` only when asked
(``TPU.TENSORBOARD``); ``torch.utils.tensorboard`` is imported only then.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional


def setup_logger(name: str, save_dir: Optional[str], filename: str,
                 distributed_rank: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if distributed_rank > 0:
        return logger
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    if not any(isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        sh = logging.StreamHandler(stream=sys.stdout)
        sh.setLevel(logging.DEBUG)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if save_dir:
        # loggers are process-global: a second run with another OUTPUT_DIR
        # swaps the file handler rather than logging into the first run's file
        path = os.path.abspath(os.path.join(save_dir, filename))
        for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)
                  and getattr(h, "baseFilename", None) != path]:
            logger.removeHandler(h)
            h.close()
        if not any(isinstance(h, logging.FileHandler)
                   and getattr(h, "baseFilename", None) == path for h in logger.handlers):
            os.makedirs(save_dir, exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setLevel(logging.DEBUG)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class MetricWriter:
    """Append-only JSONL metrics, one record per call (a ``ts`` field
    added), with an optional TensorBoard mirror keyed by ``step``, ``iter``
    or ``epoch``."""

    def __init__(self, save_dir: Optional[str], filename: str = "metrics.jsonl",
                 tensorboard: bool = False):
        self.path = None
        self.tb = None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self.path = os.path.join(save_dir, filename)
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self.tb = SummaryWriter(os.path.join(save_dir, "tb"))
                except ImportError:  # the JSONL stream stays
                    logging.getLogger(__name__).warning(
                        "tensorboard unavailable; metrics stay JSONL-only")

    def write(self, record: Dict[str, Any]):
        if self.path is None:
            return
        record = dict(record, ts=time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.tb is not None:
            step = record.get("step", record.get("iter", record.get("epoch", 0)))
            for k, v in record.items():
                if k in ("ts", "step", "iter") or not isinstance(v, (int, float)):
                    continue
                self.tb.add_scalar(k, v, int(step))
            self.tb.flush()

    def close(self):
        if self.tb is not None:
            self.tb.close()
