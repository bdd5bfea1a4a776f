"""Training entry point (reference: train_net.py), on one CUDA device.

    python -m editor_tpu_torch.cli.train --config_file configs/RGBNT201.yaml \\
        SOLVER.BASE_LR 0.001 MODEL.AL 1

``--device cpu`` trains on the CPU (the tests do); by default the current
CUDA device. Writes ``OUTPUT_DIR/config.yaml`` (``Config.dump``) and runs
``do_train``.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch


def set_seed(seed: int):
    """Host-side determinism (reference train_net.py:16-23); the train step's
    own generator carries the device-side draws."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def main(argv=None, splits=None, decode_fn=None):
    """Parse ``argv`` and train; returns ``do_train``'s result. ``splits``
    and ``decode_fn`` go to the data module in place of the dataset on disk
    and the image decode (in-memory data)."""
    parser = argparse.ArgumentParser(description="editor_tpu_torch training")
    parser.add_argument("--config_file", default="", type=str)
    parser.add_argument("--device", default=None, help="e.g. 'cpu'; default: current CUDA device")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    args = parser.parse_args(argv)

    from editor_tpu_torch.config import load_config
    from editor_tpu_torch.data.loader import ReIDDataModule
    from editor_tpu_torch.engine.loop import do_train

    cfg = load_config(args.config_file or None, args.opts or None)
    set_seed(cfg.SOLVER.SEED)
    if cfg.OUTPUT_DIR:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
            f.write(cfg.dump())
    dm = ReIDDataModule(cfg, splits=splits, decode_fn=decode_fn)
    result = do_train(cfg, dm=dm, device=args.device)
    print("Best:", result["best"])
    return result


if __name__ == "__main__":
    main()
