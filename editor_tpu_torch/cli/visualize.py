"""Qualitative visualisation entry point (counterpart of
``editor_tpu/cli/visualize.py``).

Writes the reference's optional qualitative artifacts (mask overlays
SFTS.py:65-137, attention-rollout heat maps vit_pytorch.py:575-617,
frequency reconstructions Frequency.py:20-39) as PNGs under
``OUTPUT_DIR/visualizations`` for the first eval batch.

    python -m editor_tpu_torch.cli.visualize --config_file configs/RGBNT201.yaml \\
        TEST.WEIGHT path/to/OUTPUT_DIR/ckpt [--num_images 8]

``TEST.WEIGHT`` as ``cli.test``. ``--device cpu`` runs on the CPU; by
default the current CUDA device.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None, splits=None, decode_fn=None):
    """Parse ``argv`` and write the artifacts; returns their paths.
    ``splits`` and ``decode_fn`` as in ``cli.train.main``."""
    parser = argparse.ArgumentParser(description="editor_tpu_torch visualize")
    parser.add_argument("--config_file", default="", type=str)
    parser.add_argument("--num_images", default=8, type=int)
    parser.add_argument("--device", default=None, help="e.g. 'cpu'; default: current CUDA device")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    args = parser.parse_args(argv)

    import torch

    from editor_tpu_torch.config import load_config
    from editor_tpu_torch.data.loader import ReIDDataModule
    from editor_tpu_torch.data.transforms import make_eval_transform
    from editor_tpu_torch.models.editor import editor_config_from
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.utils.logger import setup_logger
    from editor_tpu_torch.utils.visualize import dump_eval_visualizations

    cfg = load_config(args.config_file or None, args.opts or None)
    logger = setup_logger("editor_tpu_torch.visualize", cfg.OUTPUT_DIR, "visualize_log.txt")
    dm = ReIDDataModule(cfg, splits=splits, decode_fn=decode_fn)
    model = editor_init(editor_config_from(cfg, dm.num_classes, dm.cam_num),
                        seed=cfg.SOLVER.SEED, device=args.device)
    weight = cfg.TEST.WEIGHT
    if weight.endswith(".pth"):
        from editor_tpu_torch.utils.torch_convert import load_torch_state_dict
        model.load_state_dict(load_torch_state_dict(weight), strict=True)
    elif weight:
        from editor_tpu_torch.utils.checkpoint import restore_eval_state
        model.load_state_dict(restore_eval_state(weight), strict=True)

    device = next(model.parameters()).device
    transform = make_eval_transform(tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD))
    batches = dm.val_batches()
    batch = next(batches)
    batches.close()  # the first batch only: stop the prefetch
    n = min(args.num_images, len(batch["pid"]))
    images = {k: transform(torch.from_numpy(batch[k][:n]).to(device))
              for k in ("RGB", "NI", "TI") if k in batch}
    out_dir = os.path.join(cfg.OUTPUT_DIR, "visualizations")
    paths = dump_eval_visualizations(out_dir, model, images, cam_ids=batch["camid"][:n],
                                     compute_dtype=getattr(torch, cfg.TPU.COMPUTE_DTYPE))
    logger.info("Wrote %d visualization artifacts to %s", len(paths), out_dir)
    return paths


if __name__ == "__main__":
    main()
