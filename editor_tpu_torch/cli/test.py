"""Evaluation entry point (reference: test_net.py).

    python -m editor_tpu_torch.cli.test --config_file configs/RGBNT201.yaml \\
        TEST.WEIGHT path/to/OUTPUT_DIR/ckpt

``TEST.WEIGHT``: a checkpoint directory of the port's training loop (its
latest checkpoint), a ``.pth`` state_dict in the reference layout (loaded
strictly), or empty (seeded random weights, a smoke run). ``--device cpu``
evaluates on the CPU; by default the current CUDA device.
"""

from __future__ import annotations

import argparse


def main(argv=None, splits=None, decode_fn=None):
    """Parse ``argv`` and evaluate; returns (cmc, mAP). ``splits`` and
    ``decode_fn`` as in ``cli.train.main``."""
    parser = argparse.ArgumentParser(description="editor_tpu_torch eval")
    parser.add_argument("--config_file", default="", type=str)
    parser.add_argument("--device", default=None, help="e.g. 'cpu'; default: current CUDA device")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    args = parser.parse_args(argv)

    import torch

    from editor_tpu_torch.config import load_config
    from editor_tpu_torch.data.loader import ReIDDataModule
    from editor_tpu_torch.engine.loop import evaluate
    from editor_tpu_torch.models.editor import editor_config_from
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.utils.logger import setup_logger

    cfg = load_config(args.config_file or None, args.opts or None)
    logger = setup_logger("editor_tpu_torch.test", cfg.OUTPUT_DIR, "test_log.txt")
    dm = ReIDDataModule(cfg, splits=splits, decode_fn=decode_fn)
    ecfg = editor_config_from(cfg, dm.num_classes, dm.cam_num)
    model = editor_init(ecfg, seed=cfg.SOLVER.SEED, device=args.device)

    weight = cfg.TEST.WEIGHT
    if weight.endswith(".pth"):
        from editor_tpu_torch.utils.torch_convert import load_torch_state_dict
        model.load_state_dict(load_torch_state_dict(weight), strict=True)
        logger.info("Loaded torch checkpoint %s", weight)
    elif weight:
        from editor_tpu_torch.utils.checkpoint import restore_eval_state
        model.load_state_dict(restore_eval_state(weight), strict=True)
        logger.info("Loaded checkpoint %s", weight)

    cmc, mAP = evaluate(cfg, model, dm, getattr(torch, cfg.TPU.COMPUTE_DTYPE))
    logger.info("Validation Results")
    logger.info("mAP: %.2f%%", mAP * 100)
    for r in (1, 5, 10):
        if len(cmc) >= r:
            logger.info("CMC curve, Rank-%d: %.2f%%", r, cmc[r - 1] * 100)
    return cmc, mAP


if __name__ == "__main__":
    main()
