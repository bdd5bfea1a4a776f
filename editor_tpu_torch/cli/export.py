"""Checkpoint export to a reference-layout torch ``.pth`` (counterpart of
``editor_tpu/cli/export.py``).

    python -m editor_tpu_torch.cli.export --config_file configs/RGBNT201.yaml \\
        --out EDITOR.pth TEST.WEIGHT path/to/OUTPUT_DIR/ckpt

The port's ``state_dict`` has the reference EDITOR's key names (reference
make_model.py:85-374), so the file loads into the reference torch code
(``model.load_param`` / ``load_state_dict``, make_model.py:144-148) and into
``cli.test``. ``TEST.WEIGHT`` is a checkpoint directory of the port's
training loop (its latest checkpoint) or a ``.pth`` (a round trip). The
dataset only sets the number of classes and cameras: ``--num_classes`` (and
``--camera_num``) stand in when it is not on disk. ``--device cpu`` builds
the model on the CPU; by default the current CUDA device. The file holds CPU
tensors.
"""

from __future__ import annotations

import argparse


def main(argv=None, splits=None):
    """Parse ``argv`` and export; returns the state_dict written. ``splits``
    replaces the dataset read from ``DATASETS`` (in-memory data)."""
    parser = argparse.ArgumentParser(description="editor_tpu_torch torch export")
    parser.add_argument("--config_file", default="", type=str)
    parser.add_argument("--out", required=True, type=str, help="output .pth path")
    parser.add_argument("--num_classes", default=0, type=int,
                        help="override when the dataset isn't on disk")
    parser.add_argument("--camera_num", default=0, type=int)
    parser.add_argument("--device", default=None, help="e.g. 'cpu'; default: current CUDA device")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    args = parser.parse_args(argv)

    import os

    import torch

    from editor_tpu_torch.config import load_config
    from editor_tpu_torch.models.editor import editor_config_from
    from editor_tpu_torch.models.init import editor_init

    cfg = load_config(args.config_file or None, args.opts or None)
    weight = cfg.TEST.WEIGHT
    if not weight:
        raise SystemExit("TEST.WEIGHT is required (the checkpoint to export)")
    if args.num_classes:
        num_classes, cam_num = args.num_classes, args.camera_num
    else:
        if splits is None:
            from editor_tpu_torch.data.datasets import load_dataset
            splits = load_dataset(cfg.DATASETS.NAMES, cfg.DATASETS.ROOT_DIR)
        num_classes, cam_num = splits.num_train_pids, splits.num_train_cams
    model = editor_init(editor_config_from(cfg, num_classes, cam_num), seed=cfg.SOLVER.SEED,
                        device=args.device)
    if weight.endswith(".pth"):
        from editor_tpu_torch.utils.torch_convert import load_torch_state_dict
        model.load_state_dict(load_torch_state_dict(weight), strict=True)
    else:
        from editor_tpu_torch.utils.checkpoint import restore_eval_state
        model.load_state_dict(restore_eval_state(weight), strict=True)

    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(sd, args.out)
    print(f"wrote {len(sd)} tensors -> {args.out}")
    return sd


if __name__ == "__main__":
    main()
