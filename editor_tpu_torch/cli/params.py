"""Parameter counter (reference: params.py, which prints 118.55 M for the
flagship EDITOR with num_class=50, camera_num=8).

    python -m editor_tpu_torch.cli.params [--config_file F] [KEY VALUE ...]

Counts every parameter of the model, as the JAX ``count_params`` and the
reference (the unused ImageNet head ``BACKBONE.base.fc`` included; BN
running stats and OCFR centers are buffers). The model is built on the meta
device: no memory, no card.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="editor_tpu_torch param count")
    parser.add_argument("--config_file", default="", type=str)
    parser.add_argument("--num_classes", default=50, type=int)
    parser.add_argument("--camera_num", default=8, type=int)
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from editor_tpu_torch.config import load_config
    from editor_tpu_torch.models.editor import Editor, editor_config_from

    cfg = load_config(args.config_file or None, args.opts or None)
    model = Editor(editor_config_from(cfg, args.num_classes, args.camera_num), device="meta")
    n = sum(p.numel() for p in model.parameters())
    print(f"Number of parameters: {n / 1e6:.2f} M")
    return n


if __name__ == "__main__":
    main()
