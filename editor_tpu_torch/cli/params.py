"""Parameter counter (reference: params.py, which prints 118.55 M for the
flagship EDITOR with num_class=50, camera_num=8).

    python -m editor_tpu_torch.cli.params [--config_file F] [KEY VALUE ...]
    python -m editor_tpu_torch.cli.params --cnn NAME|all [--num_classes N]

Counts every parameter of the model, as the JAX ``count_params`` and the
reference (the unused ImageNet head ``BACKBONE.base.fc`` included; BN
running stats and OCFR centers are buffers). ``--cnn`` counts a CNN-zoo
entry instead (the reference's commented zoo loop, params.py:72-79), or with
``all`` every entry in sorted order, one ``{name}: {M} M`` line each, and
returns the sum (JAX's returns the last entry's count). The models are built
on the meta device: no memory, no card.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="editor_tpu_torch param count")
    parser.add_argument("--config_file", default="", type=str)
    parser.add_argument("--num_classes", default=50, type=int)
    parser.add_argument("--camera_num", default=8, type=int)
    parser.add_argument("--cnn", default="", type=str,
                        help="count a CNN-zoo model instead; 'all' prints every factory entry")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    if args.cnn:
        from editor_tpu_torch.models.zoo import MODEL_FACTORY, model_param_count

        total = 0
        for name in sorted(MODEL_FACTORY) if args.cnn == "all" else [args.cnn]:
            n = model_param_count(name, num_classes=args.num_classes)
            print(f"{name}: {n / 1e6:.3f} M")
            total += n
        return total

    from editor_tpu_torch.config import load_config
    from editor_tpu_torch.models.editor import Editor, editor_config_from

    cfg = load_config(args.config_file or None, args.opts or None)
    model = Editor(editor_config_from(cfg, args.num_classes, args.camera_num), device="meta")
    n = sum(p.numel() for p in model.parameters())
    print(f"Number of parameters: {n / 1e6:.2f} M")
    return n


if __name__ == "__main__":
    main()
