"""Reference ``.pth`` -> the JAX package's flat ``.npz`` (the port's twin of
``tools/convert_checkpoint.py``, with the same flags).

    python -m editor_tpu_torch.tools.convert_checkpoint --pth EDITORbest.pth \\
        --config_file configs/RGBNT201.yaml --num_classes 171 --camera_num 4 \\
        --out editor_rgbnt201.npz
    python -m editor_tpu_torch.tools.convert_checkpoint --pth jx_vit_base_p16_224.pth \\
        --backbone-only --out vit_b16.npz

Builds the port's EDITOR from ``load_config`` -> ``editor_config_from`` with
seeded weights (``editor_init``, seed 0) on ``--device`` (by default the
current CUDA device; ``--device cpu`` on the CPU), loads the file into it
and writes ``{"params", "state"}`` through ``utils.checkpoint.save_params_npz``:
the file the JAX package's ``load_params_npz`` and the port's read.

A full EDITOR file is read by ``utils.torch_convert.load_editor_pth``, as
JAX's ``convert_editor_from_torch`` reads it: the OCFR class centers and the
AL head with its BN may be missing and keep the seeded init, any other
missing key raises ``KeyError``, and a MoE model (``MODEL.MOE_EXPERTS`` > 0)
raises ``ValueError``. The tool prints the keys that kept their init and the
file's keys it did not load.
``--backbone-only`` reads an ImageNet/timm ViT (``load_imagenet_vit``: the
head and distillation keys dropped, a ``distilled`` file's second token cut,
the position grid resized); the rest of the model keeps the seeded init.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    """Parse ``argv``, convert and return the ``.npz`` path written."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--pth", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--config_file", default="")
    parser.add_argument("--num_classes", type=int, default=171)
    parser.add_argument("--camera_num", type=int, default=4)
    parser.add_argument("--backbone-only", action="store_true",
                        help="treat the .pth as a plain ViT (ImageNet/timm)")
    parser.add_argument("--device", default=None, help="e.g. 'cpu'; default: current CUDA device")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from editor_tpu_torch.config import load_config
    from editor_tpu_torch.models.editor import editor_config_from
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.utils.checkpoint import save_params_npz
    from editor_tpu_torch.utils.torch_convert import load_editor_pth, load_imagenet_vit

    cfg = load_config(args.config_file or None, args.opts or None)
    ecfg = editor_config_from(cfg, args.num_classes, args.camera_num)
    model = editor_init(ecfg, seed=0, device=args.device)
    if args.backbone_only:
        loaded = load_imagenet_vit(args.pth, model)
        print(f"loaded {len(loaded)} backbone keys; the rest keep the seeded init")
    else:
        kept, ignored = load_editor_pth(args.pth, model)
        print("kept the seeded init: " + (", ".join(kept) or "none"))
        if ignored:
            print("not loaded: " + ", ".join(ignored))
    save_params_npz(args.out, model)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
