"""Where the time of the flagship train step goes on one CUDA device.

    python3 -m editor_tpu_torch.tools.profile_train [--batch 128] [--iters 5]
        [--pipeline M] [--opts KEY VALUE ...]

The train step of ``chip_smoke.py`` phase 5: the flagship model and solver,
``load_config(None, RGBNT201_PRESET + opts)`` through ``editor_config_from``
(ViT-B/16, 256x128, RGB+NIR+TIR; ``--opts TPU.COMPACT_TAIL False`` for the
uncompacted tail, phase 6), seeded random weights, SGD, bf16 compute, B images
as 8 ids x B/8 instances of random uint8 images through the on-device
augmentation. Its time per step from CUDA events over ``--iters``
back-to-back steps after two warm-ups, images per second, peak device
memory, and a ``torch.profiler`` trace of ``--profile-iters`` more steps
grouped per step as in ``profile_forward`` (K1-K8, GEMMs,
LayerNorm, GELU, the patch conv, the optimizer's foreach kernels, the rest);
the idle share is 1 - (device busy time / event time). The card's name and
power limit head the output; the per-kernel table goes to ``--out`` (by
default the git-ignored ``editor_tpu_torch/_build/profile_train.txt``).
With ``--pipeline M`` the same step through the pipelined backbone
(``parallel.pipeline_vit.make_pipeline_backbone``, M microbatches, remat) on
an NCCL group of one rank (mesh 1 x stage 1 x 1) is profiled after it, from
the same weights and batch (chip_smoke phase 13 (a)).
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import sys

import torch

from editor_tpu_torch.tools.profile_forward import (add_opts_arg, card_name,
                                                    flagship_from_opts, profile_calls,
                                                    write_report)


def build_flagship_train_step(batch: int, seed: int = 0, opts=(), mesh=None, backbone=None):
    """(step, batch dict): the flagship train step (the preset with ``opts``
    on top) on the current CUDA device and one synthetic uint8 batch of
    ``batch`` images, 8 ids x batch/8; ``mesh`` and ``backbone`` go to
    ``build_train_step``."""
    from editor_tpu_torch.data.transforms import make_train_augment
    from editor_tpu_torch.engine.train import build_train_step
    from editor_tpu_torch.losses import make_loss
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.solver import make_optimizer, make_scheduler

    cfg, ecfg = flagship_from_opts(opts)
    model = editor_init(ecfg, seed=seed)
    step = build_train_step(model, make_optimizer(cfg, model), make_loss(cfg, ecfg.num_classes),
                            make_scheduler(cfg), cfg.SOLVER.BASE_LR, torch.bfloat16,
                            augment=make_train_augment(cfg.INPUT), seed=seed, mesh=mesh,
                            backbone=backbone)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h, w = ecfg.vit.img_size
    data = {m: torch.randint(0, 256, (batch, h, w, 3), generator=gen, device="cuda",
                             dtype=torch.uint8) for m in ("RGB", "NI", "TI")}
    data["pid"] = torch.arange(batch, device="cuda") // (batch // 8)
    data["camid"] = torch.arange(batch, device="cuda") % 6
    return step, data


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--profile-iters", type=int, default=2)
    ap.add_argument("--epoch", type=int, default=11, help="epoch fed to the schedule")
    ap.add_argument("--out", default="editor_tpu_torch/_build/profile_train.txt")
    ap.add_argument("--pipeline", type=int, default=0, metavar="M",
                    help="also profile the pipelined step with M microbatches")
    add_opts_arg(ap)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_train: no CUDA device")
    card = card_name()
    print(card, flush=True)
    print(f"opts={args.opts}", flush=True)
    step, data = build_flagship_train_step(args.batch, opts=args.opts)
    results = [profile_calls(lambda: step(data, args.epoch), args.batch, args.iters,
                             args.profile_iters, lambda s: print(s, flush=True), "train step")]
    del step
    if args.pipeline:
        results.append(_pipelined(args, data))
    write_report(args.out, card, results, "train step")


def _pipelined(args, data) -> dict:
    """The pipelined step's profile (``--pipeline``), in a group of one
    rank made over a file in a temporary directory."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from editor_tpu_torch.parallel import multihost
    from editor_tpu_torch.parallel.mesh import make_mesh
    from editor_tpu_torch.parallel.pipeline_vit import make_pipeline_backbone

    tmp = tempfile.mkdtemp(prefix="profile_train_pp_")
    try:
        multihost.initialize(init_method="file://" + os.path.join(tmp, "store"), world_size=1,
                             rank=0, local_rank=torch.cuda.current_device())
        mesh = make_mesh(1, 1, stage=1)
        step, _ = build_flagship_train_step(
            args.batch, opts=args.opts, mesh=mesh,
            backbone=make_pipeline_backbone(mesh, args.pipeline, remat=True))
        return profile_calls(lambda: step(data, args.epoch), args.batch, args.iters,
                             args.profile_iters, lambda s: print(s, flush=True),
                             f"pipelined train step (M = {args.pipeline})")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
