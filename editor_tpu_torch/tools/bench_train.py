"""The flagship train step under block remat, swept over
``TPU.REMAT_SKIP_LAST`` (the blocks left out of the remat, which trade
device memory for speed), on one CUDA device.

    python3 -m editor_tpu_torch.tools.bench_train [skip values...]

Counterpart of ``tools/bench_train.py``: for each skip value (default 0 1 2
3) the flagship model (``models.editor.flagship_config``) with
``remat_policy`` block and that ``remat_skip_last``, seeded random weights
(``editor_init``, seed 1), ``Config()``'s solver and loss, and
``build_train_step`` in bf16 without augmentation, on one batch of B = 128
random-normal bf16 images (seed 1), pids ``arange(B) % 16`` (16 ids x 8)
and camera 0, as JAX's. One line a value: ms a step from CUDA events over
10 steps after three warm-up steps (the first held to a finite loss),
images per second, and the peak device memory of the value's run
(``torch.cuda.reset_peak_memory_stats`` before its model is built, after a
garbage collection; ``before_gb``: what the process held then, in the
peak). The card's name
and power limit come first. A value that fails prints ``FAIL`` and its
error, and the tool then exits non-zero; it exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from editor_tpu_torch.models.editor import MODALITIES
from editor_tpu_torch.tools import _bench


def _one(cfg, ecfg, skip: int, batch: dict, iters: int, device: torch.device) -> dict:
    from editor_tpu_torch.engine.train import build_train_step
    from editor_tpu_torch.losses import make_loss
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.solver import make_optimizer, make_scheduler

    cuda = device.type == "cuda"
    gc.collect()  # garbage of earlier work, freed here and not while timing
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    e = dataclasses.replace(ecfg, vit=dataclasses.replace(
        ecfg.vit, remat=True, remat_policy="block", remat_skip_last=skip))
    model = editor_init(e, seed=1, device=device)
    step = build_train_step(model, make_optimizer(cfg, model), make_loss(cfg, e.num_classes),
                            make_scheduler(cfg), cfg.SOLVER.BASE_LR, torch.bfloat16)
    loss = float(step(batch, 1)["loss"])
    if not math.isfinite(loss):
        raise FloatingPointError(f"the warm-up step's loss is {loss}")
    ms = _bench.cuda_ms(lambda: step(batch, 1), iters=iters, warmup=2)
    return {"ms": ms, "img_per_s": batch["pid"].shape[0] / ms * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None,
            "before_gb": base / 1e9 if cuda else None}


def run(skips: Sequence[int] = (0, 1, 2, 3), B: int = 128, iters: int = 10, ecfg=None,
        device="cuda") -> Tuple[Dict[int, Optional[dict]], List[str]]:
    """One line a skip value; returns ({skip: {'ms', 'img_per_s', 'peak_gb'}
    or None}, the labels of the values that failed). ``ecfg``: by default
    the flagship config."""
    from editor_tpu_torch.config import Config
    from editor_tpu_torch.models.editor import flagship_config

    ecfg = ecfg or flagship_config()
    device = torch.device(device)
    cfg = Config()
    gen = torch.Generator(device=device).manual_seed(1)
    h, w = ecfg.vit.img_size
    batch = {m: torch.randn(B, h, w, 3, generator=gen, device=device).to(torch.bfloat16)
             for m in MODALITIES}
    batch["pid"] = torch.arange(B, device=device) % 16
    batch["camid"] = torch.zeros(B, dtype=torch.long, device=device)
    print(f"B={B} remat=block images bf16 device={device}", flush=True)
    failed: List[str] = []
    out: Dict[int, Optional[dict]] = {}
    for skip in skips:
        label = f"skip_last={skip}"
        out[skip] = r = _bench.case(label, lambda: _one(cfg, ecfg, skip, batch, iters, device),
                                    failed)
        if r is not None:
            gb = {k: "not measured" if r[k] is None else f"{r[k]:.3f}"
                  for k in ("peak_gb", "before_gb")}
            _bench.report(label, r["ms"], img_per_s=f"{r['img_per_s']:.1f}", **gb)
    return out, failed


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    _bench.start("bench_train")
    _, failed = run([int(a) for a in argv] or (0, 1, 2, 3))
    _bench.finish("bench_train", failed)


if __name__ == "__main__":
    main()
