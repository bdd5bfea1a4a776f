"""Time per stage of the flagship eval forward on one CUDA device.

    python3 -m editor_tpu_torch.tools.bench_stages [B]

Counterpart of ``tools/bench_stages.py``. The flagship model
(``models.editor.flagship_config``: ViT-B/16, 256x128, RGB+NIR+TIR,
HEAD_KEEP 2, FREQUENCY_KEEP 10, the compact tail) with seeded random weights
(``editor_init``, seed 0), B (default 128) random-normal bf16 images a
modality and camera 0, in inference mode. Timed with CUDA events
(``_bench.cuda_ms``), one line each:

* the full eval forward (``engine.evaluate.build_eval_step``), and its
  images per second;
* the backbone over the 3B modality-major batch without the rollout (patch
  embedding, the 12 blocks through K1 writing their maps, the final norm)
  and with it (the same and K2's chain: the backbone's own forward);
* the frequency mask (``models.frequency.frequency_token_select``);
* the tail: SFTS (``models.sfts.sfts_select``), the compaction
  (``models.editor._compact_selected`` to ``_tail_keep_count``) and the
  fusion block (``models.fusion.BlockMask``, K3) on one backbone pass's
  tokens;
* "unaccounted": the full forward less the backbone with the rollout, the
  mask and the tail (the pool, the reduce heads and the glue between).

The card's name and power limit come first. A case that fails prints
``FAIL`` and its error, and the tool then exits non-zero; it exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import torch

from editor_tpu_torch.models.editor import MODALITIES
from editor_tpu_torch.tools import _bench


def backbone_tokens(vit, x: torch.Tensor, cams: torch.Tensor, use_kernels: bool
                    ) -> torch.Tensor:
    """The backbone's forward without the rollout: the patch embedding, the
    blocks (each writing its attention maps, as in the forward) and the final
    norm."""
    cfg = vit.cfg
    tokens = vit.embed(x, cams)
    B, N, _ = tokens.shape
    probs = torch.empty((cfg.depth, B, cfg.num_heads, N, N), dtype=tokens.dtype,
                        device=tokens.device)
    return vit.norm(vit.run_blocks(tokens, 0, cfg.depth, probs, use_kernels))


@torch.inference_mode()
def run(B: int = 128, iters: int = 30, ecfg=None, device="cuda", seed: int = 0
        ) -> Tuple[Dict[str, Optional[float]], List[str]]:
    """Time the stages at batch ``B`` (ms from ``_bench.cuda_ms`` over
    ``iters`` calls), printing one line each; returns ({stage: ms or None},
    the labels of the cases that failed). ``ecfg``: by default the flagship
    config."""
    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.models.editor import (_compact_selected, _tail_keep_count,
                                                flagship_config)
    from editor_tpu_torch.models.frequency import frequency_token_select
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.models.sfts import sfts_select

    ecfg = ecfg or flagship_config()
    device = torch.device(device)
    model = editor_init(ecfg, seed=seed, device=device)
    vit, uk = model.BACKBONE.base, ecfg.use_pallas
    gen = torch.Generator(device=device).manual_seed(seed)
    h, w = ecfg.vit.img_size
    images = {m: torch.randn(B, h, w, 3, generator=gen, device=device).to(torch.bfloat16)
              for m in MODALITIES}
    cams = torch.zeros(B, dtype=torch.long, device=device)
    big, bcams = torch.cat([images[m] for m in MODALITIES]), cams.repeat(len(MODALITIES))
    extract = build_eval_step(model, torch.bfloat16)
    batch = dict(images, camid=cams)

    def freq():
        return frequency_token_select([images[m] for m in MODALITIES], keep=ecfg.frequency_keep,
                                      stride=ecfg.vit.stride_size[0], window=ecfg.vit.patch_size)

    def tail(toks3, rolls3, mf):
        feats, index = sfts_select(toks3, rolls3, mf, ecfg.head_keep)
        if ecfg.compact_tail:
            keep = _tail_keep_count(ecfg, len(MODALITIES))
            if keep < ecfg.num_patches:
                feats, index = _compact_selected(feats, index, keep)
        return model.FUSE_block(feats, index, uk)[0]

    def tail_case():
        toks, rolls = vit(big, bcams, None, uk)
        args = (list(toks.split(B)), list(rolls.split(B)), freq())
        return _bench.cuda_ms(lambda: tail(*args), iters=iters)

    print(f"B={B} images={len(MODALITIES)}x{h}x{w} bf16 device={device}", flush=True)
    failed: List[str] = []
    t: Dict[str, Optional[float]] = {}
    cases = (("full", "full eval", lambda: _bench.cuda_ms(lambda: extract(batch), iters=iters)),
             ("backbone", "backbone (no roll)",
              lambda: _bench.cuda_ms(lambda: backbone_tokens(vit, big, bcams, uk), iters=iters)),
             ("backbone_rollout", "backbone + rollout",
              lambda: _bench.cuda_ms(lambda: vit(big, bcams, None, uk), iters=iters)),
             ("frequency", "frequency", lambda: _bench.cuda_ms(freq, iters=iters)),
             ("tail", "sfts+fusion tail", tail_case))
    for key, label, fn in cases:
        t[key] = _bench.case(label, fn, failed)
        if t[key] is None:
            continue
        extra = {}
        if key == "full":
            extra["img_per_s"] = f"{B / t[key] * 1e3:.1f}"
        if key == "backbone_rollout" and t["backbone"] is not None:
            extra["rollout_ms"] = f"{t[key] - t['backbone']:.4f}"
        _bench.report(label, t[key], **extra)
    parts = ("full", "backbone_rollout", "frequency", "tail")
    if all(t[k] is not None for k in parts):
        t["unaccounted"] = t["full"] - t["backbone_rollout"] - t["frequency"] - t["tail"]
        _bench.report("unaccounted", t["unaccounted"])
    else:
        t["unaccounted"] = None
        print("unaccounted: FAIL a stage it is computed from failed", flush=True)
        failed.append("unaccounted")
    return t, failed


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    _bench.start("bench_stages")
    _, failed = run(int(argv[0]) if argv else 128)
    _bench.finish("bench_stages", failed)


if __name__ == "__main__":
    main()
