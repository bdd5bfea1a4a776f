"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line:
  0. card check: CUDA present, card name and power limit (nvidia-smi); TF32
     is switched off so the fp32 reference runs are true fp32;
  1. build: nvcc compiles editor_tpu_torch/csrc/*.cu for sm_90a;
  2. kernels: each hand-written kernel against its plain PyTorch version at
     the flagship eval shapes in bf16, with kernel and plain times from CUDA
     events;
  3. forward: the flagship tri-modal eval forward (ViT-B/16, 256x128,
     seeded random weights, B=128, bf16) through build_eval_step; the launch
     counters must show every kernel ran, and the features must match the same
     model run with the plain ops in fp32 (per-row cosine >= 0.99, rel-L2 <=
     0.08);
  4. serving: FeatureExtractor + GalleryIndex over 64 synthetic identities;
     queries of 1, 3 and 32 repeated gallery items must each retrieve
     themselves at rank 1; batch-1 p50 latency.
Then one JSON line with each kernel's numbers, and last the result line
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero without the result line; it does the same without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

H, C = 12, 768
D = C // H
SCALE = D ** -0.5
FILL = -65504.0
B_EVAL = 128

KERNELS = {
    "attention_qkv": dict(source="editor_tpu_torch/csrc/attention_qkv.cu",
                          replaces="editor_tpu/ops/fused_attention.py:225"),
    "rollout_chain": dict(source="editor_tpu_torch/csrc/rollout_chain.cu",
                          replaces="editor_tpu/ops/rollout.py:88"),
    "masked_attention_qkv": dict(source="editor_tpu_torch/csrc/masked_attention.cu",
                                 replaces="editor_tpu/ops/masked_attention.py:163"),
}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def card_check() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi.splitlines()[0]
    print(card, flush=True)
    say("0 card", name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, tf32="off")
    return card


def build_phase() -> None:
    from editor_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    say("1 build", seconds=f"{time.perf_counter() - t0:.2f}", lib=_build.library_path().name)


def cuda_ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _max_err(got, ref, scale: float = 1.0) -> float:
    return float(((got.float() - ref.float()).abs() / scale).max())


def _require(name: str, err: float, tol: float) -> None:
    if not err <= tol:  # also catches NaN
        raise AssertionError(f"{name}: max abs error {err} > {tol}")


def kernel_phase(gen: torch.Generator) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from editor_tpu_torch import ops

    dev = "cuda"
    results = {}

    def randn(*shape, mul=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * mul).to(torch.bfloat16)

    # K1 at the backbone shape [3 x 128, 129, 3C]
    qkv = randn(3 * B_EVAL, 129, 3 * C)
    probs = torch.empty(3 * B_EVAL, H, 129, 129, dtype=torch.bfloat16, device=dev)
    out, _ = ops.attention_qkv(qkv, H, SCALE, probs_out=probs)
    ref_out, ref_probs = ops.attention_qkv_plain(qkv, H, SCALE, True)
    torch.cuda.synchronize()
    e_out, e_probs = _max_err(out, ref_out), _max_err(probs, ref_probs)
    _require("attention_qkv out", e_out, 2e-2)
    _require("attention_qkv probs", e_probs, 1e-2)
    qkv30 = randn(3 * B_EVAL, 129, 3 * C, mul=30.0)
    out30, _ = ops.attention_qkv(qkv30, H, SCALE)
    ref30 = ops.attention_qkv_plain(qkv30, H, SCALE, False)
    torch.cuda.synchronize()
    if not torch.isfinite(out30.float()).all():
        raise AssertionError("attention_qkv: non-finite output at |logit| ~ 1e3")
    e30 = _max_err(out30, ref30, max(float(ref30.float().abs().max()), 1e-6))
    _require("attention_qkv x30 (scaled)", e30, 1e-2)
    # the batch-1 serving shape [3, 129, 3C]
    q1 = randn(3, 129, 3 * C)
    p1 = torch.empty(3, H, 129, 129, dtype=torch.bfloat16, device=dev)
    o1, _ = ops.attention_qkv(q1, H, SCALE, probs_out=p1)
    r1, rp1 = ops.attention_qkv_plain(q1, H, SCALE, True)
    torch.cuda.synchronize()
    e_b1 = max(_max_err(o1, r1), _max_err(p1, rp1))
    _require("attention_qkv batch-1", e_b1, 2e-2)
    ms = cuda_ms(lambda: ops.attention_qkv(qkv, H, SCALE, probs_out=probs))
    plain_ms = cuda_ms(lambda: ops.attention_qkv_plain(qkv, H, SCALE, True))
    results["attention_qkv"] = dict(max_abs_err=max(e_out, e_probs), ms=ms, plain_ms=plain_ms)
    say("2 kernel attention_qkv", shape=list(qkv.shape), out_err=e_out,
        probs_err=e_probs, x30_scaled_err=e30, batch1_err=e_b1, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}")
    del qkv, probs, out, ref_out, ref_probs, qkv30, out30, ref30

    # K2 at L = 12, Z = 3 x 128 x 12 = 4608, N = 129. Peaked maps (softmax of
    # 4 x randn), so the chain keeps the layer order visible in its output.
    # Kernel and plain version read the same bf16 maps and both sum in fp32,
    # so they differ only by summation order (~1e-8); the limit 1e-5 is far
    # tighter than the TPU test's 5e-3, which a constant output would pass.
    L, Bz, N = 12, 3 * B_EVAL, 129
    tol_roll = 1e-5
    maps = torch.empty(L, Bz, H, N, N, dtype=torch.bfloat16, device=dev)
    for l in range(L):
        maps[l] = torch.softmax(4.0 * torch.randn(Bz, H, N, N, generator=gen, device=dev),
                                dim=-1).to(torch.bfloat16)
    roll = ops.rollout_chain(maps)
    ref_roll = ops.rollout_from_probs_plain(maps)
    torch.cuda.synchronize()
    e_roll = _max_err(roll, ref_roll)
    _require("rollout_chain", e_roll, tol_roll)
    # the limit must fail the bugs this kernel invites
    bug_errs = {
        "transposed": _max_err(ops.rollout_from_probs_plain(maps.transpose(-1, -2)), ref_roll),
        "reversed": _max_err(ops.rollout_from_probs_plain(maps.flip(0)), ref_roll),
        "constant": _max_err(torch.full_like(ref_roll, 1.0 / N), ref_roll),
    }
    for bug, err in bug_errs.items():
        if not err > 100 * tol_roll:
            raise AssertionError(f"rollout_chain check too loose: a {bug} chain is off "
                                 f"by only {err}")
    ms = cuda_ms(lambda: ops.rollout_chain(maps))
    plain_ms = cuda_ms(lambda: ops.rollout_from_probs_plain(maps))
    results["rollout_chain"] = dict(max_abs_err=e_roll, ms=ms, plain_ms=plain_ms)
    say("2 kernel rollout_chain", L=L, Z=Bz * H, N=N, err=e_roll, tol=tol_roll,
        spread=f"{float(ref_roll.std()):.6f}",
        bug_errs=json.dumps({k: round(v, 6) for k, v in bug_errs.items()}),
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    del maps, roll, ref_roll

    # K3 at the per-modality [384, 88, 3C] and joint [128, 264, 3C] shapes
    errs, times = [], []
    for Bm, N in ((3, 88), (1, 264)):  # the batch-1 serving shapes
        qkv = randn(Bm, N, 3 * C)
        m = (torch.rand(Bm, N, generator=gen, device=dev) < 0.5).float()
        m[:, 0] = 1.0
        e = _max_err(ops.masked_attention_qkv(qkv, m, H, SCALE, FILL),
                     ops.masked_attention_qkv_plain(qkv, m, H, SCALE, FILL))
        _require(f"masked_attention_qkv batch-1 N={N}", e, 2e-2)
        errs.append(e)
    for Bm, N in ((3 * B_EVAL, 88), (B_EVAL, 264)):
        qkv = randn(Bm, N, 3 * C)
        m = torch.rand(Bm, N, generator=gen, device=dev) < 0.5
        m = (m | (torch.arange(N, device=dev) % 88 == 0)[None, :]).float()
        got = ops.masked_attention_qkv(qkv, m, H, SCALE, FILL)
        ref = ops.masked_attention_qkv_plain(qkv, m, H, SCALE, FILL)
        torch.cuda.synchronize()
        e = _max_err(got, ref)
        _require(f"masked_attention_qkv N={N}", e, 2e-2)
        if got[m == 0].abs().max() != 0:
            raise AssertionError("masked_attention_qkv: masked query rows not 0")
        qkv30 = randn(Bm, N, 3 * C, mul=30.0)
        got30 = ops.masked_attention_qkv(qkv30, m, H, SCALE, FILL)
        ref30 = ops.masked_attention_qkv_plain(qkv30, m, H, SCALE, FILL)
        torch.cuda.synchronize()
        if not torch.isfinite(got30.float()).all():
            raise AssertionError("masked_attention_qkv: non-finite at |logit| ~ 1e3")
        e30 = _max_err(got30, ref30, max(float(ref30.float().abs().max()), 1e-6))
        _require(f"masked_attention_qkv N={N} x30 (scaled)", e30, 1e-2)
        ms = cuda_ms(lambda: ops.masked_attention_qkv(qkv, m, H, SCALE, FILL))
        plain_ms = cuda_ms(lambda: ops.masked_attention_qkv_plain(qkv, m, H, SCALE, FILL))
        errs.append(e)
        times.append((ms, plain_ms))
        say("2 kernel masked_attention_qkv", shape=list(qkv.shape), err=e,
            x30_scaled_err=e30, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    # one forward runs each shape once: report the sum of the two calls
    results["masked_attention_qkv"] = dict(
        max_abs_err=max(errs), ms=sum(t[0] for t in times),
        plain_ms=sum(t[1] for t in times))
    return results


def _eval_batch(gen: torch.Generator, B: int) -> dict:
    images = {m: torch.randn(B, 256, 128, 3, generator=gen, device="cuda")
              for m in ("RGB", "NI", "TI")}
    images["camid"] = torch.arange(B, device="cuda") % 6
    return images


def forward_phase(gen: torch.Generator):
    """Flagship eval forward through the kernels vs the plain fp32 run."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.models.editor import Editor, flagship_config
    from editor_tpu_torch.models.init import editor_init

    cfg = flagship_config()
    t0 = time.perf_counter()
    model = editor_init(cfg, seed=0, device="cuda")
    init_s = time.perf_counter() - t0
    ref_model = Editor(dataclasses.replace(cfg, use_pallas=False), device="cuda")
    ref_model.load_state_dict(model.state_dict(), strict=True)
    batch = _eval_batch(gen, B_EVAL)
    step = build_eval_step(model, torch.bfloat16)
    ref_step = build_eval_step(ref_model, torch.float32)

    step(batch)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    feats = step(batch)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    want = {"attention_qkv": cfg.vit.depth, "rollout_chain": 1, "masked_attention_qkv": 2}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want} in one forward")
    if feats.shape != (B_EVAL, 3 * C) or feats.dtype != torch.float32:
        raise AssertionError(f"features {tuple(feats.shape)} {feats.dtype}")
    if not torch.isfinite(feats).all():
        raise AssertionError("non-finite features")
    ref = ref_step(batch)
    torch.cuda.synchronize()
    got, ref = feats.double(), ref.double()
    cos = (torch.nn.functional.normalize(got, dim=1)
           * torch.nn.functional.normalize(ref, dim=1)).sum(1)
    rel = (got - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-12)
    if not (cos.min() >= 0.99 and rel.max() <= 0.08):
        raise AssertionError(f"bf16 kernels vs fp32 plain: min cos {cos.min()}, "
                             f"max rel-L2 {rel.max()}")
    say("3 forward", B=B_EVAL, shape=list(feats.shape), launches=json.dumps(launches),
        min_cos=f"{float(cos.min()):.6f}", max_rel_l2=f"{float(rel.max()):.6f}",
        fwd_ms=f"{fwd_ms:.2f}", init_s=f"{init_s:.2f}")
    return model, launches


def serving_phase(model, gen: torch.Generator, card: str) -> None:
    from editor_tpu_torch.serve import FeatureExtractor, GalleryIndex

    n_ids = 64
    rng = np.random.RandomState(0)
    gallery = {m: rng.randint(0, 256, (n_ids, 256, 128, 3), dtype=np.uint8)
               for m in ("RGB", "NI", "TI")}
    cams = (np.arange(n_ids) % 6).astype(np.int32)
    ex = FeatureExtractor(model, batch_size=32, compute_dtype=torch.bfloat16)
    gf = ex(gallery, cams)
    index = GalleryIndex(ex.feat_dim, feat_norm=True)
    index.add(gf, pids=list(range(n_ids)), camids=cams.tolist())
    for size in (1, 3, 32):
        pick = rng.choice(n_ids, size=size, replace=False)
        qf = ex({m: v[pick] for m, v in gallery.items()}, cams[pick])
        res = index.search(qf, topk=5)
        top1 = [r[0]["pid"] for r in res]
        if top1 != pick.tolist():
            raise AssertionError(f"query size {size}: rank-1 {top1} != {pick.tolist()}")
    lat = []
    for i in range(21):
        one = {m: v[i % n_ids:i % n_ids + 1] for m, v in gallery.items()}
        t0 = time.perf_counter()
        res = index.search(ex(one, cams[i % n_ids:i % n_ids + 1]), topk=5)
        lat.append((time.perf_counter() - t0) * 1e3)
        if res[0][0]["pid"] != i % n_ids:
            raise AssertionError("batch-1 query missed its gallery item")
    say("4 serving", gallery=n_ids, query_sizes="1,3,32", rank1="all",
        batch1_p50_ms=f"{float(np.median(lat[1:])):.2f}", card=repr(card))


def main() -> None:
    card = card_check()
    build_phase()
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = kernel_phase(gen)
    model, launches = forward_phase(gen)
    serving_phase(model, gen, card)
    rows = [dict(name=name, route="cuda", **KERNELS[name], launches=launches[name],
                 **kernels[name]) for name in KERNELS]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
