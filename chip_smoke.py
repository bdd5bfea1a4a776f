"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines and its seconds:
  0. card check: CUDA present, card name and power limit (nvidia-smi); TF32
     is switched off so the fp32 reference runs are true fp32; whether PIL
     and the libjpeg headers are present;
  1. build: nvcc compiles editor_tpu_torch/csrc/*.cu for sm_90a, one
     process per source, all started together;
  2. kernels: each hand-written kernel (K1-K3 and K6 forward, K4, K5 and K7
     backward, K8 LayerNorm -> matmul -> GELU) against its plain PyTorch
     version at the main paths' shapes in bf16, with kernel, plain and
     library-call times from CUDA events and the bound (the least time the
     card could take) worked out from this run's inputs. K1 is held against
     its plain version in the TPU kernel's form: every probs element within
     one bf16 ulp of the plain value and every row summing to 1, also at
     x30 and at shapes the model does not reach (N = 17, 200, 512; D = 96);
     its time with probs must be at most 2x SDPA's (no probs) in the same run.
     K4, K7 and K5 are also held by the share of their elements more than
     one bf16 ulp off the plain version (at most 0.5% over all of dqkv and
     over the cls rows' dk and dv), a check that must fail the unrounded form
     and, for K4 and K7, the cls-rounded (K5's) form, for K5 the cls-kept
     (K7's, tile 88) form in the same run. K4 also at N = 1, 8, 17,
     129, 200 and 512 (the chunked instance past 144), at D = 96 and D = 32,
     and at N = 512 with D = 96 and 128; its time must be at most 2x the
     SDPA backward's. K7 also at D = 32, an odd batch and a sequence masked but
     for its cls tokens; its time on the two model shapes must be at most 3x
     the SDPA backward's. K3 is held against its plain version in the TPU
     kernel's form (masked_attention_qkv_tpu_plain) by the same share test (at
     most 0.5% of its elements more than one bf16 ulp off), which must fail
     the unrounded form and the XLA form (masked_attention_qkv_plain) in the
     same run, at the two model shapes, x30, the batch-1 shapes and 12 more
     (N = 1-512, D = 32-128); masked query rows must be exact zeros. K5 at
     the same shapes (x30: the scaled error and finite values only); masked
     rows get zero gradient; its time on the two model shapes must be at
     most 2x the SDPA backward's. K6 is held against its plain version in
     the TPU kernel's form (masked_attention_tiled_plain) by the share test
     read twice, over all elements of a batch whose masks keep half the
     patches and over the valid query rows of a sparse batch (every cls
     token and a tenth of the patches kept), which must fail the unrounded
     form (the first reading) and K3's form (cls keys rounded too; the
     second) in the same run, at the uncompacted tail's shapes, x30 and 14
     more (N = 129-512, D = 32-128, tiles of 16, 64 and 128); masked query
     rows must be exact zeros; its time on the two model shapes must be at
     most 2x SDPA's with the key mask. K8 is held by the same share test
     against its plain version at both backbone shapes, which must fail the
     form that leaves the LayerNorm's output in fp32, and on wide inputs
     (pre-activations of ~1.9, biases comparable) the forms that round the
     product before the bias and apply the GELU to a rounded pre-activation;
     also a ragged row count without bias (LayerNorm parameters at a 4-byte
     offset), C = 1040 (a last k slice of 16)
     and C = 96 (one k slice); its time over both shapes must be at most 2x
     the three-call chain's;
  3. forward: the flagship tri-modal eval forward (ViT-B/16, 256x128,
     seeded random weights, B=128, bf16, compact tail) through
     build_eval_step; one forward launches K1 12, K2 1 and K3 2 times, and
     the features match the same model run with the plain ops in fp32
     (per-row cosine >= 0.99, rel-L2 <= 0.08);
  4. serving: FeatureExtractor (with the config's INPUT section) +
     GalleryIndex over 64 synthetic identities;
     queries of 1, 3 and 32 repeated gallery items must each retrieve
     themselves at rank 1; batch-1 p50 latency;
  5. train: the flagship train step (B=128 as 8 ids x 16, uint8 images
     through the augmentation, SGD with the RGBNT201 solver, bf16) through
     build_train_step; one step launches K1 12, K2 1, K3 2, K4 12 and K5 2
     times; over 3 steps the loss stays within 3% of the same model run with
     the plain ops in fp32 (same weights, batch and random draws) and the
     parameter norm within 2%; losses and gradients are finite, the BN stats
     and OCFR centers move; 20 steps on one fixed batch lower the loss; step
     time, img/s and peak memory;
  6. uncompacted: the same model with TPU.COMPACT_TAIL off (129 tokens per
     modality, 387 joint): (a) the eval forward launches K1 12, K2 1, K6 2
     and K3 0 times and matches the plain fp32 run as in phase 3; (b) the
     compact and uncompacted models with the same weights, both plain fp32,
     agree to rel-L2 <= 1e-4 (the compaction is exact); (c) the train step
     launches K1 12, K2 1, K4 12, K6 2, K7 2 and K3, K5 0 times and matches
     the plain fp32 run as in phase 5; (d) its time and memory;
  7. variants: the design-variant kernels T1-T6 of editor_tpu_torch/tools/
     (bench_attn, bench_attn2, bench_attn_layer, bench_rollout,
     bench_rollout2, bench_full_kernel), each at the flagship shape in one
     configuration, against its plain version, with kernel, plain and
     library-call times and the bound. They are on no model path: phases 3-6
     count 0 launches of each (the full sweeps are the tools' own). T1 and
     T2, the kSplit and kNoMax forms of K1's tensor-core body, are held by
     K3's share test on random-normal inputs and on inputs whose cls key
     carries most of each row's weight, which must fail the unrounded form
     (on the first) and the cls-rounded form (on the second) in the same
     run; T1 on separate q, k, v and on the column views of the packed qkv,
     1 and 2 heads and 1 and 2 sequences a block, x30 and B = 3 at N = 200;
     T2 at 1 and 2 sequences a block and B = 3 at N = 512; T1's probs as
     K1's (every element within one bf16 ulp, rows summing to 1); T1 (with
     probs) and T2 at most 2x SDPA's time. T3, whose output end to end is
     chaotic in the qkv product's summation order, is held stage by stage on
     its own workspaces (bench_attn_layer.stage_shares): qkv, attention and
     output each by the share test against the TPU form of the stage's own
     input, the attention equal to K1's on the same qkv, the forms that
     leave y, qkv or the attention in fp32 required to fail; its probs by the
     share test and the row sums, its output end to end by the scaled error;
     equal at g = 1, 2 and 4; B = 3 at N = 200 and D = 32 too; its time
     without probs at most 2x the four-call chain's (LN, linear, SDPA,
     linear). T6, K3 and K5 walking
     g sequences a block at the JAX package's groups (forward 8 and 2,
     backward 4 and 2 at [384, 88] and [128, 264]), must equal K3 and K5 at
     group 0 bit for bit; its forward is held by K3's share test against the
     TPU body's form (which must fail the unrounded and the XLA form in the
     same run), its backward by K5's check and wrong forms (the unrounded and
     the cls-kept form); forward + backward over both shapes at most 2x
     SDPA's forward + backward with the key mask;
  8. loop: the flagship through the training loop, ``cli.train`` ->
     ``do_train`` on in-memory data through a numpy decode_fn, logging,
     evaluating and checkpointing every epoch into a temporary directory
     that it deletes. The checked runs train on 16 ids x 32 items (3 steps
     of 8 ids x 16 an epoch) and evaluate as RGBNT201's test split in size
     (query = gallery = 836 items of 30 ids in 4 cameras: 1672 rows, 27
     batches of 64): (a) every step launches K1 12, K2 1, K3 2, K4 12 and K5
     2 times and every eval batch K1 12, K2 1 and K3 2 times, the run's
     totals these sums; (b) the log, metrics, config.yaml and checkpoints are
     written and the losses are finite; (d) a third epoch resumed from the
     epoch-2 checkpoint against three uninterrupted epochs: losses within
     1e-5 relative, the largest parameter difference and whether it is bit
     for bit printed (the first run saves with TPU.ASYNC_CHECKPOINT at its
     default, True, the resumed one with it off: the loop's stall per save
     both ways, each save call's wall ms); (e) cli.test on the best epoch's checkpoint (alone in
     a directory) gives the mAP the loop logged for that epoch (within
     1e-6); (c) over the features that do_inference handed the evaluator in
     (e), the card's distances within 1e-5 of the CPU evaluator's, and the
     card's CMC equal to and its mAP within 1e-6 of the CPU metric's on the
     card's distances (the CPU evaluator's end to end printed). Printed:
     eval images/s through ``evaluate`` (twice), the metric's ms, a
     checkpoint's save ms and bytes (synchronous; then the same payload saved
     asynchronously, the model and its optimizer slots changed as soon as
     the call returns, the file required equal to the synchronous one), and
     from a run of 2 epochs over 171 ids
     x 3951 items (21 steps an epoch, logging every 10, no evaluation) the
     loop's ms per step (CUDA events between step starts within an epoch,
     the run's first two steps left out: median, mean, p10, p90), the gap
     from a step's last launch to the next one's start (the next batch's
     copy and any idle), the idle share (gaps over intervals) and the loop
     step against phase 5's bare step;
  9. serve: (a) the native C++ re-ranking builds (g++) and matches the numpy
     copy within 1e-5 at 30 x 120; the device re-ranking's core on the card
     matches it within 1e-5 at 836 x 836 (RGBNT201's test split, k1 50, k2
     15) on the same distance matrix; both times, and the device version end
     to end (its own distances) against it, printed; (b) cli.export turns a
     checkpoint of the flagship into a .pth (equal to the checkpoint's
     state_dict), cli.serve.build_service on it indexes RGBNT201's test split
     in size from in-memory data (836 items, each its own random images), and
     a RetrievalServer on 127.0.0.1 answers /healthz, 32 batch-1 /query
     requests for gallery items (each retrieves itself at rank 1, its
     features bit for bit the in-process call's on the decoded images, the 32
     launching K1 12, K2 1 and K3 2 times each), a re-ranked /query (top pid
     its own), /gallery/add and a malformed request (400); HTTP batch-1 p50
     and p99 printed; (c) dump_eval_visualizations on 8 flagship images
     launches K1 12 and K2 1 per modality, and its rollouts (rel-L2 <= 0.05)
     and union token mask (agreement >= 0.9) match the plain fp32 run;
     (d) whether PIL and the libjpeg codec were available. Without PIL the
     requests carry .npy bytes through a swapped decoder and the
     visualisation's overlay arrays are held in place of its PNG files.
The model configs come from load_config(None, RGBNT201_PRESET + overrides)
through editor_config_from. Then one JSON line with each kernel's numbers
(K1-K8, T1-T6; launches by path: compact, uncompacted, loop, serve), and last the result line {"ok": true, "device": {...}}. Any failed check
raises, so the script exits non-zero without the result line; it does the
same without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
    "attention_qkv_bwd": dict(source="editor_tpu_torch/csrc/attention_qkv_bwd.cu",
                              replaces="editor_tpu/ops/fused_attention.py:205"),
    "masked_attention_qkv_bwd": dict(source="editor_tpu_torch/csrc/masked_attention_bwd.cu",
                                     replaces="editor_tpu/ops/masked_attention.py:183"),
    "masked_attention_tiled": dict(source="editor_tpu_torch/csrc/masked_attention.cu",
                                   replaces="editor_tpu/ops/masked_attention.py:264"),
    "masked_attention_tiled_bwd": dict(source="editor_tpu_torch/csrc/masked_attention_bwd.cu",
                                       replaces="editor_tpu/ops/masked_attention.py:394"),
    "ln_matmul": dict(source="editor_tpu_torch/csrc/ln_matmul.cu",
                      replaces="editor_tpu/ops/fused_linear.py:75"),
}
# The design-variant kernels T1-T6 (phase 7), each counted where it launches:
# T1-T5 by the wrapper of the same name in their tool module, T6 by K3's and
# K5's launches at a group g >= 1, not the model paths' 0 (launch_counts)
VARIANTS = {
    "headgrid_attn": dict(tool="bench_attn",
                          source="editor_tpu_torch/csrc/attention_variants.cu",
                          replaces="tools/bench_attn.py:68"),
    "nomax_attn": dict(tool="bench_attn2", source="editor_tpu_torch/csrc/attention_variants.cu",
                       replaces="tools/bench_attn2.py:56"),
    "attn_layer": dict(tool="bench_attn_layer", source="editor_tpu_torch/csrc/attn_layer.cu",
                       replaces="tools/bench_attn_layer.py:77"),
    "chain": dict(tool="bench_rollout", source="editor_tpu_torch/csrc/rollout_chain.cu",
                  replaces="tools/bench_rollout.py:71"),
    "chain_multi": dict(tool="bench_rollout2", source="editor_tpu_torch/csrc/rollout_chain.cu",
                        replaces="tools/bench_rollout2.py:64"),
    "masked_full": dict(tool="bench_full_kernel",
                        source="editor_tpu_torch/csrc/masked_attention.cu",
                        source_bwd="editor_tpu_torch/csrc/masked_attention_bwd.cu",
                        replaces="tools/bench_full_kernel.py:33"),
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
    import importlib.util

    say("0 card", name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, tf32="off",
        pil=importlib.util.find_spec("PIL") is not None,
        jpeglib_h=os.path.exists("/usr/include/jpeglib.h"))
    return card


def build_phase() -> None:
    from editor_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    say("1 build", seconds=f"{time.perf_counter() - t0:.2f}", lib=_build.library_path().name)


def cuda_ms(fn, iters: int = 10) -> float:
    """ms per call from CUDA events over ``iters`` calls after 2 warm-ups."""
    from editor_tpu_torch.tools import _bench

    return _bench.cuda_ms(fn, iters, warmup=2)


def _max_err(got, ref, scale: float = 1.0) -> float:
    return float(((got.float() - ref.float()).abs() / scale).max())


def _require(name: str, err: float, tol: float) -> None:
    if not err <= tol:  # also catches NaN
        raise AssertionError(f"{name}: max abs error {err} > {tol}")


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take (``_bench.bound``: bytes over the
    HBM rate or operations over the bf16 tensor-core peak, the larger), with
    the work it was worked out from."""
    from editor_tpu_torch.tools import _bench

    ms, by = _bench.bound(flops, nbytes)
    return dict(bound_ms=ms, bound_by=by, flops=flops, bytes=nbytes)


def _heads(qkv):
    """[B, N, 3C] -> q, k, v head views [B, H, N, D] (no copy)."""
    B, N, _ = qkv.shape
    return qkv.view(B, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)


def _sdpa_bwd_ms(qkv, g, key_mask=None) -> float:
    """The backward of one scaled_dot_product_attention call, timed as
    (forward + backward) - forward on contiguous head tensors."""
    F = torch.nn.functional
    q, k, v = (t.contiguous().requires_grad_() for t in _heads(qkv))
    gh = g.view(*g.shape[:2], H, D).transpose(1, 2).contiguous()
    mask = None if key_mask is None else key_mask[:, None, None, :]

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=SCALE)

    both = cuda_ms(lambda: torch.autograd.grad(fwd(), (q, k, v), gh))
    return both - cuda_ms(fwd)


def _bf16_ulps(got, ref) -> float:
    """The largest |got - ref| in units of (one bf16 ulp of |ref| at that
    element + 1e-6); at most 1 where every element is the plain value or
    one bf16 step from it."""
    from editor_tpu_torch.tools import _bench

    return float(((got.float() - ref.float()).abs() / (_bench.bf16_ulp(ref) + 1e-6)).max())


def _probs_errors(name: str, probs, ref_probs, own_qkv: bool = False) -> dict:
    """Probs against the plain version's (K1, T1, T3): every element within
    one bf16 ulp of the plain value at that element (the two round the same
    fp32 p and differ only in summation order), or with ``own_qkv`` (T3,
    which makes its qkv itself, where a qkv element rounded the other way
    moves a row's logits and its probs by up to 2 ulps) at most SHARE_TOL of
    the elements more than one bf16 ulp off (``_bench.bf16_off_share``);
    every row sums to 1 within 1e-2. A wrong or missing store of many small
    probabilities, or of a row, fails one of the two."""
    from editor_tpu_torch.tools import _bench

    ulps = _bf16_ulps(probs, ref_probs)
    out = dict(probs_err=_max_err(probs, ref_probs), probs_ulps=ulps)
    if own_qkv:
        out["probs_share"] = _bench.bf16_off_share(probs, ref_probs)
        _require(f"{name} probs share off the plain version", out["probs_share"], SHARE_TOL)
    else:
        _require(f"{name} probs in bf16 ulps", ulps, 1.0)
    out["row_sum_err"] = float((probs.float().sum(-1) - 1.0).abs().max())
    _require(f"{name} probs row sums", out["row_sum_err"], 1e-2)
    return out


def _at_most_2x_sdpa(name: str, ms: float, sdpa_ms: float) -> None:
    """An unmasked forward (K1, T1, T2) must take at most twice the time of
    one SDPA call on the same inputs, timed in the same run."""
    if not ms <= 2.0 * sdpa_ms:
        raise AssertionError(f"{name}: {ms} ms, more than 2x SDPA's {sdpa_ms} ms")


def _k1_errors(name: str, out, probs, ref, scaled: bool = False) -> dict:
    """K1's output and probs against its plain version ``ref`` = (out,
    probs): out within 2e-2 (scaled by its largest magnitude: 1e-2); the
    probs by _probs_errors."""
    ref_out, ref_probs = ref
    e_out = _scaled(out, ref_out) if scaled else _max_err(out, ref_out)
    _require(f"{name} out" + (" (scaled)" if scaled else ""), e_out, 1e-2 if scaled else 2e-2)
    return dict(out_err=e_out, **_probs_errors(name, probs, ref_probs))


def kernel_phase(gen: torch.Generator) -> dict:
    """Each kernel against its plain version at the main path's shapes, with
    its time, its plain version's, one library call's where one computes the
    same function, and its bound."""
    from editor_tpu_torch import ops

    F = torch.nn.functional
    dev = "cuda"
    results = {}

    def randn(*shape, mul=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * mul).to(torch.bfloat16)

    # K1 at the backbone shape [3 x 128, 129, 3C], with and without probs,
    # and x30 (|logit| ~ 1e3), against its plain version in the TPU kernel's
    # rounding form; then the shapes the wrapper takes beyond the model's
    Bk, N = 3 * B_EVAL, 129
    qkv = randn(Bk, N, 3 * C)
    probs = torch.empty(Bk, H, N, N, dtype=torch.bfloat16, device=dev)
    out, _ = ops.attention_qkv(qkv, H, SCALE, probs_out=probs)
    out_np, _ = ops.attention_qkv(qkv, H, SCALE)
    torch.cuda.synchronize()
    k1 = _k1_errors("attention_qkv", out, probs, ops.attention_qkv_tpu_plain(qkv, H, SCALE, True))
    e_out, e_probs = max(k1["out_err"], _max_err(out_np, out)), k1["probs_err"]
    _require("attention_qkv out without probs", e_out, 2e-2)
    qkv30 = randn(Bk, N, 3 * C, mul=30.0)
    out30, _ = ops.attention_qkv(qkv30, H, SCALE, probs_out=probs)
    torch.cuda.synchronize()
    if not torch.isfinite(out30.float()).all():
        raise AssertionError("attention_qkv: non-finite output at |logit| ~ 1e3")
    k1_30 = _k1_errors("attention_qkv x30", out30, probs,
                       ops.attention_qkv_tpu_plain(qkv30, H, SCALE, True), scaled=True)
    del out30
    # B = 3 (the batch-1 serving shape at N = 129) at the token counts and
    # head dims the wrapper takes: below, at and past one key chunk, the most
    # tokens, and D = 96 (vit_small_config). At N = 129 the probs start 2
    # bytes past a 16-byte boundary, as a layer slice of the serving path's
    # [L, 3, H, N, N] buffer does
    extra = {}
    for Bx, Nx, Hx, Dx in ((3, 17, H, D), (3, N, H, D), (3, 200, H, D), (3, 512, H, D),
                           (3, N, 8, 96)):
        qx = randn(Bx, Nx, 3 * Hx * Dx)
        shift = int(Nx == N and Dx == D)
        px = torch.empty(shift + Bx * Hx * Nx * Nx, dtype=torch.bfloat16,
                         device=dev)[shift:].view(Bx, Hx, Nx, Nx)
        ox, _ = ops.attention_qkv(qx, Hx, Dx ** -0.5, probs_out=px)
        torch.cuda.synchronize()
        e = _k1_errors(f"attention_qkv B={Bx} N={Nx} H={Hx} D={Dx}", ox, px,
                       ops.attention_qkv_tpu_plain(qx, Hx, Dx ** -0.5, True))
        extra[f"N{Nx}_H{Hx}_D{Dx}"] = e
    e_extra = max(max(e["out_err"], e["probs_err"]) for e in extra.values())
    ms = cuda_ms(lambda: ops.attention_qkv(qkv, H, SCALE, probs_out=probs))
    ms_np = cuda_ms(lambda: ops.attention_qkv(qkv, H, SCALE))
    plain_ms = cuda_ms(lambda: ops.attention_qkv_tpu_plain(qkv, H, SCALE, True))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*_heads(qkv), scale=SCALE))
    # reads qkv, writes out and probs; q.k and p.v products
    b = bound(4.0 * Bk * H * N * N * D, 2.0 * (Bk * N * 3 * C + Bk * N * C + Bk * H * N * N))
    _at_most_2x_sdpa("attention_qkv", ms, lib_ms)
    results["attention_qkv"] = dict(max_abs_err=max(e_out, e_probs, e_extra), ms=ms,
                                    plain_ms=plain_ms, library_ms=lib_ms, ms_no_probs=ms_np,
                                    **b)
    say("2 kernel attention_qkv", shape=list(qkv.shape), out_err=e_out, probs_err=e_probs,
        probs_ulps=k1["probs_ulps"], row_sum_err=k1["row_sum_err"],
        x30_scaled_err=k1_30["out_err"], x30_probs_ulps=k1_30["probs_ulps"],
        extra=json.dumps(extra), ms=f"{ms:.4f}", ms_no_probs=f"{ms_np:.4f}",
        plain_ms=f"{plain_ms:.4f}", sdpa_ms=f"{lib_ms:.4f}", bound_ms=f"{b['bound_ms']:.4f}")

    # K4, the VJP of K1, at the same shape: the scaled error, the share of
    # elements off the plain version (a check that must fail the two wrong
    # forms), |logit| ~ 1e3 with the x30 input, and the shapes the wrapper
    # takes beyond the model's
    g = randn(Bk, N, C)
    dq = ops.attention_qkv_bwd(qkv, g, H, SCALE)
    ref_dq = ops.attention_qkv_bwd_plain(qkv, g, H, SCALE)
    dq30 = ops.attention_qkv_bwd(qkv30, g, H, SCALE)
    ref_dq30 = ops.attention_qkv_bwd_plain(qkv30, g, H, SCALE)
    torch.cuda.synchronize()
    e4, e4_30 = _scaled(dq, ref_dq), _scaled(dq30, ref_dq30)
    _require("attention_qkv_bwd (scaled)", e4, 1e-2)
    if not torch.isfinite(dq30.float()).all():
        raise AssertionError("attention_qkv_bwd: non-finite at |logit| ~ 1e3")
    _require("attention_qkv_bwd x30 (scaled)", e4_30, 1e-2)
    del dq30, ref_dq30
    shares = _bwd_shares("attention_qkv_bwd", dq, ref_dq, N, C)
    caught = _wrong_forms(
        "attention_qkv_bwd",
        ops.attention_qkv_bwd_plain(qkv.float(), g.float(), H, SCALE).to(torch.bfloat16),
        ops.masked_attention_qkv_bwd_plain(qkv, torch.ones(Bk, N, device=dev), g, H, SCALE),
        ref_dq, N, C)
    del ref_dq
    extra4 = _k4_extra_shapes(randn)
    ms = cuda_ms(lambda: ops.attention_qkv_bwd(qkv, g, H, SCALE))
    plain_ms = cuda_ms(lambda: ops.attention_qkv_bwd_plain(qkv, g, H, SCALE))
    lib_ms = _sdpa_bwd_ms(qkv, g)
    # reads qkv and g, writes dqkv; logits recompute, dp, dq, dk, dv
    b = bound(10.0 * Bk * H * N * N * D, 2.0 * Bk * N * (3 * C + C + 3 * C))
    if not ms <= 2.0 * lib_ms:
        raise AssertionError(f"attention_qkv_bwd: {ms} ms, more than 2x the SDPA "
                             f"backward's {lib_ms} ms")
    results["attention_qkv_bwd"] = dict(max_abs_err=e4, ms=ms, plain_ms=plain_ms,
                                        library_ms=lib_ms, **shares, wrong_forms=caught,
                                        extra_shapes=extra4, **b)
    say("2 kernel attention_qkv_bwd", shape=list(qkv.shape), scaled_err=e4,
        x30_scaled_err=e4_30, share=shares["share"], cls_share=shares["cls_share"],
        share_tol=SHARE_TOL, wrong_forms=json.dumps(caught), ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", sdpa_bwd_ms=f"{lib_ms:.4f}",
        factor=f"{ms / lib_ms:.3f}", bound_ms=f"{b['bound_ms']:.4f}")
    say("2 kernel attention_qkv_bwd extra shapes", checks=json.dumps(extra4))
    del qkv, probs, out, out_np, qkv30, g, dq

    # K2 at L = 12, Z = 3 x 128 x 12 = 4608, N = 129. Peaked maps (softmax of
    # 4 x randn), so the chain keeps the layer order visible in its output.
    # Kernel and plain version read the same bf16 maps and both sum in fp32,
    # so they differ only by summation order (~1e-8); the limit 1e-5 is far
    # tighter than the TPU test's 5e-3, which a constant output would pass.
    L, Bz = 12, 3 * B_EVAL
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
    # reads every map once, writes the fp32 rows; L - 1 vector-matrix products
    b = bound(2.0 * (L - 1) * Bz * H * N * N, 2.0 * L * Bz * H * N * N + 4.0 * Bz * H * (N - 1))
    results["rollout_chain"] = dict(max_abs_err=e_roll, ms=ms, plain_ms=plain_ms,
                                    library_ms=None, **b)
    say("2 kernel rollout_chain", L=L, Z=Bz * H, N=N, err=e_roll, tol=tol_roll,
        spread=f"{float(ref_roll.std()):.6f}",
        bug_errs=json.dumps({k: round(v, 6) for k, v in bug_errs.items()}),
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b['bound_ms']:.4f}")
    del maps, roll, ref_roll

    # K3 and K5 at the per-modality [384, 88, 3C] and joint [128, 264, 3C]
    # shapes; the batch-1 serving shapes first. K3 is held to its plain
    # version in the TPU kernel's form by the share test (_fwd_check), which
    # must fail the unrounded and the XLA form in the same run; K5 by the
    # shares over all of dqkv and the rows m % 88 == 0 (_k5_check), which must
    # fail the unrounded and the cls-kept form
    k3_batch1, k5_batch1 = {}, {}
    for Bm, N in ((3, 88), (1, 264)):
        qkv = randn(Bm, N, 3 * C)
        m = (torch.rand(Bm, N, generator=gen, device=dev) < 0.5).float()
        m[:, 0] = 1.0
        k3_batch1[f"B{Bm}_N{N}"] = _fwd_check(
            f"masked_attention_qkv batch-1 N={N}", ops.masked_attention_qkv(qkv, m, H, SCALE, FILL),
            ops.masked_attention_qkv_tpu_plain(qkv, m, H, SCALE, FILL), m)
        g = randn(Bm, N, C)
        k5_batch1[f"B{Bm}_N{N}"] = _k5_check(
            f"masked_attention_qkv_bwd batch-1 N={N}",
            ops.masked_attention_qkv_bwd(qkv, m, g, H, SCALE, FILL),
            ops.masked_attention_qkv_bwd_plain(qkv, m, g, H, SCALE, FILL), m, C)
    say("2 kernel masked_attention_qkv batch-1", checks=json.dumps(k3_batch1))
    say("2 kernel masked_attention_qkv_bwd batch-1", checks=json.dumps(k5_batch1))
    fwd, bwd = [], []
    for Bm, N in ((3 * B_EVAL, 88), (B_EVAL, 264)):
        qkv = randn(Bm, N, 3 * C)
        m = torch.rand(Bm, N, generator=gen, device=dev) < 0.5
        m = (m | (torch.arange(N, device=dev) % 88 == 0)[None, :]).float()
        m[0, 1:] = 0.0  # one sequence with only its cls token
        got = ops.masked_attention_qkv(qkv, m, H, SCALE, FILL)
        ref = ops.masked_attention_qkv_tpu_plain(qkv, m, H, SCALE, FILL)
        k3 = _fwd_check(f"masked_attention_qkv N={N}", got, ref, m)
        caught = _k3_wrong_forms(qkv, m, ref, H, D)
        del got, ref
        qkv30 = randn(Bm, N, 3 * C, mul=30.0)
        k3_30 = _fwd_check(f"masked_attention_qkv N={N} x30", ops.masked_attention_qkv(
            qkv30, m, H, SCALE, FILL), ops.masked_attention_qkv_tpu_plain(qkv30, m, H, SCALE, FILL),
            m, scaled=True)
        ms = cuda_ms(lambda: ops.masked_attention_qkv(qkv, m, H, SCALE, FILL))
        plain_ms = cuda_ms(lambda: ops.masked_attention_qkv_tpu_plain(qkv, m, H, SCALE, FILL))
        # timed only: a key mask, as a fully masked query row differs there
        keys = m.bool()[:, None, None, :]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*_heads(qkv), attn_mask=keys,
                                                                scale=SCALE))
        # the work this mask needs: valid query rows x valid keys
        pairs = float((m.sum(1) ** 2).sum())
        nbytes = 2.0 * Bm * N * (3 * C + C) + 4.0 * Bm * N
        fwd.append(dict(err=k3["err"], ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        flops=4.0 * H * D * pairs, bytes=nbytes, share=k3["share"],
                        wrong_forms=caught))
        say("2 kernel masked_attention_qkv", shape=list(qkv.shape), err=k3["err"],
            share=k3["share"], share_tol=SHARE_TOL, wrong_forms=json.dumps(caught),
            x30_scaled_err=k3_30["err"], x30_share=k3_30["share"], ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", sdpa_ms=f"{lib_ms:.4f}",
            bound_ms=f"{bound(4.0 * H * D * pairs, nbytes)['bound_ms']:.4f}")

        g = randn(Bm, N, C)
        dq = ops.masked_attention_qkv_bwd(qkv, m, g, H, SCALE, FILL)
        ref_dq = ops.masked_attention_qkv_bwd_plain(qkv, m, g, H, SCALE, FILL)
        k5 = _k5_check(f"masked_attention_qkv_bwd N={N}", dq, ref_dq, m, C)
        caught = _wrong_forms(
            "masked_attention_qkv_bwd",
            ops.masked_attention_qkv_bwd_plain(qkv.float(), m, g.float(), H, SCALE,
                                               FILL).to(torch.bfloat16),
            ops.masked_attention_tiled_bwd_plain(qkv, m, g, H, SCALE, FILL, K5_CLS_ROWS),
            ref_dq, K5_CLS_ROWS, C, "cls_kept")
        dq30 = ops.masked_attention_qkv_bwd(qkv30, m, g, H, SCALE, FILL)
        ref_dq30 = ops.masked_attention_qkv_bwd_plain(qkv30, m, g, H, SCALE, FILL)
        torch.cuda.synchronize()
        e5_30 = _scaled(dq30, ref_dq30)
        if not torch.isfinite(dq30.float()).all():
            raise AssertionError("masked_attention_qkv_bwd: non-finite at |logit| ~ 1e3")
        _require(f"masked_attention_qkv_bwd N={N} x30 (scaled)", e5_30, 1e-2)
        ms = cuda_ms(lambda: ops.masked_attention_qkv_bwd(qkv, m, g, H, SCALE, FILL))
        plain_ms = cuda_ms(lambda: ops.masked_attention_qkv_bwd_plain(qkv, m, g, H, SCALE,
                                                                      FILL))
        lib_ms = _sdpa_bwd_ms(qkv, g, m.bool())
        nbytes = 2.0 * Bm * N * (3 * C + C + 3 * C) + 4.0 * Bm * N
        bwd.append(dict(err=k5["scaled_err"], ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        flops=10.0 * H * D * pairs, bytes=nbytes, share=k5["share"],
                        cls_share=k5["cls_share"], wrong_forms=caught))
        say("2 kernel masked_attention_qkv_bwd", shape=list(qkv.shape),
            scaled_err=k5["scaled_err"], share=k5["share"], cls_share=k5["cls_share"],
            share_tol=SHARE_TOL, wrong_forms=json.dumps(caught), x30_scaled_err=e5_30,
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", sdpa_bwd_ms=f"{lib_ms:.4f}",
            bound_ms=f"{bound(10.0 * H * D * pairs, nbytes)['bound_ms']:.4f}")
        del qkv, qkv30, g, dq, ref_dq, dq30, ref_dq30
    k3_extra, k5_extra = _k35_extra_shapes(randn, gen)
    # one forward (one train step) runs each shape once: report the sums
    _sum_rows(results, "masked_attention_qkv", fwd)
    results["masked_attention_qkv"].update(
        shares=[c["share"] for c in fwd], wrong_forms=[c["wrong_forms"] for c in fwd],
        batch1=k3_batch1, extra_shapes=k3_extra)
    say("2 kernel masked_attention_qkv extra shapes", checks=json.dumps(k3_extra))
    _sum_rows(results, "masked_attention_qkv_bwd", bwd)
    k5_ms, sdpa_ms = sum(r["ms"] for r in bwd), sum(r["library_ms"] for r in bwd)
    if not k5_ms <= 2.0 * sdpa_ms:
        raise AssertionError(f"masked_attention_qkv_bwd: {k5_ms} ms on the model shapes, "
                             f"more than 2x the SDPA backward's {sdpa_ms} ms")
    say("2 sum masked_attention_qkv_bwd vs sdpa_bwd", ms=f"{k5_ms:.4f}",
        sdpa_bwd_ms=f"{sdpa_ms:.4f}", factor=f"{k5_ms / sdpa_ms:.3f}", limit="2")
    results["masked_attention_qkv_bwd"].update(
        shares=[c["share"] for c in bwd], cls_shares=[c["cls_share"] for c in bwd],
        wrong_forms=[c["wrong_forms"] for c in bwd], batch1=k5_batch1, extra_shapes=k5_extra)
    say("2 kernel masked_attention_qkv_bwd extra shapes", checks=json.dumps(k5_extra))
    tiled_kernels(randn, gen, results)
    ln_matmul_kernel(randn, gen, results)
    return results


def _sum_rows(results: dict, name: str, calls: list, phase: str = "2") -> None:
    """One row of the kernels line from the shapes one forward (or one train
    step) runs once each: times and work summed, the largest error."""
    b = bound(sum(c["flops"] for c in calls), sum(c["bytes"] for c in calls))
    results[name] = dict(max_abs_err=max(c["err"] for c in calls),
                         ms=sum(c["ms"] for c in calls),
                         plain_ms=sum(c["plain_ms"] for c in calls),
                         library_ms=sum(c["library_ms"] for c in calls), **b)
    say(f"{phase} sum {name}", ms=f"{results[name]['ms']:.4f}",
        bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"])


def _scaled(got, ref) -> float:
    return _max_err(got, ref, max(float(ref.float().abs().max()), 1e-6))


SHARE_TOL = 0.005  # share of elements more than one bf16 ulp off the plain version


def _bwd_shares(name: str, dq, ref, T: int, Cx: int) -> dict:
    """The rounding checks of K4, K7 and K5 (``_bench.bf16_off_share``, one
    bf16 ulp of the plain element + 1e-6 of the max): over all of dqkv, and
    over the cls rows' dk and dv (rows m % T == 0, columns Cx: onward; K4's
    only cls row is row 0: T = N; K5 has no cls key and reads the tail's cls
    tokens, T = 88, where K7's form would keep fp32), each at most SHARE_TOL
    of the elements off the plain version in the TPU form."""
    from editor_tpu_torch.tools import _bench

    share = _bench.bf16_off_share(dq, ref)
    cls = _bench.bf16_off_share(dq[:, ::T, Cx:], ref[:, ::T, Cx:])
    _require(f"{name} share off the plain version", share, SHARE_TOL)
    _require(f"{name} cls rows' dk, dv share off the plain version", cls, SHARE_TOL)
    return dict(share=share, cls_share=cls)


def _wrong_forms(name: str, unrounded, cls_form, ref, T: int, Cx: int,
                 cls_label: str = "cls_rounded") -> dict:
    """The share tests must fail the wrong forms they exist to catch: the
    unrounded form (the plain version on fp32 inputs, rounded once) over all
    elements, and ``cls_form`` over the cls rows' dk and dv (as in
    _bwd_shares): for K4 and K7 the cls-rounded form (K5's,
    masked_attention_qkv_bwd_plain: every key's weights rounded), for K5 the
    cls-kept form (K7's, masked_attention_tiled_bwd_plain with tile T: the
    keys m % T == 0 in fp32), which K7's launcher would take at K5's N."""
    from editor_tpu_torch.tools import _bench

    caught = {"unrounded_share": _bench.bf16_off_share(unrounded, ref),
              f"{cls_label}_cls_share": _bench.bf16_off_share(cls_form[:, ::T, Cx:],
                                                              ref[:, ::T, Cx:])}
    for form, share in caught.items():
        if not share > SHARE_TOL:
            raise AssertionError(f"{name} share test too loose: the {form} is off in only "
                                 f"{share} of the elements")
    return caught


def _fwd_check(name: str, got, ref, m, scaled: bool = False, rows: bool = False) -> dict:
    """A masked forward (K3, K6, T6's; T1's and T2's with every key kept)
    against its plain version in the TPU kernel's form: finite; within 2e-2
    (scaled by the largest magnitude: 1e-2); query rows with mask 0 exact
    zeros; at most SHARE_TOL of the elements more than one bf16 ulp (+1e-6 of
    the max) off (``_bench.bf16_off_share``: the two round at the same points
    and differ only in the order of the fp32 sums), read over all elements,
    or with ``rows`` over the valid query rows only (K6's sparse batch, where
    the cls keys carry weight)."""
    from editor_tpu_torch.tools import _bench

    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err = _scaled(got, ref) if scaled else _max_err(got, ref)
    _require(name + (" (scaled)" if scaled else ""), err, 1e-2 if scaled else 2e-2)
    if torch.count_nonzero(got[m == 0]):
        raise AssertionError(f"{name}: masked query rows not 0")
    valid = m.bool()
    share = (_bench.bf16_off_share(got[valid], ref[valid]) if rows
             else _bench.bf16_off_share(got, ref))
    _require(f"{name} share off the plain version" + (" (valid rows)" if rows else ""),
             share, SHARE_TOL)
    return dict(err=err, share=share)


def _k3_wrong_forms(qkv, m, ref, Hx: int, Dx: int) -> dict:
    """K3's share test must fail the wrong forms it exists to catch: the
    unrounded form (the TPU-form plain version on fp32 inputs, rounded once)
    and the XLA form (masked_attention_qkv_plain: normalised, re-masked
    weights rounded), each more than SHARE_TOL of the elements off."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.tools import _bench

    caught = dict(
        unrounded_share=_bench.bf16_off_share(ops.masked_attention_qkv_tpu_plain(
            qkv.float(), m, Hx, Dx ** -0.5, FILL).to(torch.bfloat16), ref),
        xla_share=_bench.bf16_off_share(ops.masked_attention_qkv_plain(
            qkv, m, Hx, Dx ** -0.5, FILL), ref))
    for form, share in caught.items():
        if not share > SHARE_TOL:
            raise AssertionError(f"masked_attention_qkv share test too loose: the {form} is "
                                 f"off in only {share} of the elements")
    return caught


def _t12_wrong_forms(name: str, unrounded, ref, cls_rounded, ref_cls) -> dict:
    """T1's and T2's share test must fail the wrong forms it exists to catch:
    the unrounded form (the plain version on fp32 inputs, rounded once) on
    random-normal inputs (``ref``), and the cls-rounded form
    (attention_qkv_plain, the model path's XLA form: p_0 rounded to bf16
    too) on the cls-heavy inputs (``ref_cls``, bench_attn.cls_heavy), where
    p_0 v_0 weighs enough for its rounding to show; on random-normal inputs
    that form is only ~0.5% off."""
    from editor_tpu_torch.tools import _bench

    caught = dict(unrounded_share=_bench.bf16_off_share(unrounded, ref),
                  cls_rounded_share=_bench.bf16_off_share(cls_rounded, ref_cls))
    for form, share in caught.items():
        if not share > SHARE_TOL:
            raise AssertionError(f"{name} share test too loose: the {form} is off in only "
                                 f"{share} of the elements")
    return caught


K5_CLS_ROWS = 88  # the rows K5's cls-row share reads: m % 88 == 0, the tail's cls tokens


def _k5_check(name: str, dq, ref, m, Cx: int) -> dict:
    """K5 against its plain version (the TPU kernel's form): finite; within
    1e-2 scaled by the largest magnitude; masked rows get zero gradient (q,
    and as keys k and v); at most SHARE_TOL of all elements and of the dk
    and dv of the rows m % 88 == 0 more than one bf16 ulp off (_bwd_shares)."""
    torch.cuda.synchronize()
    if not torch.isfinite(dq.float()).all():
        raise AssertionError(f"{name}: non-finite dqkv")
    err = _scaled(dq, ref)
    _require(f"{name} (scaled)", err, 1e-2)
    if torch.count_nonzero(dq[m == 0]):
        raise AssertionError(f"{name}: masked rows get a gradient")
    return dict(scaled_err=err, **_bwd_shares(name, dq, ref, K5_CLS_ROWS, Cx))


def _k35_extra_shapes(randn, gen: torch.Generator) -> tuple:
    """K3 and K5 beyond the model's shapes, held as at them (_fwd_check,
    _k5_check), each with a sequence masked but for its cls token: B = 3 at
    N = 1, 15, 16, 17 (one 16-row tile and past it), 144 and 145 (the last
    resident N and the first chunked one at D <= 96), 200 and 512 (D = 64,
    H = 12); N = 264 at D = 32 (H = 12), 96 (H = 8) and 128 (H = 6; K3 in 4
    key chunks of 80; at both K5's half-staged instance); N = 512 at D = 128
    (H = 6), where K3's k and v no longer fit in shared memory whole and come
    a chunk at a time. Returns (K3's checks, K5's checks)."""
    from editor_tpu_torch import ops

    dev, k3, k5 = "cuda", {}, {}
    shapes = [(Nx, H, D) for Nx in (1, 15, 16, 17, 144, 145, 200, 512)]
    shapes += [(264, H, 32), (264, 8, 96), (264, 6, 128), (512, 6, 128)]
    for Nx, Hx, Dx in shapes:
        Cx = Hx * Dx
        qkv, g = randn(3, Nx, 3 * Cx), randn(3, Nx, Cx)
        m = (torch.rand(3, Nx, generator=gen, device=dev) < 0.5).float()
        m[:, 0] = 1.0
        m[1, 1:] = 0.0
        case = f"B=3 N={Nx} H={Hx} D={Dx}"
        k3[f"N{Nx}_H{Hx}_D{Dx}"] = _fwd_check(
            f"masked_attention_qkv {case}",
            ops.masked_attention_qkv(qkv, m, Hx, Dx ** -0.5, FILL),
            ops.masked_attention_qkv_tpu_plain(qkv, m, Hx, Dx ** -0.5, FILL), m)
        k5[f"N{Nx}_H{Hx}_D{Dx}"] = _k5_check(
            f"masked_attention_qkv_bwd {case}",
            ops.masked_attention_qkv_bwd(qkv, m, g, Hx, Dx ** -0.5, FILL),
            ops.masked_attention_qkv_bwd_plain(qkv, m, g, Hx, Dx ** -0.5, FILL), m, Cx)
    return k3, k5


def _k4_extra_shapes(randn) -> dict:
    """K4 beyond the model's shape, held to the same limits as at it (scaled
    error, shares with the cls row 0): B = 3 at N = 1 and 8 (less than one
    16-key tile), 17, 129, 200 and 512 (the chunked instance past 144
    tokens; D = 64), N = 129 at D = 96 (H = 8) and at D = 32 (H = 12), and
    N = 512 at D = 96 (H = 8) and D = 128 (H = 6), where only k and q of the
    chunked instance fit in shared memory."""
    from editor_tpu_torch import ops

    out = {}
    for Bx, Nx, Hx, Dx in ((3, 1, H, D), (3, 8, H, D), (3, 17, H, D), (3, 129, H, D),
                           (3, 200, H, D), (3, 512, H, D), (3, 129, 8, 96), (3, 129, H, 32),
                           (3, 512, 8, 96), (3, 512, 6, 128)):
        Cx = Hx * Dx
        qkv, g = randn(Bx, Nx, 3 * Cx), randn(Bx, Nx, Cx)
        name = f"attention_qkv_bwd B={Bx} N={Nx} H={Hx} D={Dx}"
        dq = ops.attention_qkv_bwd(qkv, g, Hx, Dx ** -0.5)
        ref = ops.attention_qkv_bwd_plain(qkv, g, Hx, Dx ** -0.5)
        torch.cuda.synchronize()
        e = _scaled(dq, ref)
        _require(f"{name} (scaled)", e, 1e-2)
        out[f"N{Nx}_H{Hx}_D{Dx}"] = dict(scaled_err=e, **_bwd_shares(name, dq, ref, Nx, Cx))
    return out


def _k7_extra_shapes(randn, gen: torch.Generator) -> dict:
    """K7 beyond the model's shapes, held to the same limits as phase 2's:
    D = 32 (H = 12, C = 384, deit_small's head) at [4, 387]; an odd B (3) at
    N = 387; a sequence whose mask is all zero but for its cls tokens."""
    from editor_tpu_torch import ops

    dev, T, out = "cuda", 129, {}
    for label, Bx, Dx, cls_only in (("D32", 4, 32, False), ("B3", 3, D, False),
                                    ("cls_only", 2, D, True)):
        Nx, Cx = 3 * T, H * Dx
        qkv, g = randn(Bx, Nx, 3 * Cx), randn(Bx, Nx, Cx)
        keep = torch.arange(Nx, device=dev) % T == 0
        m = ((torch.rand(Bx, Nx, generator=gen, device=dev) < 0.5) | keep[None, :]).float()
        if cls_only:
            m[1] = keep.float()
        name = f"masked_attention_tiled_bwd {label} [{Bx}, {Nx}] D={Dx}"
        dq = ops.masked_attention_tiled_bwd(qkv, m, g, H, Dx ** -0.5, FILL, T)
        ref = ops.masked_attention_tiled_bwd_plain(qkv, m, g, H, Dx ** -0.5, FILL, T)
        torch.cuda.synchronize()
        e = _scaled(dq, ref)
        _require(f"{name} (scaled)", e, 1e-2)
        if dq[..., :Cx][m == 0].abs().max() != 0 or dq[..., Cx:][m == 0].abs().max() != 0:
            raise AssertionError(f"{name}: masked rows get a gradient")
        out[label] = dict(scaled_err=e, **_bwd_shares(name, dq, ref, T, Cx))
    return out


def _tiled_mask(gen: torch.Generator, B: int, N: int, T: int, keep: float):
    """[B, N] float: patches kept with probability ``keep``, every cls token
    (m % T == 0) kept."""
    m = torch.rand(B, N, generator=gen, device="cuda") < keep
    return (m | (torch.arange(N, device="cuda") % T == 0)[None, :]).float()


SPARSE_KEEP = 0.1  # the patches K6's second reading keeps: the cls keys carry weight


def _k6_wrong_forms(qkv, m, ref, ms, ref_s, Hx: int, Dx: int, T: int) -> dict:
    """K6's share test must fail the wrong forms it exists to catch, each in
    the reading that catches it: the unrounded form (the plain version on
    fp32 inputs, rounded once) over all elements of the half-kept batch
    (``m``, ``ref``), and K3's form (masked_attention_qkv_tpu_plain: the cls
    keys' exps rounded too) over the valid query rows of the sparse batch
    (``ms``, ``ref_s``); over all elements of the half-kept batch it sits
    about the limit, diluted by the masked rows' exact zeros."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.tools import _bench

    valid = ms.bool()
    caught = dict(
        unrounded_share=_bench.bf16_off_share(ops.masked_attention_tiled_plain(
            qkv.float(), m, Hx, Dx ** -0.5, FILL, T).to(torch.bfloat16), ref),
        k3_form_sparse_share=_bench.bf16_off_share(ops.masked_attention_qkv_tpu_plain(
            qkv, ms, Hx, Dx ** -0.5, FILL)[valid], ref_s[valid]))
    for form, share in caught.items():
        if not share > SHARE_TOL:
            raise AssertionError(f"masked_attention_tiled share test too loose: the {form} "
                                 f"is off in only {share} of the elements")
    return caught


def _k6_extra_shapes(randn, gen: torch.Generator) -> dict:
    """K6 beyond the model's shapes, held as at them (_fwd_check: over all
    elements of a half-kept batch whose sequence 1 is masked but for its cls
    tokens, and over the valid rows of a sparse batch): B = 3 at N = 129,
    258 and 387 with D = 32 (H = 12), 96 (H = 8) and 128 (H = 6; chunked at
    N = 129 already, 80 keys a chunk); tiles of 16 (N = 256 and 512: up to 9
    cls keys a key chunk), 64 (N = 192 and 512) and 128 (N = 512 at D = 128,
    where k and v come a chunk at a time)."""
    from editor_tpu_torch import ops

    out = {}
    shapes = [(Nx, 129, Hx, Dx) for Nx in (129, 258, 387)
              for Hx, Dx in ((H, 32), (8, 96), (6, 128))]
    shapes += [(256, 16, H, D), (512, 16, H, D), (192, 64, H, D), (512, 64, H, D),
               (512, 128, 6, 128)]
    for Nx, T, Hx, Dx in shapes:
        qkv = randn(3, Nx, 3 * Hx * Dx)
        m = _tiled_mask(gen, 3, Nx, T, 0.5)
        m[1] = (torch.arange(Nx, device="cuda") % T == 0).float()
        ms = _tiled_mask(gen, 3, Nx, T, SPARSE_KEEP)
        case = f"masked_attention_tiled B=3 N={Nx} tile={T} H={Hx} D={Dx}"
        k6 = _fwd_check(case, ops.masked_attention_tiled(qkv, m, Hx, Dx ** -0.5, FILL, T),
                       ops.masked_attention_tiled_plain(qkv, m, Hx, Dx ** -0.5, FILL, T), m)
        k6s = _fwd_check(f"{case} sparse",
                        ops.masked_attention_tiled(qkv, ms, Hx, Dx ** -0.5, FILL, T),
                        ops.masked_attention_tiled_plain(qkv, ms, Hx, Dx ** -0.5, FILL, T), ms,
                        rows=True)
        out[f"N{Nx}_T{T}_H{Hx}_D{Dx}"] = dict(err=max(k6["err"], k6s["err"]),
                                             share=k6["share"], sparse_share=k6s["share"])
    return out


def tiled_kernels(randn, gen: torch.Generator, results: dict) -> None:
    """K6 and K7 at the uncompacted tail's shapes: per modality [384, 129]
    (one tile) and joint [128, 387] (three tiles), both on the flagship path,
    and the two-modality joint [128, 258] (two tiles), checked and timed on
    its own. K6 is held to its plain version by _fwd_check twice, over all
    elements of a half-kept batch and over the valid rows of a sparse one,
    a check that must fail the unrounded and K3's form (_k6_wrong_forms), at
    shapes beyond the model's too (_k6_extra_shapes), and its time on the two
    model shapes to at most 2x SDPA's with the key mask. K7 is held to the
    tolerances of tests/test_pallas_tpu.py:92-111 and to the share of its
    elements off the plain version (_bwd_shares), which must fail the wrong
    rounding forms (_wrong_forms), at shapes beyond the model's too
    (_k7_extra_shapes), and its time on the two model shapes to at most 3x
    the SDPA backward's."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.ops.masked_attention import k7_scratch_stride

    F = torch.nn.functional
    dev, T = "cuda", 129
    fwd, bwd = [], []
    k6_rows = dict(shares={}, sparse_shares={}, wrong_forms={})  # the kernels line's, by shape
    for Bm, N in ((3 * B_EVAL, T), (B_EVAL, 3 * T), (B_EVAL, 2 * T)):
        qkv = randn(Bm, N, 3 * C)
        m = _tiled_mask(gen, Bm, N, T, 0.5)
        m[0, 1:T] = 0.0  # a first tile with only its cls token
        got = ops.masked_attention_tiled(qkv, m, H, SCALE, FILL, T)
        ref = ops.masked_attention_tiled_plain(qkv, m, H, SCALE, FILL, T)
        k6 = _fwd_check(f"masked_attention_tiled N={N}", got, ref, m)
        e = k6["err"]
        # the second batch: every cls token and a tenth of the patches kept
        ms = _tiled_mask(gen, Bm, N, T, SPARSE_KEEP)
        ref_s = ops.masked_attention_tiled_plain(qkv, ms, H, SCALE, FILL, T)
        k6s = _fwd_check(f"masked_attention_tiled N={N} sparse",
                        ops.masked_attention_tiled(qkv, ms, H, SCALE, FILL, T), ref_s, ms,
                        rows=True)
        caught = _k6_wrong_forms(qkv, m, ref, ms, ref_s, H, D, T)
        del ref_s, ms
        qkv30 = randn(Bm, N, 3 * C, mul=30.0)
        k6_30 = _fwd_check(f"masked_attention_tiled N={N} x30",
                          ops.masked_attention_tiled(qkv30, m, H, SCALE, FILL, T),
                          ops.masked_attention_tiled_plain(qkv30, m, H, SCALE, FILL, T), m,
                          scaled=True)
        # the work this mask needs: valid query rows x valid keys
        pairs = float((m.sum(1) ** 2).sum())
        keys = m.bool()[:, None, None, :]
        row = dict(err=e, flops=4.0 * H * D * pairs,
                   bytes=2.0 * Bm * N * (3 * C + C) + 4.0 * Bm * N,
                   ms=cuda_ms(lambda: ops.masked_attention_tiled(qkv, m, H, SCALE, FILL, T)),
                   plain_ms=cuda_ms(lambda: ops.masked_attention_tiled_plain(
                       qkv, m, H, SCALE, FILL, T)),
                   library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                       *_heads(qkv), attn_mask=keys, scale=SCALE)))
        for key, value in zip(k6_rows, (k6["share"], k6s["share"], caught)):
            k6_rows[key][f"B{Bm}_N{N}"] = value
        say("2 kernel masked_attention_tiled", shape=list(qkv.shape), tiles=N // T, err=e,
            share=k6["share"], sparse_share=k6s["share"], share_tol=SHARE_TOL,
            wrong_forms=json.dumps(caught), x30_scaled_err=k6_30["err"],
            x30_share=k6_30["share"], ms=f"{row['ms']:.4f}", plain_ms=f"{row['plain_ms']:.4f}",
            sdpa_ms=f"{row['library_ms']:.4f}",
            bound_ms=f"{bound(row['flops'], row['bytes'])['bound_ms']:.4f}")
        if N != 2 * T:
            fwd.append(row)

        g = randn(Bm, N, C)
        dq = ops.masked_attention_tiled_bwd(qkv, m, g, H, SCALE, FILL, T)
        ref_dq = ops.masked_attention_tiled_bwd_plain(qkv, m, g, H, SCALE, FILL, T)
        dq30 = ops.masked_attention_tiled_bwd(qkv30, m, g, H, SCALE, FILL, T)
        ref_dq30 = ops.masked_attention_tiled_bwd_plain(qkv30, m, g, H, SCALE, FILL, T)
        torch.cuda.synchronize()
        e7, e7_30 = _scaled(dq, ref_dq), _scaled(dq30, ref_dq30)
        _require(f"masked_attention_tiled_bwd N={N} (scaled)", e7, 1e-2)
        if not torch.isfinite(dq30.float()).all():
            raise AssertionError("masked_attention_tiled_bwd: non-finite at |logit| ~ 1e3")
        _require(f"masked_attention_tiled_bwd N={N} x30 (scaled)", e7_30, 1e-2)
        if dq[..., :C][m == 0].abs().max() != 0 or dq[..., C:][m == 0].abs().max() != 0:
            raise AssertionError("masked_attention_tiled_bwd: masked rows get a gradient")
        # every cls key of every tile: dv of every head written, and dk too
        # but in sequence 0, whose only valid key is its cls token (softmax
        # over one key has no gradient)
        cls_kv = dq[:, ::T, C:].reshape(Bm, N // T, 2, H, D).abs().amax(-1)
        if not ((cls_kv[:, :, 1] > 0).all() and (cls_kv[1:, :, 0] > 0).all()):
            raise AssertionError("masked_attention_tiled_bwd: a cls key's dk or dv is zero")
        shares = _bwd_shares(f"masked_attention_tiled_bwd N={N}", dq, ref_dq, T, C)
        caught = _wrong_forms(
            "masked_attention_tiled_bwd",
            ops.masked_attention_tiled_bwd_plain(qkv.float(), m, g.float(), H, SCALE, FILL,
                                                 T).to(torch.bfloat16),
            ops.masked_attention_qkv_bwd_plain(qkv, m, g, H, SCALE, FILL), ref_dq, T, C)
        del qkv30, dq30, ref_dq30, ref_dq
        row = dict(err=e7, flops=10.0 * H * D * pairs,
                   bytes=2.0 * Bm * N * (3 * C + C + 3 * C) + 4.0 * Bm * N,
                   ms=cuda_ms(lambda: ops.masked_attention_tiled_bwd(qkv, m, g, H, SCALE,
                                                                     FILL, T)),
                   plain_ms=cuda_ms(lambda: ops.masked_attention_tiled_bwd_plain(
                       qkv, m, g, H, SCALE, FILL, T)),
                   library_ms=_sdpa_bwd_ms(qkv, g, m.bool()))
        say("2 kernel masked_attention_tiled_bwd", shape=list(qkv.shape), tiles=N // T,
            scaled_err=e7, x30_scaled_err=e7_30, share=shares["share"],
            cls_share=shares["cls_share"], share_tol=SHARE_TOL,
            wrong_forms=json.dumps(caught), ms=f"{row['ms']:.4f}",
            plain_ms=f"{row['plain_ms']:.4f}", sdpa_bwd_ms=f"{row['library_ms']:.4f}",
            bound_ms=f"{bound(row['flops'], row['bytes'])['bound_ms']:.4f}",
            scratch_gb=f"{2 * 2.0 * Bm * H * k7_scratch_stride(N) ** 2 / 1e9:.3f}")
        if N != 2 * T:
            bwd.append(row)
        del qkv, got, ref, g, dq
        torch.cuda.empty_cache()
    extra6 = _k6_extra_shapes(randn, gen)
    say("2 kernel masked_attention_tiled extra shapes", checks=json.dumps(extra6))
    extra = _k7_extra_shapes(randn, gen)
    say("2 kernel masked_attention_tiled_bwd extra shapes", checks=json.dumps(extra))
    _sum_rows(results, "masked_attention_tiled", fwd)
    k6_ms, sdpa_ms = sum(r["ms"] for r in fwd), sum(r["library_ms"] for r in fwd)
    if not k6_ms <= 2.0 * sdpa_ms:
        raise AssertionError(f"masked_attention_tiled: {k6_ms} ms on the model shapes, more "
                             f"than 2x SDPA's with the key mask, {sdpa_ms} ms")
    say("2 sum masked_attention_tiled vs sdpa", ms=f"{k6_ms:.4f}", sdpa_ms=f"{sdpa_ms:.4f}",
        factor=f"{k6_ms / sdpa_ms:.3f}", limit="2")
    results["masked_attention_tiled"].update(**k6_rows, extra_shapes=extra6)
    _sum_rows(results, "masked_attention_tiled_bwd", bwd)
    k7_ms, sdpa_ms = sum(r["ms"] for r in bwd), sum(r["library_ms"] for r in bwd)
    if not k7_ms <= 3.0 * sdpa_ms:
        raise AssertionError(f"masked_attention_tiled_bwd: {k7_ms} ms on the model shapes, "
                             f"more than 3x the SDPA backward's {sdpa_ms} ms")
    results["masked_attention_tiled_bwd"].update(extra_shapes=extra)
    say("2 sum masked_attention_tiled_bwd vs sdpa_bwd", ms=f"{k7_ms:.4f}",
        sdpa_bwd_ms=f"{sdpa_ms:.4f}", factor=f"{k7_ms / sdpa_ms:.3f}", limit="3")


def _k8_forms(x, w, b, gm, bt, act: str) -> dict:
    """K8's wrong forms, composed from the plain version: the LayerNorm's
    output left in fp32 (the plain version on fp32 x), the product rounded
    before the bias (``_xla_ln_matmul``'s form), the GELU of the rounded
    pre-activation."""
    from editor_tpu_torch import ops

    F = torch.nn.functional
    bf = torch.bfloat16
    wb = w.to(bf).float()
    forms = {"y_fp32": ops.ln_matmul_plain(x.float(), wb, b, gm, bt, 1e-6, act).to(bf)}
    rounded = ops.ln_matmul_plain(x, w, None, gm, bt, 1e-6, "").float() + b
    forms["product_rounded"] = (F.gelu(rounded) if act else rounded).to(bf)
    if act:
        forms["gelu_on_bf16"] = F.gelu(ops.ln_matmul_plain(x, w, b, gm, bt, 1e-6, "").float()
                                       ).to(bf)
    return forms


def _k8_check(name: str, got, ref, forms: dict, need: tuple) -> dict:
    """K8 against its plain version: finite, scaled error <= 1e-2, at most
    SHARE_TOL of the elements more than one bf16 ulp off; each wrong form in
    ``need`` must exceed that share in the same run (the others are
    printed)."""
    from editor_tpu_torch.tools import _bench

    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err = _scaled(got, ref)
    _require(f"{name} (scaled)", err, 1e-2)
    share = _bench.bf16_off_share(got, ref)
    _require(f"{name} share off the plain version", share, SHARE_TOL)
    caught = {form: _bench.bf16_off_share(f, ref) for form, f in forms.items()}
    for form in need:
        if not caught[form] > SHARE_TOL:
            raise AssertionError(f"{name} share test too loose: the {form} form is off in "
                                 f"only {caught[form]} of the elements")
    return dict(err=err, share=share, wrong_forms=caught)


def ln_matmul_kernel(randn, gen: torch.Generator, results: dict) -> None:
    """K8 on the backbone's shapes (T = 384 x 129 tokens, C = 768): norm1 ->
    qkv (O = 2304) and norm2 -> fc1 + GELU (O = 3072), against its plain
    version by _k8_check (the share test, with the y-in-fp32 form required
    to fail it); the product-rounded and GELU-on-bf16 forms are under the
    limit on these inputs (weights x 0.02: pre-activations of ~0.7 and
    biases of 0.02), so they are read on wide inputs (weights x 0.05, biases
    x 0.3, T = 8192), where the kernel must pass too; a ragged row count with
    no bias and the LayerNorm parameters as fp32 views at a 4-byte offset
    (the wrapper realigns them for the kernel's 16-byte loads), a C whose
    last k slice is 16 deep and a C of one k slice checked too. K8 is on no
    model path (as in the JAX package), so its launches on the main path are
    0. Library
    time: the three-call chain F.layer_norm -> F.linear -> F.gelu in bf16,
    what the backbone runs; K8's time over both shapes must be at most 2x the
    chain's."""
    from editor_tpu_torch import ops

    F = torch.nn.functional
    dev, Tk = "cuda", 3 * B_EVAL * 129

    def params(O, Cx=C, ws=0.02, bs=0.02):
        return (torch.randn(O, Cx, generator=gen, device=dev) * ws,
                torch.randn(O, generator=gen, device=dev) * bs,
                1.0 + 0.1 * torch.randn(Cx, generator=gen, device=dev),
                0.1 * torch.randn(Cx, generator=gen, device=dev))

    extra = {}
    for label, (T, Cx, O) in {"ragged rows, no bias, LN params at a 4-byte offset":
                              (1000, C, 256),
                              "C = 1040 (a last k slice of 16)": (1000, 1040, 272),
                              "C = 96 (one k slice)": (300, 96, 128)}.items():
        xr = randn(T, Cx, mul=2.0)
        w, b, gm, bt = params(O, Cx)
        if label.startswith("ragged"):  # fp32 views the wrapper must realign
            b, gm, bt = None, *(torch.cat([t.new_zeros(1), t])[1:] for t in (gm, bt))
        got = ops.ln_matmul(xr, w, b, gm, bt, act="gelu")
        ref = ops.ln_matmul_plain(xr, w, b, gm, bt, act="gelu")
        extra[label] = _k8_check(f"ln_matmul {label}", got, ref, {}, ())
    wide = {}
    xw = randn(8192, C, mul=2.0)
    for O, act in ((3 * C, ""), (4 * C, "gelu")):
        w, b, gm, bt = params(O, ws=0.05, bs=0.3)
        wide[f"O={O} {act or 'linear'}"] = _k8_check(
            f"ln_matmul wide O={O} {act or 'linear'}", ops.ln_matmul(xw, w, b, gm, bt, 1e-6, act),
            ops.ln_matmul_plain(xw, w, b, gm, bt, 1e-6, act), _k8_forms(xw, w, b, gm, bt, act),
            ("y_fp32", "product_rounded") + (("gelu_on_bf16",) if act else ()))
    del xw
    rows, checks = [], {}
    x = randn(Tk, C, mul=2.0)
    for O, act in ((3 * C, ""), (4 * C, "gelu")):
        w, b, gm, bt = params(O)
        key = f"O={O} {act or 'linear'}"
        checks[key] = _k8_check(f"ln_matmul {key}", ops.ln_matmul(x, w, b, gm, bt, 1e-6, act),
                                ops.ln_matmul_plain(x, w, b, gm, bt, 1e-6, act),
                                _k8_forms(x, w, b, gm, bt, act), ("y_fp32",))
        torch.cuda.empty_cache()
        wb, bb, gb, btb = (t.to(torch.bfloat16) for t in (w, b, gm, bt))

        def chain():
            y = F.linear(F.layer_norm(x, (C,), gb, btb, 1e-6), wb, bb)
            return F.gelu(y) if act else y
        row = dict(err=checks[key]["err"], flops=2.0 * Tk * C * O,
                   bytes=2.0 * Tk * C + 4.0 * O * C + 4.0 * O + 8.0 * C + 2.0 * Tk * O,
                   ms=cuda_ms(lambda: ops.ln_matmul(x, w, b, gm, bt, 1e-6, act)),
                   plain_ms=cuda_ms(lambda: ops.ln_matmul_plain(x, w, b, gm, bt, 1e-6, act)),
                   library_ms=cuda_ms(chain))
        b_ = bound(row["flops"], row["bytes"])
        say("2 kernel ln_matmul", shape=[Tk, C, O], act=act or "none",
            scaled_err=checks[key]["err"], share=checks[key]["share"], share_tol=SHARE_TOL,
            wrong_forms=json.dumps(checks[key]["wrong_forms"]), ms=f"{row['ms']:.4f}",
            plain_ms=f"{row['plain_ms']:.4f}", chain3_ms=f"{row['library_ms']:.4f}",
            bound_ms=f"{b_['bound_ms']:.4f}", bound_by=b_["bound_by"],
            tflops=f"{row['flops'] / row['ms'] / 1e9:.1f}",
            l2_weight_gb=f"{-(-Tk // 128) * O * C * 2 / 1e9:.3f}")
        rows.append(row)
        torch.cuda.empty_cache()
    say("2 kernel ln_matmul checks", wide=json.dumps(wide), extra_shapes=json.dumps(extra))
    _sum_rows(results, "ln_matmul", rows)
    res = results["ln_matmul"]
    res.update(checks=checks, wide=wide, extra_shapes=extra)
    if not res["ms"] <= 2.0 * res["library_ms"]:
        raise AssertionError(f"ln_matmul: {res['ms']} ms over both shapes, more than 2x the "
                             f"three-call chain's {res['library_ms']} ms")


def _t3_stages(name: str, ins, Hx: int, scale: float, out, g: int = 1) -> dict:
    """T3 read stage by stage (``bench_attn_layer.stage_shares`` on the
    kernel's own workspaces, from a second launch that must give ``out``
    again): qkv, att and out each at most SHARE_TOL of the elements more
    than one bf16 ulp off the TPU form of the stage's own input; att equal
    to K1's output on the same qkv; the y-in-fp32, qkv-in-fp32 and
    att-in-fp32 forms above the limit (the cls-rounded form is printed: on
    these inputs it sits at the limit; K1's and T1's checks hold that
    rounding of the same body)."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.tools import bench_attn_layer

    o, qkv, att = bench_attn_layer.attn_layer_stages(*ins, Hx, scale, 1e-6, g)
    if not torch.equal(o, out):
        raise AssertionError(f"{name}: a second launch gave another output")
    if not torch.equal(att, ops.attention_qkv(qkv, Hx, scale)[0]):
        raise AssertionError(f"{name}: the attention stage is not K1's output on its qkv")
    shares, wrong = bench_attn_layer.stage_shares(*ins, Hx, scale, 1e-6, qkv, att, o)
    for stage, share in shares.items():
        _require(f"{name} {stage} share off the plain stage", share, SHARE_TOL)
    for form in ("y_fp32", "qkv_fp32", "att_fp32"):
        if not wrong[form] > SHARE_TOL:
            raise AssertionError(f"{name} share test too loose: the {form} form is off in "
                                 f"only {wrong[form]} of the elements")
    return dict(shares=shares, wrong_forms=wrong)


def variant_phase(gen: torch.Generator) -> dict:
    """Phase 7: the design-variant kernels T1-T6 at the flagship shapes, one
    configuration each, against their plain versions with the phase 2
    limits (T4/T5's bf16 chain: one bf16 ulp of the output's largest
    magnitude, and at most 5% of the outputs more than 8 fp32 ulps off the
    plain bf16 chain; T6: bit-identical to K3 and K5, K3's and K5's checks),
    with kernel, plain and library-call times and the bound."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.tools import (_bench, bench_attn, bench_attn2, bench_attn_layer,
                                        bench_full_kernel, bench_rollout, bench_rollout2)

    F = torch.nn.functional
    dev, Bk, N = "cuda", 3 * B_EVAL, 129
    bf = torch.bfloat16
    results = {}

    def randn(*shape, mul=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * mul).to(bf)

    # T1 and T2 on K1's tensor-core body, held as K3 is: at most SHARE_TOL of
    # the elements more than one bf16 ulp off the plain version (_fwd_check,
    # every key kept), on random-normal inputs and on cls-heavy ones
    # (bench_attn.cls_heavy), a test that must fail the unrounded form (on
    # the first) and the cls-rounded form (on the second) in the same run;
    # T1's probs as K1's (each within one bf16 ulp, rows summing to 1)
    qkv = randn(Bk, N, 3 * C)
    qkv_cls = bench_attn.cls_heavy(torch.randn(Bk, N, 3 * C, generator=gen, device=dev),
                                   H).to(bf)
    every = torch.ones(Bk, N, device=dev)
    flops = 4.0 * Bk * H * N * N * D
    b = bound(flops, 2.0 * (Bk * N * 3 * C + Bk * N * C + Bk * H * N * N))
    b_np = bound(flops, 2.0 * (Bk * N * 3 * C + Bk * N * C))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*_heads(qkv), scale=SCALE))

    # T1 on separate q, k, v and on the column views of the packed qkv, at
    # 1 and 2 heads and 1 and 2 sequences a block, with probs
    probs = torch.empty(Bk, H, N, N, dtype=bf, device=dev)
    views = qkv.split(C, -1)
    q, k, v = (t.contiguous() for t in views)
    ref, ref_probs = bench_attn.headgrid_attn_plain(q, k, v, H, SCALE, True)
    configs = {}
    for layout, qkv3 in (("separate", (q, k, v)), ("views", views)):
        for hps, g in ((2, 1), (1, 1), (1, 2), (2, 2)):
            case = f"headgrid_attn {layout} hps={hps} g={g}"
            out, _ = bench_attn.headgrid_attn(*qkv3, H, SCALE, g, hps, probs)
            configs[f"{layout} hps={hps} g={g}"] = dict(
                **_fwd_check(case, out, ref, every), **_probs_errors(case, probs, ref_probs))
    out_np, _ = bench_attn.headgrid_attn(q, k, v, H, SCALE, 1, 2)
    t1 = _fwd_check("headgrid_attn without probs", out_np, ref, every)
    k1_out, _ = ops.attention_qkv(qkv, H, SCALE)
    torch.cuda.synchronize()
    vs_k1 = _bench.bf16_off_share(out_np, k1_out)
    del ref_probs, k1_out
    unrounded = bench_attn.headgrid_attn_plain(q.float(), k.float(), v.float(), H, SCALE,
                                               False).to(bf)
    q_c, k_c, v_c = (t.contiguous() for t in qkv_cls.split(C, -1))
    ref_c = bench_attn.headgrid_attn_plain(q_c, k_c, v_c, H, SCALE, False)
    t1_cls = _fwd_check("headgrid_attn cls-heavy", bench_attn.headgrid_attn(
        q_c, k_c, v_c, H, SCALE, 1, 2)[0], ref_c, every)
    caught = _t12_wrong_forms("headgrid_attn", unrounded, ref,
                              ops.attention_qkv_plain(qkv_cls, H, SCALE, False), ref_c)
    del unrounded, q_c, k_c, v_c, ref_c
    # x30 (|logit| ~ 1e3) and B = 3 past one key chunk (N = 200: the chunked
    # instance), as K1's
    q30, k30, v30 = (randn(Bk, N, C, mul=30.0) for _ in range(3))
    out30, _ = bench_attn.headgrid_attn(q30, k30, v30, H, SCALE, 1, 2, probs)
    torch.cuda.synchronize()
    if not torch.isfinite(out30.float()).all():
        raise AssertionError("headgrid_attn: non-finite output at |logit| ~ 1e3")
    t1_30 = _k1_errors("headgrid_attn x30", out30, probs, bench_attn.headgrid_attn_plain(
        q30, k30, v30, H, SCALE, True), scaled=True)
    del q30, k30, v30, out30
    qx, kx, vx = (randn(3, 200, C) for _ in range(3))
    px = torch.empty(3, H, 200, 200, dtype=bf, device=dev)
    ox, _ = bench_attn.headgrid_attn(qx, kx, vx, H, SCALE, 2, 2, px)
    ref_x = bench_attn.headgrid_attn_plain(qx, kx, vx, H, SCALE, True)
    t1_x = dict(**_fwd_check("headgrid_attn B=3 N=200", ox, ref_x[0], torch.ones(3, 200,
                                                                                 device=dev)),
                **_probs_errors("headgrid_attn B=3 N=200", px, ref_x[1]))
    del qx, kx, vx, px, ox, ref_x
    row = dict(max_abs_err=max(max(c["err"], c["probs_err"]) for c in configs.values()),
               ms=cuda_ms(lambda: bench_attn.headgrid_attn(q, k, v, H, SCALE, 1, 2, probs)),
               plain_ms=cuda_ms(lambda: bench_attn.headgrid_attn_plain(q, k, v, H, SCALE, True)),
               library_ms=sdpa_ms,
               ms_no_probs=cuda_ms(lambda: bench_attn.headgrid_attn(q, k, v, H, SCALE, 1, 2)),
               bound_ms_no_probs=b_np["bound_ms"], config="hps=2 g=1, separate q, k, v",
               share=configs["separate hps=2 g=1"]["share"],
               probs_ulps=max(c["probs_ulps"] for c in configs.values()),
               row_sum_err=max(c["row_sum_err"] for c in configs.values()),
               cls_heavy_share=t1_cls["share"], wrong_forms=caught, share_off_k1=vs_k1,
               configs=configs, x30=t1_30, chunked_N200=t1_x, **b)
    _at_most_2x_sdpa("headgrid_attn", row["ms"], sdpa_ms)
    results["headgrid_attn"] = row
    say("7 variant headgrid_attn (T1)", shape=list(q.shape), config=repr(row["config"]),
        share=row["share"], share_tol=SHARE_TOL, no_probs_share=t1["share"],
        cls_heavy_share=t1_cls["share"], wrong_forms=json.dumps(caught),
        probs_ulps=row["probs_ulps"], row_sum_err=row["row_sum_err"], share_off_k1=vs_k1,
        configs=json.dumps(configs), x30=json.dumps(t1_30), chunked_N200=json.dumps(t1_x),
        ms=f"{row['ms']:.4f}", ms_no_probs=f"{row['ms_no_probs']:.4f}",
        plain_ms=f"{row['plain_ms']:.4f}", sdpa_ms=f"{sdpa_ms:.4f}",
        bound_ms=f"{b['bound_ms']:.4f}", bound_ms_no_probs=f"{b_np['bound_ms']:.4f}")
    del q, k, v, views, out, out_np, ref

    # T2 on the packed qkv at 1 and 2 sequences a block. Without the row max
    # |logit| must stay < ~80: no x30 stress
    ref = bench_attn2.nomax_attn_plain(qkv, H, SCALE)
    t2 = {f"g={g}": _fwd_check(f"nomax_attn g={g}", bench_attn2.nomax_attn(qkv, H, SCALE, g),
                               ref, every) for g in (1, 2)}
    ref_c = bench_attn2.nomax_attn_plain(qkv_cls, H, SCALE)
    t2_cls = _fwd_check("nomax_attn cls-heavy", bench_attn2.nomax_attn(qkv_cls, H, SCALE, 1),
                        ref_c, every)
    caught = _t12_wrong_forms(
        "nomax_attn", bench_attn2.nomax_attn_plain(qkv.float(), H, SCALE).to(bf), ref,
        ops.attention_qkv_plain(qkv_cls, H, SCALE, False), ref_c)
    del ref_c, qkv_cls
    qx = randn(3, 512, 3 * C)  # B = 3 past one key chunk: the chunked instance
    t2_x = _fwd_check("nomax_attn B=3 N=512", bench_attn2.nomax_attn(qx, H, SCALE, 2),
                      bench_attn2.nomax_attn_plain(qx, H, SCALE), torch.ones(3, 512, device=dev))
    del qx
    row = dict(max_abs_err=max(c["err"] for c in t2.values()),
               ms=cuda_ms(lambda: bench_attn2.nomax_attn(qkv, H, SCALE, 1)),
               plain_ms=cuda_ms(lambda: bench_attn2.nomax_attn_plain(qkv, H, SCALE)),
               library_ms=sdpa_ms, config="g=1", share=t2["g=1"]["share"],
               cls_heavy_share=t2_cls["share"], wrong_forms=caught, configs=t2,
               chunked_N512=t2_x, **b_np)
    _at_most_2x_sdpa("nomax_attn", row["ms"], sdpa_ms)
    results["nomax_attn"] = row
    say("7 variant nomax_attn (T2)", shape=list(qkv.shape), config="'g=1'",
        share=row["share"], share_tol=SHARE_TOL, cls_heavy_share=t2_cls["share"],
        wrong_forms=json.dumps(caught), configs=json.dumps(t2), chunked_N512=json.dumps(t2_x),
        ms=f"{row['ms']:.4f}", plain_ms=f"{row['plain_ms']:.4f}", sdpa_ms=f"{sdpa_ms:.4f}",
        bound_ms=f"{b_np['bound_ms']:.4f}")
    del qkv, ref, every

    # T3: the half-layer at the JAX tool's groups, with and without probs.
    # End to end its output is chaotic in the qkv product's summation order
    # (bench_attn_layer.stage_shares), so the share test reads each stage
    # against the TPU form of the kernel's own input to it, with the wrong
    # forms required to fail at the stage where each acts; the attention
    # stage must be K1's output on the kernel's qkv bit for bit
    ins = bench_attn_layer.layer_inputs(gen)
    out, _ = bench_attn_layer.attn_layer(*ins, H, SCALE, 1e-6, 1, probs)
    ref, ref_probs = bench_attn_layer.attn_layer_plain(*ins, H, SCALE, 1e-6, True)
    torch.cuda.synchronize()
    e_out = _scaled(out, ref)
    _require("attn_layer out (scaled)", e_out, 1e-2)
    t3 = _probs_errors("attn_layer", probs, ref_probs, own_qkv=True)
    e_probs = t3["probs_err"]
    end_share = _bench.bf16_off_share(out, ref)
    del ref, ref_probs
    for g in (2, 4):  # the JAX tool's groups: each row computed as at g = 1
        if not torch.equal(bench_attn_layer.attn_layer(*ins, H, SCALE, 1e-6, g)[0], out):
            raise AssertionError(f"attn_layer g={g}: output differs from g=1's")
    t3_stages = _t3_stages("attn_layer", ins, H, SCALE, out)
    extra = {}
    for Bx, Nx, Cx, Hx, g in ((3, 200, C, H, 2), (5, 17, 256, 8, 2)):
        xi = bench_attn_layer.layer_inputs(gen, Bx, Nx, Cx)
        case = f"attn_layer B={Bx} N={Nx} C={Cx} H={Hx} g={g}"
        o, _ = bench_attn_layer.attn_layer(*xi, Hx, (Cx // Hx) ** -0.5, 1e-6, g)
        e = _scaled(o, bench_attn_layer.attn_layer_plain(*xi, Hx, (Cx // Hx) ** -0.5, 1e-6,
                                                         False))
        _require(f"{case} (scaled)", e, 1e-2)
        extra[case] = dict(err=e, **_t3_stages(case, xi, Hx, (Cx // Hx) ** -0.5, o, g))
    b = dict(zip(("bound_ms", "bound_by"), bench_attn_layer.layer_bound(with_probs=True)))
    b_np = bench_attn_layer.layer_bound()[0]
    sdpa = lambda t: bench_attn_layer.sdpa_from_qkv(t, H, SCALE)
    row = dict(max_abs_err=max(e_out, e_probs),
               ms=cuda_ms(lambda: bench_attn_layer.attn_layer(*ins, H, SCALE, 1e-6, 1, probs)),
               plain_ms=cuda_ms(lambda: bench_attn_layer.attn_layer_plain(*ins, H, SCALE, 1e-6,
                                                                          True)),
               library_ms=cuda_ms(lambda: bench_attn_layer.composed(*ins, H, SCALE,
                                                                    attention=sdpa)),
               composed_k1_ms=cuda_ms(lambda: bench_attn_layer.composed(*ins, H, SCALE,
                                                                        probs_out=probs)),
               ms_no_probs=cuda_ms(lambda: bench_attn_layer.attn_layer(*ins, H, SCALE, 1e-6, 1)),
               bound_ms_no_probs=b_np, config="g=1", probs_ulps=t3["probs_ulps"],
               probs_share=t3["probs_share"], row_sum_err=t3["row_sum_err"],
               end_to_end_share=end_share, stages=t3_stages, extra_shapes=extra, **b)
    flops = bench_attn_layer.layer_flops()
    results["attn_layer"] = row
    say("7 variant attn_layer (T3)", shape=list(ins[0].shape), config="'g=1'",
        scaled_err=e_out, end_to_end_share=end_share, stages=json.dumps(t3_stages),
        probs_err=e_probs, probs_ulps=t3["probs_ulps"], probs_share=t3["probs_share"],
        share_tol=SHARE_TOL, row_sum_err=t3["row_sum_err"], equal_at_g="2 4",
        extra_shapes=json.dumps(extra), ms=f"{row['ms']:.4f}",
        ms_no_probs=f"{row['ms_no_probs']:.4f}", plain_ms=f"{row['plain_ms']:.4f}",
        chain4_sdpa_ms=f"{row['library_ms']:.4f}",
        composed_k1_ms=f"{row['composed_k1_ms']:.4f}", bound_ms=f"{b['bound_ms']:.4f}",
        bound_ms_no_probs=f"{b_np:.4f}", bound_by=b["bound_by"],
        tflops=f"{flops / row['ms_no_probs'] / 1e9:.1f}",
        l2_weight_gb=f"{bench_attn_layer.weight_bytes(Bk, N, C, 1) / 1e9:.3f}")
    if not row["ms_no_probs"] <= 2.0 * row["library_ms"]:
        raise AssertionError(f"attn_layer: {row['ms_no_probs']} ms without probs, more than 2x "
                             f"the four-call chain's {row['library_ms']} ms")
    del ins, out, probs
    torch.cuda.empty_cache()

    # T4 and T5 on phase 2's peaked maps (L = 12, Z = 4608, N = 129). The bf16
    # chain rounds v[n >= 1] to bf16 before each patch product on both sides;
    # a different fp32 summation order moves a v[n] across a rounding boundary
    # now and then, which changes an output by at most one bf16 step of that
    # v[n] times weights that sum to 1: the max limit is one bf16 ulp of the
    # output's largest magnitude. That limit is wider than the whole gap
    # between the bf16 and the fp32 chain, so the rounding points are held by
    # the share of outputs more than 8 fp32 ulps off the plain bf16 chain: at
    # most 5% for the kernels (another summation order leaves well under 1%
    # off), at least 50% for the plain fp32 chain (the check tells the two
    # chains apart). `rows` is fp32 math in another order: K2's limit, 1e-5.
    L = 12
    maps = torch.empty(L, Bk, H, N, N, dtype=bf, device=dev)
    for l in range(L):
        maps[l] = torch.softmax(4.0 * torch.randn(Bk, H, N, N, generator=gen, device=dev),
                                dim=-1).to(bf)
    b = bound(2.0 * (L - 1) * Bk * H * N * N, 2.0 * L * Bk * H * N * N + 4.0 * Bk * H * (N - 1))
    ref_bf = bench_rollout.chain_plain(maps, "bf16")
    ref_f32 = bench_rollout.chain_plain(maps, "f32")
    tol_bf, share_tol = _bench.ulp_of_max(ref_bf), 0.05
    f32_share = _bench.mismatch_share(ref_f32, ref_bf)
    if not f32_share >= 0.5:
        raise AssertionError(f"plain fp32 vs bf16 chain: only {f32_share} of the outputs differ")

    def rounding_check(name, got):
        e, share = _max_err(got, ref_bf), _bench.mismatch_share(got, ref_bf)
        _require(f"{name} max", e, tol_bf)
        _require(f"{name} share off the plain bf16 chain", share, share_tol)
        return e, share

    got_bf = bench_rollout.chain(maps, "bf16", 1)
    got_rows = bench_rollout.chain(maps, "rows", 1)
    torch.cuda.synchronize()
    e_bf, share_bf = rounding_check("chain bf16", got_bf)
    e_rows = _max_err(got_rows, ref_f32)
    _require("chain rows", e_rows, 1e-5)
    row = dict(max_abs_err=e_bf, ms=cuda_ms(lambda: bench_rollout.chain(maps, "bf16", 1)),
               plain_ms=cuda_ms(lambda: bench_rollout.chain_plain(maps, "bf16")),
               library_ms=None, tol=tol_bf, mismatch_share=share_bf,
               f32_mismatch_share=f32_share, rows_err=e_rows,
               rows_ms=cuda_ms(lambda: bench_rollout.chain(maps, "rows", 1)),
               config="bf16 g=1; rows g=1", **b)
    results["chain"] = row
    say("7 variant chain (T4)", L=L, Z=Bk * H, N=N, bf16_err=e_bf, tol=tol_bf,
        mismatch_share=share_bf, share_tol=share_tol, f32_chain_mismatch_share=f32_share,
        bf16_vs_f32_err=_max_err(got_bf, ref_f32), rows_err=e_rows, rows_tol=1e-5,
        ms=f"{row['ms']:.4f}", rows_ms=f"{row['rows_ms']:.4f}",
        plain_ms=f"{row['plain_ms']:.4f}", bound_ms=f"{b['bound_ms']:.4f}")
    got = bench_rollout2.chain_multi(maps, 4, 1)
    torch.cuda.synchronize()
    e, share = rounding_check("chain_multi", got)
    row = dict(max_abs_err=e, ms=cuda_ms(lambda: bench_rollout2.chain_multi(maps, 4, 1)),
               plain_ms=cuda_ms(lambda: bench_rollout2.chain_multi_plain(maps)),
               library_ms=None, tol=tol_bf, mismatch_share=share, config="T=4 g=1", **b)
    results["chain_multi"] = row
    say("7 variant chain_multi (T5)", L=L, Z=Bk * H, N=N, config="'T=4 g=1'", err=e, tol=tol_bf,
        mismatch_share=share, share_tol=share_tol,
        equal_to_chain_bf16=bool(torch.equal(got, got_bf)), ms=f"{row['ms']:.4f}",
        plain_ms=f"{row['plain_ms']:.4f}", bound_ms=f"{b['bound_ms']:.4f}")
    del maps, ref_bf, ref_f32, got_bf, got_rows, got
    torch.cuda.empty_cache()

    # T6: K3 and K5 walking g sequences a block at the JAX package's groups
    # (bench_full_kernel.full_group: forward 8, backward 4 at [384, 88];
    # both 2 at [128, 264]), masks as phase 2's; one forward and one backward
    # of each shape. The counts sit at the launch: the walking pair counts as
    # T6 alone, the group-0 pair (K3 and K5) as K3 and K5 alone. Each pair is
    # computed as K3's and K5's blocks compute it, so T6 must equal them bit
    # for bit; and it is held by K3's and K5's share tests and wrong forms
    calls = []
    for Bm, Nm in ((3 * B_EVAL, 88), (B_EVAL, 264)):
        qkv = randn(Bm, Nm, 3 * C)
        m = torch.rand(Bm, Nm, generator=gen, device=dev) < 0.5
        m = (m | (torch.arange(Nm, device=dev) % 88 == 0)[None, :]).float()
        m[0, 1:] = 0.0  # one sequence with only its cls token
        g = randn(Bm, Nm, C)
        gf, gb = bench_full_kernel.full_group(Nm, Bm), bench_full_kernel.full_group(Nm, Bm, True)
        reset_counts()
        fwd = bench_full_kernel.masked_full(qkv, m, H, SCALE, gf)
        bwd = bench_full_kernel.masked_full_bwd(qkv, m, g, H, SCALE, gb)
        counts = [launch_counts()]
        fwd0 = ops.masked_attention_qkv(qkv, m, H, SCALE, FILL)
        bwd0 = ops.masked_attention_qkv_bwd(qkv, m, g, H, SCALE, FILL)
        counts.append(launch_counts())
        torch.cuda.synchronize()
        seen = [(c["masked_full"], c["masked_attention_qkv"], c["masked_attention_qkv_bwd"])
                for c in counts]
        if seen != [(2, 0, 0), (2, 1, 1)]:
            raise AssertionError(f"(T6, K3, K5) launches after the walking pair and then the "
                                 f"group-0 pair: {seen} != [(2, 0, 0), (2, 1, 1)]")
        if not (torch.equal(fwd, fwd0) and torch.equal(bwd, bwd0)):
            raise AssertionError(f"masked_full N={Nm}: g = {gf} (forward), {gb} (backward) "
                                 "not bit-identical to K3 and K5 at group 0")
        del fwd0, bwd0
        # the forward against the TPU body's form (masked_full_plain), by K3's
        # share test, which must fail the unrounded and the XLA form
        ref_f = bench_full_kernel.masked_full_plain(qkv, m, H, SCALE)
        t6 = _fwd_check(f"masked_full N={Nm}", fwd, ref_f, m)
        caught_f = _k3_wrong_forms(qkv, m, ref_f, H, D)
        e_f = t6["err"]
        del ref_f
        # the backward by K5's check and wrong forms (unrounded; cls-kept)
        ref_b = bench_full_kernel.masked_full_bwd_plain(qkv, m, g, H, SCALE)
        k5 = _k5_check(f"masked_full_bwd N={Nm}", bwd, ref_b, m, C)
        caught_b = _wrong_forms(
            "masked_full_bwd",
            ops.masked_attention_qkv_bwd_plain(qkv.float(), m, g.float(), H, SCALE,
                                               FILL).to(torch.bfloat16),
            ops.masked_attention_tiled_bwd_plain(qkv, m, g, H, SCALE, FILL, K5_CLS_ROWS),
            ref_b, K5_CLS_ROWS, C, "cls_kept")
        e_b = k5["scaled_err"]
        del ref_b
        pairs = float((m.sum(1) ** 2).sum())
        keys = m.bool()[:, None, None, :]
        c = dict(err=max(e_f, e_b), flops=14.0 * H * D * pairs,
                 bytes=2.0 * Bm * Nm * (4 * C + 7 * C) + 8.0 * Bm * Nm,
                 ms=cuda_ms(lambda: bench_full_kernel.masked_full(qkv, m, H, SCALE, gf))
                 + cuda_ms(lambda: bench_full_kernel.masked_full_bwd(qkv, m, g, H, SCALE, gb)),
                 plain_ms=cuda_ms(lambda: bench_full_kernel.masked_full_plain(qkv, m, H, SCALE))
                 + cuda_ms(lambda: bench_full_kernel.masked_full_bwd_plain(qkv, m, g, H, SCALE)),
                 library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                     *_heads(qkv), attn_mask=keys, scale=SCALE)) + _sdpa_bwd_ms(qkv, g, m.bool()))
        c.update(fwd_share=t6["share"], fwd_wrong_forms=caught_f, bwd_share=k5["share"],
                 bwd_cls_share=k5["cls_share"], bwd_wrong_forms=caught_b)
        calls.append(c)
        say("7 variant masked_full (T6)", shape=list(qkv.shape), g_fwd=gf, g_bwd=gb,
            equal_to_group0=True, fwd_err=e_f, fwd_share=t6["share"], share_tol=SHARE_TOL,
            fwd_wrong_forms=json.dumps(caught_f), bwd_scaled_err=e_b, bwd_share=k5["share"],
            bwd_cls_share=k5["cls_share"], bwd_wrong_forms=json.dumps(caught_b),
            ms=f"{c['ms']:.4f}", plain_ms=f"{c['plain_ms']:.4f}",
            sdpa_fwd_bwd_ms=f"{c['library_ms']:.4f}",
            bound_ms=f"{bound(c['flops'], c['bytes'])['bound_ms']:.4f}")
        del qkv, g, fwd, bwd
    _sum_rows(results, "masked_full", calls, phase="7")
    t6_ms, sdpa_ms = results["masked_full"]["ms"], results["masked_full"]["library_ms"]
    if not t6_ms <= 2.0 * sdpa_ms:
        raise AssertionError(f"masked_full: {t6_ms} ms forward + backward on the two shapes, "
                             f"more than 2x SDPA's forward + backward with the key mask, "
                             f"{sdpa_ms} ms")
    say("7 sum masked_full vs sdpa fwd + bwd", ms=f"{t6_ms:.4f}", sdpa_ms=f"{sdpa_ms:.4f}",
        factor=f"{t6_ms / sdpa_ms:.3f}", limit="2")
    results["masked_full"].update(
        config="JAX `_full_group` groups, forward + backward", equal_to_group0=True,
        **{k: [c[k] for c in calls]
           for k in ("fwd_share", "fwd_wrong_forms", "bwd_share", "bwd_cls_share",
                     "bwd_wrong_forms")})
    return results


def _eval_batch(gen: torch.Generator, B: int) -> dict:
    images = {m: torch.randn(B, 256, 128, 3, generator=gen, device="cuda")
              for m in ("RGB", "NI", "TI")}
    images["camid"] = torch.arange(B, device="cuda") % 6
    return images


def flagship(opts=()):
    """(Config, EditorConfig): the RGBNT201 preset with ``opts`` on top,
    through editor_config_from, so one source sets the solver and the model."""
    from editor_tpu_torch.tools.profile_forward import flagship_from_opts

    return flagship_from_opts(opts)


def launch_counts() -> dict:
    """Launches of each kernel row since the last reset_counts(), counted
    where the kernel launches: K1-K8 by their wrappers (K3, K5 and K6 at the
    model paths' group 0), T1-T5 by the wrapper of the same name in their tool
    module, T6 (masked_full) by K3's and K5's launches at groups g >= 1, and
    K6's own at g >= 1 (the group sweep of bench_attn2) apart."""
    import importlib

    from editor_tpu_torch import ops

    counts = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    for name, spec in VARIANTS.items():
        if name != "masked_full":
            mod = importlib.import_module(f"editor_tpu_torch.tools.{spec['tool']}")
            counts[name] = getattr(mod, name).launches
    counts["masked_full"] = (ops.masked_attention_qkv.variant_launches
                             + ops.masked_attention_qkv_bwd.variant_launches)
    counts["masked_attention_tiled (group >= 1)"] = ops.masked_attention_tiled.variant_launches
    return counts


def reset_counts() -> None:
    """Every kernel's launch count to 0, the T-kernels' too."""
    import importlib

    from editor_tpu_torch import ops

    ops.reset_launch_counts()
    for name, spec in VARIANTS.items():
        if name != "masked_full":
            getattr(importlib.import_module(f"editor_tpu_torch.tools.{spec['tool']}"),
                    name).launches = 0


def expected(**counts) -> dict:
    """Launch counts of one call: every kernel 0 unless named."""
    return {name: counts.get(name, 0) for name in launch_counts()}


def _feature_agreement(got, ref):
    """(min per-row cosine, max per-row rel-L2) of two feature batches."""
    got, ref = got.double(), ref.double()
    cos = (torch.nn.functional.normalize(got, dim=1)
           * torch.nn.functional.normalize(ref, dim=1)).sum(1)
    rel = (got - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-12)
    return float(cos.min()), float(rel.max())


def eval_check(ecfg, gen: torch.Generator, label: str, want: dict):
    """The eval forward of ``ecfg`` (seeded weights, B=128, bf16) through
    build_eval_step: the launch counts of one forward, the features against
    the same model run with the plain ops in fp32 (per-row cosine >= 0.99,
    rel-L2 <= 0.08), and the forward's time from CUDA events."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.models.editor import Editor
    from editor_tpu_torch.models.init import editor_init

    t0 = time.perf_counter()
    model = editor_init(ecfg, seed=0)
    init_s = time.perf_counter() - t0
    ref_model = Editor(dataclasses.replace(ecfg, use_pallas=False))
    ref_model.load_state_dict(model.state_dict(), strict=True)
    batch = _eval_batch(gen, B_EVAL)
    step = build_eval_step(model, torch.bfloat16)

    step(batch)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    reset_counts()
    feats = step(batch)
    torch.cuda.synchronize()
    launches = launch_counts()
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want} in one forward")
    if feats.shape != (B_EVAL, 3 * C) or feats.dtype != torch.float32:
        raise AssertionError(f"features {tuple(feats.shape)} {feats.dtype}")
    if not torch.isfinite(feats).all():
        raise AssertionError("non-finite features")
    ref = build_eval_step(ref_model, torch.float32)(batch)
    torch.cuda.synchronize()
    min_cos, max_rel = _feature_agreement(feats, ref)
    if not (min_cos >= 0.99 and max_rel <= 0.08):
        raise AssertionError(f"bf16 kernels vs fp32 plain: min cos {min_cos}, "
                             f"max rel-L2 {max_rel}")
    fwd_ms = cuda_ms(lambda: step(batch), iters=5)
    say(label, B=B_EVAL, compact_tail=ecfg.compact_tail, shape=list(feats.shape),
        launches=json.dumps(launches), min_cos=f"{min_cos:.6f}", max_rel_l2=f"{max_rel:.6f}",
        fwd_ms=f"{fwd_ms:.2f}", img_s=f"{B_EVAL / fwd_ms * 1e3:.1f}", init_s=f"{init_s:.2f}")
    return model, ref_model, batch, ref, launches


def forward_phase(gen: torch.Generator):
    """Phase 3: the flagship eval forward (compact tail) through K1-K3."""
    _, ecfg = flagship()
    model, _, _, _, launches = eval_check(
        ecfg, gen, "3 forward",
        expected(attention_qkv=ecfg.vit.depth, rollout_chain=1, masked_attention_qkv=2))
    return model, launches


def serving_phase(model, gen: torch.Generator, card: str) -> None:
    from editor_tpu_torch.serve import FeatureExtractor, GalleryIndex

    n_ids = 64
    rng = np.random.RandomState(0)
    gallery = {m: rng.randint(0, 256, (n_ids, 256, 128, 3), dtype=np.uint8)
               for m in ("RGB", "NI", "TI")}
    cams = (np.arange(n_ids) % 6).astype(np.int32)
    cfg, _ = flagship()
    ex = FeatureExtractor(model, batch_size=32, compute_dtype=torch.bfloat16,
                          input_cfg=cfg.INPUT)
    if ex.size_hw != tuple(cfg.INPUT.SIZE_TEST):
        raise AssertionError(f"FeatureExtractor size_hw {ex.size_hw} != SIZE_TEST")
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


def _param_norm(model) -> float:
    return float(torch.stack([p.detach().float().norm() for p in model.parameters()]).norm())


def _grads_finite(model) -> bool:
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    return bool(torch.isfinite(torch.stack(torch._foreach_norm(grads))).all())


def train_check(cfg, ecfg, gen: torch.Generator, label: str, want: dict,
                learn: bool) -> dict:
    """The train step of ``ecfg`` with the solver of ``cfg`` (B=128 as 8 ids x
    16, uint8 images through the augmentation, bf16) through
    build_train_step: the launch counts of each of 3 steps; losses within 3%
    and the parameter norm within 2% of the same model run with the plain
    ops in fp32 (same weights, batch and random draws); finite losses and
    gradients; BN stats and OCFR centers move; step time, img/s and peak
    memory; with ``learn``, 20 steps on one fixed batch lower the loss."""
    from editor_tpu_torch.data.transforms import make_eval_transform, make_train_augment
    from editor_tpu_torch.engine.train import build_train_step
    from editor_tpu_torch import ops
    from editor_tpu_torch.losses import make_loss
    from editor_tpu_torch.models.editor import Editor
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.solver import make_optimizer, make_scheduler

    B, K = cfg.SOLVER.IMS_PER_BATCH, cfg.DATALOADER.NUM_INSTANCE
    model = editor_init(ecfg, seed=0)
    ref_model = Editor(dataclasses.replace(ecfg, use_pallas=False))
    ref_model.load_state_dict(model.state_dict(), strict=True)

    def make_step(m, dtype, augment=True):
        return build_train_step(m, make_optimizer(cfg, m), make_loss(cfg, ecfg.num_classes),
                                make_scheduler(cfg), cfg.SOLVER.BASE_LR, dtype,
                                augment=make_train_augment(cfg.INPUT) if augment else None,
                                seed=1)

    h, w = ecfg.vit.img_size
    batch = {m: torch.randint(0, 256, (B, h, w, 3), generator=gen, device="cuda",
                              dtype=torch.uint8) for m in ("RGB", "NI", "TI")}
    batch["pid"] = torch.arange(B, device="cuda") // K  # 8 ids x 16 instances
    batch["camid"] = torch.arange(B, device="cuda") % 6
    states = lambda m: {n: b.clone() for n, b in m.named_buffers()
                        if "running" in n or "centers" in n}

    step = make_step(model, torch.bfloat16)
    before = states(model)
    start = [p.detach().clone() for p in model.parameters()]
    losses = []
    for epoch in (1, 2, 3):
        reset_counts()
        loss = float(step(batch, epoch)["loss"])
        launches = launch_counts()
        if launches != want:
            raise AssertionError(f"kernel launches {launches} != {want} in one train step")
        if not (np.isfinite(loss) and _grads_finite(model)):
            raise AssertionError(f"non-finite loss {loss} or gradients at step {epoch}")
        losses.append(loss)
    still = [n for n, b in states(model).items() if torch.equal(b, before[n])]
    if still:
        raise AssertionError(f"train state did not move: {still}")
    norm = _param_norm(model)

    # the same weights, batch and random draws through the plain ops in fp32
    ref_step = make_step(ref_model, torch.float32)
    ref_losses = [float(ref_step(batch, epoch)["loss"]) for epoch in (1, 2, 3)]
    ref_norm = _param_norm(ref_model)
    # the three steps' change of every parameter, bf16 kernels vs fp32 plain
    upd = torch.cat([(p.detach() - p0).flatten() for p, p0 in zip(model.parameters(), start)])
    ref_upd = torch.cat([(p.detach() - p0).flatten()
                         for p, p0 in zip(ref_model.parameters(), start)])
    upd_cos = float(torch.nn.functional.cosine_similarity(upd, ref_upd, dim=0))
    upd_rel = float((upd - ref_upd).norm() / ref_upd.norm())
    del ref_step, ref_model, start, upd, ref_upd
    torch.cuda.empty_cache()
    dloss = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    dnorm = abs(norm - ref_norm) / ref_norm
    if not (max(dloss) <= 0.03 and dnorm <= 0.02):
        raise AssertionError(f"bf16 kernels vs fp32 plain: losses {losses} vs {ref_losses}, "
                             f"param norm {norm} vs {ref_norm}")
    say(label, B=B, ids=B // K, compact_tail=ecfg.compact_tail, launches=json.dumps(launches),
        loss=json.dumps([round(x, 5) for x in losses]),
        ref_loss=json.dumps([round(x, 5) for x in ref_losses]),
        max_rel_dloss=f"{max(dloss):.5f}", rel_dnorm=f"{dnorm:.2e}",
        update_cos=f"{upd_cos:.5f}", update_rel_l2=f"{upd_rel:.5f}")

    # step time: CUDA events over 5 steps after 2 warm-ups
    epoch = cfg.SOLVER.WARMUP_ITERS + 1  # past the warmup: the full base lr
    for _ in range(2):
        step(batch, epoch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(batch, epoch), iters=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timing = dict(step_ms=f"{step_ms:.2f}", img_s=f"{B / step_ms * 1e3:.1f}",
                  peak_gb=f"{peak_gb:.2f}")
    if learn:  # 20 steps on one fixed batch (no augmentation) at that lr
        norm_img = make_eval_transform(cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)
        fixed = {m: norm_img(batch[m]) for m in ("RGB", "NI", "TI")}
        fixed.update(pid=batch["pid"], camid=batch["camid"])
        learner = make_step(model, torch.bfloat16, augment=False)
        curve = [float(learner(fixed, epoch)["loss"]) for _ in range(20)]
        if not np.mean(curve[-5:]) < np.mean(curve[:5]):
            raise AssertionError(f"the loss did not go down on a fixed batch: {curve}")
        timing.update(learn_first5=f"{np.mean(curve[:5]):.4f}",
                      learn_last5=f"{np.mean(curve[-5:]):.4f}")
    say(f"{label} timing", **timing)
    return launches, step_ms


def train_phase(gen: torch.Generator) -> tuple:
    """Phase 5: the flagship train step (compact tail): K1, K2, K3 forward,
    K4, K5 backward. Returns its launches and its ms per step."""
    cfg, ecfg = flagship()
    L = ecfg.vit.depth
    return train_check(cfg, ecfg, gen, "5 train",
                       expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2,
                                attention_qkv_bwd=L, masked_attention_qkv_bwd=2),
                       learn=True)


def uncompacted_phase(gen: torch.Generator):
    """Phase 6: the flagship model with TPU.COMPACT_TAIL off, through
    load_config -> editor_config_from: 129 tokens per modality and 387 joint,
    so the fusion block's attention runs K6 forward and K7 backward.
    (a) the eval forward against the plain fp32 run; (b) the compaction is
    exact on the card: the compact model with the same weights, both through
    the plain ops in fp32, gives the same features (rel-L2 <= 1e-4); (c) the
    train step against the plain fp32 run; (d) its time."""
    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.models.editor import Editor

    cfg, ecfg = flagship(["TPU.COMPACT_TAIL", "False"])
    if ecfg.compact_tail:
        raise AssertionError("TPU.COMPACT_TAIL False did not reach the model config")
    L = ecfg.vit.depth
    model, ref_model, batch, ref, eval_launches = eval_check(
        ecfg, gen, "6a uncompacted forward",
        expected(attention_qkv=L, rollout_chain=1, masked_attention_tiled=2))
    compact = Editor(dataclasses.replace(ecfg, compact_tail=True, use_pallas=False))
    compact.load_state_dict(ref_model.state_dict(), strict=True)
    comp = build_eval_step(compact, torch.float32)(batch)
    torch.cuda.synchronize()
    _, rel = _feature_agreement(comp, ref)
    if not rel <= 1e-4:
        raise AssertionError(f"compact vs uncompacted tail (fp32 plain): rel-L2 {rel}")
    say("6b compaction exact", max_rel_l2=f"{rel:.3e}", limit="1e-4")
    del model, ref_model, compact, batch, ref, comp
    torch.cuda.empty_cache()
    train_launches, _ = train_check(
        cfg, ecfg, gen, "6c uncompacted train",
        expected(attention_qkv=L, rollout_chain=1, attention_qkv_bwd=L,
                 masked_attention_tiled=2, masked_attention_tiled_bwd=2),
        learn=False)
    return eval_launches, train_launches


# The training loop (phase 8). The checked runs train on 16 ids x 32 items
# (the P x K sampler makes 3 batches of 8 ids x 16 an epoch); the timed run on
# RGBNT201's train split in size (171 ids, 3951 items: 21 batches an epoch).
# Evaluation as RGBNT201's test split: 30 ids, 836 items in 4 cameras, query
# = gallery = the same items (each query has 20 or 21 matches in other cameras)
LOOP_IDS, LOOP_PER_ID = 16, 32
TRAIN_IDS, TRAIN_ITEMS, TEST_IDS, TEST_ITEMS, CAMS = 171, 3951, 30, 836, 4


def _spread(n_items: int, n_ids: int, first_pid: int = 0) -> list:
    """(index, pid, camid) of ``n_items`` over ``n_ids`` ids as evenly as
    they go, each id's items in turn over the cameras."""
    per, extra = divmod(n_items, n_ids)
    out = []
    for pid in range(n_ids):
        for j in range(per + (pid < extra)):
            out.append((len(out), first_pid + pid, j % CAMS))
    return out


def _loop_data(size_hw):
    """(checked splits, timed splits, decode_fn) of phase 8 at ``size_hw``:
    per-identity uint8 prototypes plus noise from the seed, four noisy
    variants an identity made once, so that the decode costs the host only
    the batch's copy (the loader's)."""
    from editor_tpu_torch.data.datasets import DatasetSplits

    checked = [(("train", i), i // LOOP_PER_ID, i % CAMS, -1)
               for i in range(LOOP_IDS * LOOP_PER_ID)]
    timed = [(("train", i), pid, cam, -1) for i, pid, cam in _spread(TRAIN_ITEMS, TRAIN_IDS)]
    test = [(("test", i), pid, cam, -1)
            for i, pid, cam in _spread(TEST_ITEMS, TEST_IDS, first_pid=1000)]
    rng = np.random.default_rng(0)
    bank = {}
    for pid in sorted({it[1] for it in timed + test}):
        proto = rng.integers(0, 256, (3, *size_hw, 3), dtype=np.int16)
        bank[pid] = [np.clip(proto + rng.integers(-25, 26, proto.shape, dtype=np.int16),
                             0, 255).astype(np.uint8) for _ in range(4)]

    def decode(item):
        return list(bank[item[1]][(item[0][1] // CAMS) % 4])

    return (DatasetSplits(checked, test, test, LOOP_IDS, CAMS),
            DatasetSplits(timed, test, test, TRAIN_IDS, CAMS), decode)


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _event_pair() -> tuple:
    """Two timing events, the first recorded now."""
    ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev[0].record()
    return ev


class _LoopProbe:
    """Wraps the builders of the loop's train step and eval step (the loop
    and ``do_inference`` look them up at call time): per train step the
    launch counts it added, CUDA events recorded at its start and its end
    (after its last launch) and, with ``read_loss``, its loss (a host sync);
    per eval batch the launch counts and the same two events."""

    def __init__(self, read_loss: bool = True):
        self.read_loss = read_loss
        self.steps, self.events, self.losses, self.evals = [], [], [], []
        self.eval_events = []

    def __enter__(self):
        from editor_tpu_torch.engine import evaluate, loop

        self._saved = loop.build_train_step, evaluate.build_eval_step
        build_train, build_eval = self._saved

        def train_builder(*a, **k):
            inner = build_train(*a, **k)

            def step(batch, epoch):
                ev = _event_pair()
                before = launch_counts()
                m = inner(batch, epoch)
                ev[1].record()
                self.steps.append(_delta(launch_counts(), before))
                self.events.append((epoch, *ev))
                if self.read_loss:
                    self.losses.append(float(m["loss"]))
                return m

            step.generator = inner.generator
            return step

        def eval_builder(*a, **k):
            inner = build_eval(*a, **k)

            def extract(batch):
                ev = _event_pair()
                before = launch_counts()
                out = inner(batch)
                ev[1].record()
                self.evals.append(_delta(launch_counts(), before))
                self.eval_events.append(ev)
                return out

            return extract

        loop.build_train_step, evaluate.build_eval_step = train_builder, eval_builder
        return self

    def __exit__(self, *exc):
        from editor_tpu_torch.engine import evaluate, loop

        loop.build_train_step, evaluate.build_eval_step = self._saved

    def step_ms(self, skip: int) -> tuple:
        """Device ms between the starts of consecutive steps of one epoch (a
        step, its next batch's copy, any idle), the run's first ``skip``
        steps left out, and of each the ms from the step's last launch to
        the next one's start: the next batch's copy and the device's idle."""
        torch.cuda.synchronize()
        pairs = [(a, b) for a, b in zip(self.events[skip:], self.events[skip + 1:])
                 if a[0] == b[0]]
        return ([a[1].elapsed_time(b[1]) for a, b in pairs],
                [a[2].elapsed_time(b[1]) for a, b in pairs])

    def eval_ms(self) -> tuple:
        """Per eval batch the device ms from its forward's start to its last
        launch's end, and between consecutive batches the ms from one's end
        to the next one's start (its copy, its transform and any idle)."""
        torch.cuda.synchronize()
        ev = self.eval_events
        return ([a.elapsed_time(b) for a, b in ev],
                [a[1].elapsed_time(b[0]) for a, b in zip(ev, ev[1:])])


class _ComputeProbe:
    """Wraps ``R1mAPEvaluator.compute``: keeps the last evaluator's features
    (as ``do_inference`` handed them over) and result."""

    def __enter__(self):
        from editor_tpu_torch.evals.metrics import R1mAPEvaluator

        self._saved = compute = R1mAPEvaluator.compute

        def probe(ev):
            self.feats, self.num_query = torch.cat(ev.feats), ev.num_query
            self.out = compute(ev)
            return self.out

        R1mAPEvaluator.compute = probe
        return self

    def __exit__(self, *exc):
        from editor_tpu_torch.evals.metrics import R1mAPEvaluator

        R1mAPEvaluator.compute = self._saved


class _SaveProbe:
    """Wraps ``CheckpointManager.save``: the wall ms of each call (what the
    loop waits for: with ``use_async`` the host copy, and any wait for the
    write before it) and whether it wrote."""

    def __enter__(self):
        from editor_tpu_torch.utils.checkpoint import CheckpointManager

        self.calls = []
        self._saved = save = CheckpointManager.save

        def probe(mgr, step, payload):
            t0 = time.perf_counter()
            wrote = save(mgr, step, payload)
            self.calls.append(((time.perf_counter() - t0) * 1e3, wrote, mgr.use_async))
            return wrote

        CheckpointManager.save = probe
        return self

    def __exit__(self, *exc):
        from editor_tpu_torch.utils.checkpoint import CheckpointManager

        CheckpointManager.save = self._saved

    def summary(self) -> str:
        """ms of the calls that wrote, then of those that found the step saved."""
        wrote = [round(ms, 1) for ms, w, _ in self.calls if w]
        found = [round(ms, 1) for ms, w, _ in self.calls if not w]
        return json.dumps({"wrote": wrote, "step_already_saved": found})


def _train_cli(opts, splits, decode, read_loss=True):
    """cli.train on the in-memory data; (result, probe)."""
    from editor_tpu_torch.cli import train

    with _LoopProbe(read_loss) as probe:
        result = train.main(opts, splits=splits, decode_fn=decode)
    return result, probe


def _metrics_records(out: str) -> list:
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _payload_equal(a, b) -> bool:
    """Two loaded checkpoint payloads equal: tensors by torch.equal."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_payload_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_payload_equal(x, y) for x, y in zip(a, b))
    return a == b


def loop_phase(card: str, bare_step_ms: float) -> dict:
    """Phase 8: the flagship through the training loop (cli.train -> do_train)
    on in-memory data: (a) per-step and per-eval-batch launches, (b) the run's
    files and finite losses, (d) a resume against an uninterrupted run, (e)
    cli.test on the best epoch's checkpoint gives the loop's mAP of that
    epoch, (c) over the features do_inference handed the evaluator in (e),
    the card's distances within 1e-5 of the CPU evaluator's and the card's
    CMC and mAP equal to the CPU metric's on the card's distances; then eval
    images/s through ``evaluate``, metric ms, checkpoint save ms and bytes,
    and the loop's ms per step against phase 5's bare step and its idle
    share."""
    import shutil
    import tempfile

    from editor_tpu_torch.cli import test as cli_test
    from editor_tpu_torch.config import RGBNT201_PRESET, load_config
    from editor_tpu_torch.data.loader import ReIDDataModule
    from editor_tpu_torch.data.sampler import PKSampler
    from editor_tpu_torch.engine import loop
    from editor_tpu_torch.evals.metrics import R1mAPEvaluator, cmc_map
    from editor_tpu_torch.utils.checkpoint import CheckpointManager, train_state

    base = RGBNT201_PRESET + ["MODEL.PRETRAIN_CHOICE", "random", "SOLVER.LOG_PERIOD", "1",
                              "SOLVER.EVAL_PERIOD", "1", "SOLVER.CHECKPOINT_PERIOD", "1"]
    cfg = load_config(None, base + ["OUTPUT_DIR", ""])
    splits, timed_splits, decode = _loop_data(cfg.INPUT.SIZE_TRAIN)
    L = 12
    want_step = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2,
                         attention_qkv_bwd=L, masked_attention_qkv_bwd=2)
    want_eval = expected(attention_qkv=L, rollout_chain=1, masked_attention_qkv=2)
    n_val = len(splits.query) + len(splits.gallery)
    n_eval = -(-n_val // cfg.TEST.IMS_PER_BATCH)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        # (a), (b): two epochs with checkpoints, counted from zero
        x = os.path.join(tmp, "run")
        reset_counts()
        with _SaveProbe() as saves_a:  # TPU.ASYNC_CHECKPOINT at its default, True
            a, probe_a = _train_cli(base + ["SOLVER.MAX_EPOCHS", "2", "OUTPUT_DIR", x], splits,
                                    decode)
        run_launches = launch_counts()
        if not (cfg.TPU.ASYNC_CHECKPOINT and saves_a.calls
                and all(use_async for *_, use_async in saves_a.calls)):
            raise AssertionError(f"the loop's saves {saves_a.calls} were not asynchronous")
        sampler = PKSampler(splits.train, 128, 16, seed=cfg.SOLVER.SEED)
        ends = np.cumsum([len(sampler.epoch_indices(e)) // 128 for e in (1, 2, 3)])
        if len(probe_a.steps) != ends[1] or len(probe_a.evals) != 2 * n_eval:
            raise AssertionError(f"{len(probe_a.steps)} steps, {len(probe_a.evals)} eval batches")
        bad = [d for d in probe_a.steps if d != want_step] + [
            d for d in probe_a.evals if d != want_eval]
        if bad:
            raise AssertionError(f"loop launches {bad[0]} != {want_step} a step / "
                                 f"{want_eval} an eval batch")
        total = {k: len(probe_a.steps) * want_step[k] + len(probe_a.evals) * want_eval[k]
                 for k in want_step}
        if run_launches != total:
            raise AssertionError(f"run launches {run_launches} != {total}")
        files = sorted(os.listdir(x)) + sorted(os.listdir(os.path.join(x, "ckpt")))
        need = ["config.yaml", "metrics.jsonl", "train_log.txt", f"step_{ends[0]:09d}.pt",
                f"step_{ends[1]:09d}.pt"]
        losses_logged = [r["loss"] for r in _metrics_records(x) if "loss" in r]
        if not (set(need) <= set(files) and np.isfinite(probe_a.losses).all()
                and losses_logged == probe_a.losses):
            raise AssertionError(f"run files {files}, losses {probe_a.losses} {losses_logged}")
        say("8a loop launches", steps=len(probe_a.steps), eval_batches=len(probe_a.evals),
            eval_rows=n_val, per_step="as phase 5", per_eval_batch="as phase 3",
            run=json.dumps(run_launches))
        say("8b loop run", files=",".join(files), losses=json.dumps(probe_a.losses),
            best_map=f"{a['best']['mAP']:.6f}")
        del a
        torch.cuda.empty_cache()

        # (d): a third epoch resumed from the epoch-2 checkpoint, and three
        # uninterrupted epochs (no output directory: no checkpoints)
        # the resumed epoch saves synchronously: the loop's stall per save off
        with _SaveProbe() as saves_b:
            b, probe_b = _train_cli(base + ["SOLVER.MAX_EPOCHS", "3", "OUTPUT_DIR", x,
                                            "TPU.ASYNC_CHECKPOINT", "False"], splits, decode)
        if not saves_b.calls or any(use_async for *_, use_async in saves_b.calls):
            raise AssertionError(f"the resumed run's saves {saves_b.calls} were not synchronous")
        c, probe_c = _train_cli(base + ["SOLVER.MAX_EPOCHS", "3", "OUTPUT_DIR", ""], splits,
                                decode)
        with open(os.path.join(x, "train_log.txt")) as f:
            resumed = f"Resumed from checkpoint step {ends[1]} (epoch 2)" in f.read()
        got, ref = probe_a.losses + probe_b.losses, probe_c.losses
        rel = [abs(g - r) / abs(r) for g, r in zip(got, ref)]
        sb, sc = b["model"].state_dict(), c["model"].state_dict()
        max_param = max(float((sb[k].double() - sc[k].double()).abs().max()) for k in sb)
        bitwise = all(torch.equal(sb[k], sc[k]) for k in sb)
        if not (resumed and len(got) == len(ref) == ends[2] and max(rel) <= 1e-5):
            raise AssertionError(f"resume: resumed={resumed}, losses {got} vs {ref}")
        say("8d resume", resumed_at_step=ends[1], epoch3_losses=json.dumps(probe_b.losses),
            uninterrupted=json.dumps(ref[ends[1]:]), max_rel_dloss=f"{max(rel):.3e}",
            limit="1e-5",
            max_abs_param_diff=f"{max_param:.3e}", bit_for_bit=bitwise,
            written_by="async saves (TPU.ASYNC_CHECKPOINT True)")
        say("8 save stall", async_on_ms=saves_a.summary(), async_off_ms=saves_b.summary(),
            card=repr(card))
        del c
        torch.cuda.empty_cache()

        # (e): cli.test on the best epoch's checkpoint, alone in a directory
        logged = [r["mAP"] for r in _metrics_records(x) if "mAP" in r]
        best_epoch = max(range(3), key=lambda e: (logged[e], e)) + 1
        best_dir = os.path.join(tmp, "best")
        os.makedirs(best_dir)
        os.link(os.path.join(x, "ckpt", f"step_{ends[best_epoch - 1]:09d}.pt"),
                os.path.join(best_dir, f"step_{ends[best_epoch - 1]:09d}.pt"))
        with _ComputeProbe() as computed:
            _, map_test = cli_test.main(base + ["TEST.WEIGHT", best_dir, "OUTPUT_DIR", ""],
                                        splits=splits, decode_fn=decode)
        if not abs(map_test - logged[best_epoch - 1]) <= 1e-6:
            raise AssertionError(f"cli.test mAP {map_test} != the loop's "
                                 f"{logged[best_epoch - 1]} (epoch {best_epoch})")
        say("8e cli.test", weight=f"the best checkpoint (epoch {best_epoch})",
            map=f"{map_test:.7f}", loop_maps=json.dumps(logged))

        # (c): over the features of (e), the card's distances against the CPU
        # evaluator's (fp32 both, summed in other orders), and the card's CMC
        # and mAP against the CPU metric's (stable sort, gathers, cumsums) on
        # the card's distances
        feats, nq = computed.feats, computed.num_query
        cmc_gpu, map_gpu, dist_gpu, pids, cams, *_ = computed.out
        cmc_cpu, map_cpu = cmc_map(dist_gpu, pids[:nq], pids[nq:], cams[:nq], cams[nq:])

        def score(f):
            ev = R1mAPEvaluator(nq)
            ev.update(f, pids, cams)
            return ev.compute()

        cmc_e2e, map_e2e, dist_cpu, *_ = score(feats.cpu())
        dist_diff = float(np.abs(dist_gpu - dist_cpu).max())
        if not (feats.is_cuda and dist_diff <= 1e-5 and np.array_equal(cmc_gpu, cmc_cpu)
                and abs(map_gpu - map_cpu) <= 1e-6):
            raise AssertionError(f"card vs CPU metric: distances {dist_diff} apart, "
                                 f"{cmc_gpu[:5]} {map_gpu} vs {cmc_cpu[:5]} {map_cpu}")
        score(feats)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            score(feats)
        metric_ms = (time.perf_counter() - t0) / 5 * 1e3
        say("8c metric", queries=nq, gallery=len(pids) - nq, max_dist_diff=f"{dist_diff:.3e}",
            dist_limit="1e-5", map_card=f"{map_gpu:.7f}", map_cpu_same_dist=f"{map_cpu:.7f}",
            rank1=f"{cmc_gpu[0]:.4f}", cmc_equal=True, map_cpu_end_to_end=f"{map_e2e:.7f}",
            cmc_end_to_end_equal=bool(np.array_equal(cmc_gpu, cmc_e2e)),
            metric_ms=f"{metric_ms:.2f}", card=repr(card))
        del feats, computed

        # eval images/s through evaluate (twice), the resumed model
        model = b["model"]
        dm = ReIDDataModule(cfg, splits=splits, decode_fn=decode)
        eval_s, fwd, gaps, per_pass = [], [], [], []
        for _ in range(2):
            with _LoopProbe() as probe_e:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loop.evaluate(cfg, model, dm, torch.bfloat16)
                torch.cuda.synchronize()
                eval_s.append(time.perf_counter() - t0)
            f, g = probe_e.eval_ms()
            fwd, gaps = fwd + f[:-1], gaps + g  # the trimmed tail batch left out
            per_pass.append([round(v, 2) for v in g])
        say("8 eval timing", rows=n_val, batches=n_eval, batch=cfg.TEST.IMS_PER_BATCH,
            eval_s=json.dumps([round(v, 4) for v in eval_s]),
            eval_img_s=json.dumps([round(n_val / v, 1) for v in eval_s]),
            forward_ms_median=f"{np.median(fwd):.3f}",
            gap_ms_median=f"{np.median(gaps):.3f}", gap_ms_max=f"{max(gaps):.3f}",
            idle_share=f"{sum(gaps) / (sum(gaps) + sum(fwd)):.4f}",
            gaps_ms=json.dumps(per_pass), card=repr(card))

        # checkpoint save: time and bytes, synchronous; then the same payload
        # saved asynchronously, the model and its slots changed as soon as
        # save returns, and the file held against the synchronous one
        step_n, gen = int(ends[2]), b["step"].generator
        mgr = CheckpointManager(os.path.join(tmp, "save"), use_async=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(step_n, train_state(model, b["optimizer"], gen, 3))
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = os.path.getsize(mgr.path(step_n))
        amgr = CheckpointManager(os.path.join(tmp, "save_async"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        amgr.save(step_n, train_state(model, b["optimizer"], gen, 3))
        async_ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
            for st in b["optimizer"].state:
                for slots in st.values():
                    torch._foreach_add_(slots, 1.0)
        t0 = time.perf_counter()
        amgr.wait()
        write_ms = (time.perf_counter() - t0) * 1e3
        got = torch.load(amgr.path(step_n), map_location="cpu", weights_only=True)
        want = torch.load(mgr.path(step_n), map_location="cpu", weights_only=True)
        same = _payload_equal(got, want)
        if not same:
            raise AssertionError("the asynchronous checkpoint differs from the synchronous one")
        say("8 async save", sync_save_ms=f"{save_ms:.1f}", async_save_call_ms=f"{async_ms:.1f}",
            write_after_call_ms=f"{write_ms:.1f}", bytes=nbytes,
            equal_to_sync_after_mutation=same, card=repr(card))
        del b, model, got, want
        torch.cuda.empty_cache()

        # time: two epochs of RGBNT201's train split in size, logging every
        # 10 steps (a host sync), no evaluation and no checkpoints; the
        # run's first two steps left out
        t, probe_t = _train_cli(
            RGBNT201_PRESET + ["MODEL.PRETRAIN_CHOICE", "random", "SOLVER.MAX_EPOCHS", "2",
                               "SOLVER.EVAL_PERIOD", "100", "OUTPUT_DIR", ""],
            timed_splits, decode, read_loss=False)
        ms, gap = probe_t.step_ms(skip=2)
        if len(ms) < 20 or probe_t.steps[-1] != want_step:
            raise AssertionError(f"{len(ms)} timed steps, the last launching {probe_t.steps[-1]}")
        loop_ms = float(np.median(ms))
        say("8 loop timing", steps=len(probe_t.steps), timed=len(ms),
            loop_step_ms=f"{loop_ms:.2f}", mean=f"{np.mean(ms):.2f}",
            p10=f"{np.percentile(ms, 10):.2f}", p90=f"{np.percentile(ms, 90):.2f}",
            gap_ms_median=f"{np.median(gap):.3f}", gap_ms_max=f"{max(gap):.3f}",
            idle_share=f"{sum(gap) / sum(ms):.4f}", bare_step_ms=f"{bare_step_ms:.2f}",
            vs_bare=f"{1 - bare_step_ms / loop_ms:.4f}", img_s=f"{128 / loop_ms * 1e3:.1f}",
            ckpt_save_ms=f"{save_ms:.1f}", ckpt_bytes=nbytes, card=repr(card))
        del t
        torch.cuda.empty_cache()
        return {"run": run_launches, "train": want_step, "eval": want_eval}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The serving phase (phase 9): RGBNT201's test split in size (30 ids, 836
# items in 4 cameras; query = gallery), each item its own random images
SERVE_QUERIES = 32
VIS_IMAGES = 8


def _clustered(n: int, dim: int, n_ids: int, seed: int) -> np.ndarray:
    """[n, dim] float32 L2-normalised features around ``n_ids`` centres."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_ids, dim))
    f = centers[np.arange(n) % n_ids] + 0.5 * rng.standard_normal((n, dim))
    return (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(np.float32)


def _rerank_check(card: str) -> None:
    """(a) The C++ re-ranking loads and matches the numpy copy (30 x 120,
    the JAX package's test size); the device re-ranking's core on the card
    matches it at 836 x 836 on the same distance matrix (k1 50, k2 15,
    lambda 0.3: the evaluator's). End to end, the card computes the
    distances itself, in another summation order: a near tie at a k-th
    neighbour may flip a k-reciprocal set, so that reading is printed."""
    from editor_tpu_torch import native
    from editor_tpu_torch.evals.reranking import k_reciprocal_rerank
    from editor_tpu_torch.evals.reranking_device import _rerank_core, k_reciprocal_rerank_device

    if native.load_native() is None:
        raise AssertionError("the native re-ranking library did not build or load")
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((10, 16)) * 5
    q = (centers[rng.integers(0, 10, 30)] + 0.5 * rng.standard_normal((30, 16))).astype(np.float32)
    g = (centers[rng.integers(0, 10, 120)] + 0.5 * rng.standard_normal((120, 16))).astype(
        np.float32)
    small = float(np.abs(native.k_reciprocal_rerank_native(q, g, 10, 4, 0.3)
                         - k_reciprocal_rerank(q, g, 10, 4, 0.3)).max())
    _require("native re-ranking vs numpy", small, 1e-5)

    qf = _clustered(TEST_ITEMS, 3 * C, TEST_IDS, seed=1)
    gf = _clustered(TEST_ITEMS, 3 * C, TEST_IDS, seed=2)
    t0 = time.perf_counter()
    ref = native.k_reciprocal_rerank_native(qf, gf, 50, 15, 0.3)
    native_ms = (time.perf_counter() - t0) * 1e3
    original = torch.from_numpy(native.original_dist(qf, gf)).cuda()
    with torch.inference_mode():
        _rerank_core(original, TEST_ITEMS, 50, 15, 0.3)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        core = _rerank_core(original, TEST_ITEMS, 50, 15, 0.3).cpu().numpy()
        core_ms = (time.perf_counter() - t0) * 1e3
    core_err = float(np.abs(core - ref).max())
    _require("device re-ranking core vs native, 836 x 836", core_err, 1e-5)
    qd, gd = torch.from_numpy(qf).cuda(), torch.from_numpy(gf).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e2e = k_reciprocal_rerank_device(qd, gd, 50, 15, 0.3)
    e2e_ms = (time.perf_counter() - t0) * 1e3
    off = np.abs(e2e - ref)
    say("9a rerank", small_native_vs_numpy=f"{small:.3e}", n=f"{TEST_ITEMS}x{TEST_ITEMS}",
        native_ms=f"{native_ms:.1f}", device_core_ms=f"{core_ms:.1f}",
        device_core_vs_native=f"{core_err:.3e}", limit="1e-5",
        device_end_to_end_ms=f"{e2e_ms:.1f}", end_to_end_max_diff=f"{float(off.max()):.3e}",
        end_to_end_share_over_limit=f"{float((off > 1e-5).mean()):.6f}", card=repr(card))


def _serve_data(size_hw):
    """(splits, decode_fn, images [items, 3, H, W, 3] uint8) of phase 9: the
    timed run's train split (171 ids, for the class count) and RGBNT201's test
    split in size, each test item its own uniform random images (so each
    query has one right answer), made in bulk."""
    from editor_tpu_torch.data.datasets import DatasetSplits

    train = [(("train", i), pid, cam, -1) for i, pid, cam in _spread(TRAIN_ITEMS, TRAIN_IDS)]
    test = [(("test", i), pid, cam, -1)
            for i, pid, cam in _spread(TEST_ITEMS, TEST_IDS, first_pid=1000)]
    images = np.random.default_rng(3).integers(0, 256, (TEST_ITEMS, 3, *size_hw, 3),
                                               dtype=np.uint8)

    def decode(item):
        return list(images[item[0][1]]) if item[0][0] == "test" else list(images[0])

    return DatasetSplits(train, test, test, TRAIN_IDS, CAMS), decode, images


class _Recorder:
    """Stands in for the server's extractor: records each call's images,
    camids, features and wall ms."""

    def __init__(self, ex):
        self.ex, self.size_hw, self.calls = ex, ex.size_hw, []

    def __call__(self, images, camids=None):
        t0 = time.perf_counter()
        out = self.ex(images, camids)
        self.calls.append((images, camids, out, (time.perf_counter() - t0) * 1e3))
        return out


def _timed_calls(fn, log: list):
    """``fn`` wrapped to append each call's wall ms to ``log``."""
    def wrapped(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        log.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapped


def _http(addr, path, payload=None):
    """(status, body, ms) of a GET (no payload) or a POST to ``addr``."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://{addr[0]}:{addr[1]}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            code, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, body = e.code, json.loads(e.read())
    return code, body, (time.perf_counter() - t0) * 1e3


def serve_phase(card: str) -> dict:
    """Phase 9: (a) native and device re-ranking; (b) cli.export of a
    flagship checkpoint, cli.serve.build_service on the .pth over RGBNT201's
    test split in size, a RetrievalServer on 127.0.0.1 answering /healthz,
    SERVE_QUERIES batch-1 /query requests (each retrieving itself at rank 1,
    its features bit for bit the in-process call's, K1 12, K2 1 and K3 2
    launches each), a re-ranked /query, /gallery/add and a malformed request;
    (c) dump_eval_visualizations on VIS_IMAGES images, its launches, its
    rollouts and union mask against the plain fp32 run; (d) whether PIL and
    the JPEG codec were available. Without PIL the requests carry .npy bytes
    (the module's decoder swapped for this phase) and the visualisation's
    overlay arrays are held in place of its files."""
    import base64
    import importlib.util
    import io
    import logging
    import shutil
    import tempfile

    from editor_tpu_torch import native
    from editor_tpu_torch import serve as serve_mod
    from editor_tpu_torch.cli import export as cli_export
    from editor_tpu_torch.cli import serve as cli_serve
    from editor_tpu_torch.config import RGBNT201_PRESET, load_config
    from editor_tpu_torch.data.transforms import make_eval_transform
    from editor_tpu_torch.models.editor import Editor, editor_config_from
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.utils import visualize
    from editor_tpu_torch.utils.checkpoint import CheckpointManager

    _rerank_check(card)
    has_pil = importlib.util.find_spec("PIL") is not None
    warned = []
    handler = logging.Handler()
    handler.emit = lambda record: warned.append(record.getMessage())
    logging.getLogger("editor_tpu_torch.native").addHandler(handler)
    try:
        codec = native.load_imagecodec() is not None
    finally:
        logging.getLogger("editor_tpu_torch.native").removeHandler(handler)
    codec_note = "available" if codec else "unavailable: " + next(
        (line for msg in warned for line in msg.splitlines() if "error" in line),
        warned[0].splitlines()[0] if warned else "no message")

    opts = RGBNT201_PRESET + ["MODEL.PRETRAIN_CHOICE", "random", "OUTPUT_DIR", ""]
    cfg = load_config(None, opts)
    splits, decode, images = _serve_data(tuple(cfg.INPUT.SIZE_TEST))
    ecfg = editor_config_from(cfg, splits.num_train_pids, splits.num_train_cams)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    saved_decoder, saved_save = serve_mod._decode_b64_image, visualize._save
    server = None
    try:
        # (b) a checkpoint of the flagship, exported, served
        model = editor_init(ecfg, seed=cfg.SOLVER.SEED)
        ckpt = os.path.join(tmp, "ckpt")
        mgr = CheckpointManager(ckpt)
        mgr.save(1, {"model": model.state_dict(), "epoch": 1})
        mgr.close()
        pth = os.path.join(tmp, "EDITOR.pth")
        exported = cli_export.main(["--out", pth] + opts + ["TEST.WEIGHT", ckpt], splits=splits)
        own = model.state_dict()
        if not (exported.keys() == own.keys()
                and all(torch.equal(exported[k], own[k].cpu()) for k in own)):
            raise AssertionError("cli.export's state_dict differs from the checkpoint's")
        del model, own, exported
        t0 = time.perf_counter()
        ex, index = cli_serve.build_service(cfg, weight=pth, batch_size=32, splits=splits,
                                            decode_fn=decode)
        index_s = time.perf_counter() - t0
        if len(index) != TEST_ITEMS or index.feat_dim != 3 * C:
            raise AssertionError(f"gallery of {len(index)} x {index.feat_dim}")

        if has_pil:
            from PIL import Image

            def encode(arr):
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="PNG")
                return base64.b64encode(buf.getvalue()).decode()
        else:
            def encode(arr):
                buf = io.BytesIO()
                np.save(buf, arr)
                return base64.b64encode(buf.getvalue()).decode()

            def npy_decode(data, size_hw):
                arr = np.load(io.BytesIO(base64.b64decode(data)))
                if arr.shape[:2] != tuple(size_hw):
                    raise ValueError(f"image {arr.shape} is not {size_hw}")
                return arr

            serve_mod._decode_b64_image = npy_decode
        decode_ms, query_ms = [], []
        serve_mod._decode_b64_image = _timed_calls(serve_mod._decode_b64_image, decode_ms)
        rec = _Recorder(ex)
        server = serve_mod.RetrievalServer(rec, index, "127.0.0.1", 0)
        server._query = _timed_calls(server._query, query_ms)
        server.start()
        addr = server.address
        code, health, _ = _http(addr, "/healthz")
        if code != 200 or health != {"status": "ok", "gallery_size": TEST_ITEMS,
                                     "feat_dim": 3 * C}:
            raise AssertionError(f"/healthz {code} {health}")

        def request(i, **extra):
            item = splits.gallery[i]
            return item, {"images": {m: encode(images[i, k]) for k, m in
                                     enumerate(("RGB", "NI", "TI"))}, "topk": 5,
                          "camid": int(item[2]), **extra}

        for i in (0, 1):  # warm-up
            _http(addr, "/query", request(i)[1])
        picks = np.random.default_rng(4).choice(TEST_ITEMS, SERVE_QUERIES, replace=False)
        reqs = [request(int(i)) for i in picks]
        health_ms = [_http(addr, "/healthz")[2] for _ in range(8)]
        rec.calls.clear()
        del decode_ms[:], query_ms[:]
        torch.cuda.synchronize()
        reset_counts()
        lat = []
        for item, req in reqs:
            code, body, ms = _http(addr, "/query", req)
            lat.append(ms)
            if code != 200 or body["matches"][0]["path"] != str(item[0]):
                raise AssertionError(f"/query for {item}: {code} {body}")
        counts = launch_counts()
        want = expected(attention_qkv=12 * SERVE_QUERIES, rollout_chain=SERVE_QUERIES,
                        masked_attention_qkv=2 * SERVE_QUERIES)
        if counts != want:
            raise AssertionError(f"{SERVE_QUERIES} queries launched {counts} != {want}")
        per_query = {k: v // SERVE_QUERIES for k, v in counts.items()}
        # where a request's time goes: the handler's _query (three image
        # decodes, the extractor, the search) and the rest (HTTP, JSON, the
        # client); client and server threads share this process
        extract_ms = [c[3] for c in rec.calls]
        decodes = np.asarray(decode_ms).reshape(SERVE_QUERIES, 3).sum(1)
        parts = {"query_handler": query_ms, "decode_3_images": decodes, "extract": extract_ms,
                 "search_and_rest": np.subtract(query_ms, decodes) - extract_ms,
                 "http_json_client": np.subtract(lat, query_ms), "healthz": health_ms}
        breakdown = {k: round(float(np.median(v)), 2) for k, v in parts.items()}
        # the server's features against the in-process call, bit for bit
        for (item, _), i, (imgs, cams, feat, _) in zip(reqs, picks, rec.calls):
            if not all(np.array_equal(imgs[m][0], images[i, k])
                       for k, m in enumerate(("RGB", "NI", "TI"))):
                raise AssertionError(f"decoded images of {item} differ from the sent ones")
            if not np.array_equal(feat, ex(imgs, cams)):
                raise AssertionError(f"features of {item} over HTTP != in process")
        item, req = request(int(picks[0]), reranking=True)
        code, body, rr_ms = _http(addr, "/query", req)
        if code != 200 or body["matches"][0]["pid"] != item[1]:
            raise AssertionError(f"re-ranked /query: {code} {body}")
        code, added, _ = _http(addr, "/gallery/add", {**request(5)[1], "pid": 9999,
                                                      "path": "added"})
        if code != 200 or added != {"ok": True, "gallery_size": TEST_ITEMS + 1}:
            raise AssertionError(f"/gallery/add {code} {added}")
        code, bad, _ = _http(addr, "/query", {"images": {}})
        if code != 400 or "error" not in bad:
            raise AssertionError(f"malformed /query: {code} {bad}")
        server.shutdown()
        server = None
        say("9b serve", gallery=TEST_ITEMS, index_s=f"{index_s:.2f}", queries=SERVE_QUERIES,
            rank1="self", features="bit for bit",
            per_query=json.dumps({k: v for k, v in per_query.items() if v}),
            http_b1_p50_ms=f"{np.percentile(lat, 50):.2f}",
            http_b1_p99_ms=f"{np.percentile(lat, 99):.2f}",
            median_ms_parts=json.dumps(breakdown), rerank_query_ms=f"{rr_ms:.1f}",
            rerank_top1_pid="same", add="ok", malformed=400,
            decoder="PIL (PNG)" if has_pil else ".npy bytes (no PIL)", card=repr(card))

        # (c) the visualisation on VIS_IMAGES gallery images
        transform = make_eval_transform(tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD))
        vis = {m: transform(torch.from_numpy(images[:VIS_IMAGES, k]).cuda())
               for k, m in enumerate(("RGB", "NI", "TI"))}
        cams = torch.tensor([it[2] for it in splits.gallery[:VIS_IMAGES]], device="cuda")
        held = {}
        if not has_pil:
            visualize._save = lambda path, arr: held.__setitem__(os.path.basename(path), arr)
        torch.cuda.synchronize()
        reset_counts()
        paths = visualize.dump_eval_visualizations(os.path.join(tmp, "vis"), ex.model, vis,
                                                   cam_ids=cams, compute_dtype=torch.bfloat16)
        vis_counts = launch_counts()
        want_vis = expected(attention_qkv=3 * 12, rollout_chain=3)
        if vis_counts != want_vis:
            raise AssertionError(f"visualisation launched {vis_counts} != {want_vis}")
        n_files = 3 * VIS_IMAGES * 2 + VIS_IMAGES
        shapes = {a.shape for a in held.values()}
        if len(held if not has_pil else paths) != n_files or (
                held and shapes != {(*cfg.INPUT.SIZE_TEST, 3)}):
            raise AssertionError(f"{len(paths)} files, {len(held)} arrays {shapes}")
        plain = Editor(dataclasses.replace(ecfg, use_pallas=False))
        plain.load_state_dict(ex.model.state_dict(), strict=True)
        rolls, union = visualize.eval_visualization_maps(ex.model, vis, cams, torch.bfloat16)
        rolls_p, union_p = visualize.eval_visualization_maps(plain, vis, cams, torch.float32)
        rel = {m: float((rolls[m] - rolls_p[m]).norm() / rolls_p[m].norm()) for m in rolls}
        agree = float((union == union_p).float().mean())
        if not (max(rel.values()) <= 0.05 and agree >= 0.9):
            raise AssertionError(f"visualisation vs plain fp32: rollout rel-L2 {rel}, "
                                 f"union mask agreement {agree}")
        say("9c visualize", images=VIS_IMAGES,
            launches=json.dumps({k: v for k, v in vis_counts.items() if v}),
            outputs=f"{n_files} {'PNG files' if has_pil else 'overlay arrays (no PIL)'}",
            rollout_rel_l2=json.dumps({m: round(v, 5) for m, v in rel.items()}),
            rel_l2_limit=0.05, union_agreement=f"{agree:.4f}", agreement_limit=0.9,
            union_kept=f"{float(union.float().mean()):.4f}")
        say("9d host", pil=has_pil, codec=repr(codec_note))
        return {"query": per_query, "visualize": vis_counts}
    finally:
        if server is not None:
            server.shutdown()
        serve_mod._decode_b64_image, visualize._save = saved_decoder, saved_save
        shutil.rmtree(tmp, ignore_errors=True)


def timed(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    say(f"{name} time", seconds=f"{time.perf_counter() - t0:.1f}")
    return out


def main() -> None:
    card = card_check()
    timed("1 build", build_phase)
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = timed("2 kernels", kernel_phase, gen)
    model, eval_launches = timed("3 forward", forward_phase, gen)
    timed("4 serving", serving_phase, model, gen, card)
    del model
    torch.cuda.empty_cache()
    launches, bare_step_ms = timed("5 train", train_phase, gen)
    torch.cuda.empty_cache()
    un_eval, un_train = timed("6 uncompacted", uncompacted_phase, gen)
    torch.cuda.empty_cache()
    kernels.update(timed("7 variants", variant_phase, gen))
    torch.cuda.empty_cache()
    looped = timed("8 loop", loop_phase, card, bare_step_ms)
    torch.cuda.empty_cache()
    served = timed("9 serve", serve_phase, card)
    # launches, launches_eval: per train step and per eval forward (loop: eval
    # batch), summed over the three paths (compact: phases 3 and 5;
    # uncompacted: phase 6; the loop: phase 8, with its run's total), each
    # path counted from zero just before it runs
    rows = []
    for name, spec in {**KERNELS, **VARIANTS}.items():
        by_path = {"compact": {"train": launches[name], "eval": eval_launches[name]},
                   "uncompacted": {"train": un_train[name], "eval": un_eval[name]},
                   "loop": {k: looped[k][name] for k in ("train", "eval", "run")},
                   "serve": {k: served[k][name] for k in ("query", "visualize")}}
        info = {k: v for k, v in spec.items() if k != "tool"}
        rows.append(dict(name=name, route="cuda", **info,
                         launches=launches[name] + un_train[name] + looped["train"][name],
                         launches_eval=(eval_launches[name] + un_eval[name]
                                        + looped["eval"][name]),
                         launches_by_path=by_path, **kernels[name]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
