"""Where the time of the flagship eval forward goes on one CUDA device.

    python3 -m editor_tpu_torch.tools.profile_forward [--batch 128 1] [--iters 10]
        [--opts KEY VALUE ...]

The model is the flagship one, ``editor_config_from(load_config(None,
RGBNT201_PRESET + opts), 171, 6)``: ``--opts TPU.COMPACT_TAIL False``
profiles the uncompacted fusion tail (K6), any other ``load_config`` override
works the same way. For each batch size: the forward's time per call from
CUDA events over ``--iters`` back-to-back calls of ``build_eval_step`` (bf16,
seeded random weights and images) after two warm-ups, images per second,
peak device memory, and a ``torch.profiler`` trace of ``--profile-iters``
more calls. The trace's device time is grouped per forward into the port's
kernels (K1-K8, and the design variants T1-T5 of the ``bench_*`` tools;
T6 launches K3/K5 walking g sequences a block), GEMMs, LayerNorm, GELU, the
patch conv and the remaining elementwise and copy kernels; the device's idle
share is 1 - (device busy time / event time). The card's name and power
limit head the output; the full per-kernel tables go to ``--out`` (by
default the git-ignored
``editor_tpu_torch/_build/profile_forward.txt``). Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

# the first pattern that matches the lower-case kernel name wins; the conv
# comes before the GEMMs because cuDNN's conv kernels are implicit GEMMs
CATEGORIES = (
    # K1, K3 and K6: the tensor-core forward body's forms kQkv, kFull and
    # kTiled (an enum argument, demangled as "(...FwdForm)0" or by name); K3
    # and K6 walking g sequences a block (T6's forward, K6's group sweep) are
    # the same forms of its walk kernel
    ("K1 attention_qkv", r"attention_fwd_mma_kernel<[^,]*fwdform(\)0|::kqkv)"),
    ("K2 rollout_chain", r"rollout_chain_kernel"),
    ("K3 masked_attention", r"attention_fwd_mma(_walk)?_kernel<[^,]*fwdform(\)1|::kfull)"),
    # K4, K7 and K5: the tensor-core backward body's forms kQkv, kTiled and
    # kFull (an enum argument, demangled as "(...BwdForm)0" or by name); K5
    # walking g sequences a block (T6's backward) is kFull of its walk kernel
    ("K4 attention_qkv_bwd", r"attention_bwd_mma_kernel<[^,]*bwdform(\)0|::kqkv)"),
    ("K5 masked_attention_bwd",
     r"attention_bwd_mma(_walk)?_kernel<[^,]*bwdform(\)2|::kfull)"),
    ("K6 masked_attention_tiled", r"attention_fwd_mma(_walk)?_kernel<[^,]*fwdform(\)2|::ktiled)"),
    ("K7 masked_attention_tiled_bwd", r"attention_bwd_mma_kernel<[^,]*bwdform(\)1|::ktiled)"),
    ("K8 ln_matmul", r"ln_matmul_kernel"),
    # T2 and T1: the forward body's forms kNoMax and kSplit
    ("T1/T2 attention variants",
     r"attention_fwd_mma_kernel<[^,]*fwdform(\)[34]|::knomax|::ksplit)"),
    ("T3 attn_layer", r"attn_layer_kernel"),
    ("T4 rollout variants", r"rollout_variant_kernel|rollout_rows_kernel"),
    ("T5 rollout_multi", r"rollout_multi_kernel"),
    ("optimizer (foreach)", r"multi_tensor_apply|foreach"),
    ("patch conv (cuDNN)", r"fprop|dgrad|wgrad|cudnn|nchw|nhwc|conv(?!ert)"),
    ("GEMM (cuBLAS)", r"gemm|nvjet|xmma|cutlass|cublas"),
    ("LayerNorm", r"layer_?norm|gamma_?beta"),
    ("GELU", r"gelu"),
)
OTHER = "other elementwise / copy / reduce"


def category(kernel_name: str) -> str:
    name = kernel_name.lower()
    for label, pattern in CATEGORIES:
        if re.search(pattern, name):
            return label
    return OTHER


def flagship_from_opts(opts) -> tuple:
    """(Config, EditorConfig) of the flagship preset with ``opts`` (a flat
    KEY VALUE list of ``load_config`` overrides) on top: one source for the
    solver, the input and the model."""
    from editor_tpu_torch.config import RGBNT201_PRESET, load_config
    from editor_tpu_torch.models.editor import editor_config_from

    cfg = load_config(None, RGBNT201_PRESET + list(opts or []))
    return cfg, editor_config_from(cfg, num_classes=171, camera_num=6)


def add_opts_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--opts", nargs="+", default=[], metavar="KEY VALUE",
                    help="load_config overrides, e.g. TPU.COMPACT_TAIL False")


def _batch(gen: torch.Generator, B: int, size) -> dict:
    batch = {m: torch.randn(B, *size, 3, generator=gen, device="cuda")
             for m in ("RGB", "NI", "TI")}
    batch["camid"] = torch.arange(B, device="cuda") % 6
    return batch


def _event_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_kernels(prof) -> list:
    """(name, self device ms, launches) of every device kernel in the trace."""
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        if us > 0:
            rows.append((evt.key, us / 1e3, evt.count))
    if not rows:
        raise RuntimeError("the profiler recorded no device time; time with CUDA events")
    return sorted(rows, key=lambda r: -r[1])


def profile_calls(call, B: int, iters: int, profile_iters: int, log,
                  what: str = "forward") -> dict:
    """Time ``call()`` (one forward or one train step of B images) with CUDA
    events after two warm-ups, then trace ``profile_iters`` more calls and
    group the device time per call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = _event_ms(call, iters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(profile_iters):
            call()
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    groups: dict = {}
    for name, kms, count in kernels:
        g = groups.setdefault(category(name), [0.0, 0])
        g[0] += kms / profile_iters
        g[1] += count / profile_iters
    busy = sum(g[0] for g in groups.values())
    log(f"== B={B}: {ms:.3f} ms per {what} (CUDA events, {iters} calls), "
        f"{B / ms * 1e3:.1f} img/s, peak {peak_gb:.3f} GB; device busy "
        f"{busy:.3f} ms, idle share {1 - busy / ms:.3f}")
    log(f"{'category':36s} {'ms/call':>9s} {'share':>7s} {'launches/call':>14s}")
    for label, (gms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"{label:36s} {gms:9.3f} {gms / busy:7.1%} {n:14.1f}")
    return dict(B=B, ms=ms, img_s=B / ms * 1e3, peak_gb=peak_gb, busy_ms=busy,
                idle_share=1 - busy / ms,
                launches=sum(g[1] for g in groups.values()),
                groups={k: round(v[0], 4) for k, v in groups.items()},
                kernels=[(n, kms / profile_iters, c / profile_iters)
                         for n, kms, c in kernels])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[128, 1])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--profile-iters", type=int, default=3)
    ap.add_argument("--out", default="editor_tpu_torch/_build/profile_forward.txt")
    add_opts_arg(ap)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_forward: no CUDA device")
    card = card_name()
    print(card, flush=True)

    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.models.init import editor_init

    _, cfg = flagship_from_opts(args.opts)
    print(f"compact_tail={cfg.compact_tail} opts={args.opts}", flush=True)
    step = build_eval_step(editor_init(cfg, seed=0, device="cuda"), torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for B in args.batch:
        batch = _batch(gen, B, cfg.vit.img_size)
        results.append(profile_calls(lambda: step(batch), B, args.iters,
                                     args.profile_iters, lambda s: print(s, flush=True)))

    write_report(args.out, card, results, "forward")


def card_name() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def write_report(path: str, card: str, results: list, what: str) -> None:
    """The per-kernel tables to ``path``; one JSON summary line to stdout."""
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        f.write(card + "\n")
        for r in results:
            f.write(f"\n== B={r['B']}: per {what}, self device time\n")
            for name, kms, count in r["kernels"]:
                f.write(f"{kms:10.4f} ms {count:7.1f}x  [{category(name)}] {name}\n")
    print(json.dumps({"card": card, "results": [
        {k: v for k, v in r.items() if k != "kernels"} for r in results]}), flush=True)


if __name__ == "__main__":
    main()
