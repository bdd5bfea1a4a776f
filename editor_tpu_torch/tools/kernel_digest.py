"""Digest and time of each shipped kernel (K1-K8) at the main paths' shapes,
and of the design variants T1, T2 and T6, on one CUDA device, to hold two
checkouts against each other on one card.

    PYTHONPATH=<checkout> python3 <this file> [--iters 20] [--save K1.pt]
    PYTHONPATH=<this checkout> python3 <this file> --diff A.pt B.pt

It imports ``editor_tpu_torch`` from the path it is given, so the same file
runs another checkout's kernels (it calls only K1-K8's wrappers with the
arguments they have taken since K8 was added, and T1's, T2's and T6's with
those they have taken since they were added). The inputs come from a CUDA
generator seeded with 0, in one fixed order: K1 with its probs and K4 at
[384, 129, 2304]; K2 on peaked maps
(L = 12, Z = 4608, N = 129); K3 and K5 at [384, 88] and [128, 264]; K6 and
K7 at [384, 129], [128, 387] and [128, 258] (masks rand < 0.5 with the cls
keys kept); K8 at [49536, 768] -> 2304 and -> 3072 + GELU; last K4 at the
shapes its wrapper takes beyond the model's (B = 3 at N = 17, 200 and 512
with D = 64, N = 129 at D = 96 and at D = 32); last K3 at the batch-1
serving shapes [3, 88] and [1, 264] and beyond the model's shapes (B = 3 at
N = 1, 15, 16, 17, 144, 145, 200 and 512 with D = 64, N = 264 at D = 32, 96
and 128: every shape chip_smoke holds K3 at but N = 512 with D = 128, where
the CUDA-core K3 of earlier checkouts needs more shared memory than a block
has); then T1 (``bench_attn.headgrid_attn``: separate q, k, v [384, 129,
768], 2 heads and 1 sequence a block, with probs), T2
(``bench_attn2.nomax_attn`` at [384, 129, 2304], 1 sequence a block), T6
(``bench_full_kernel.masked_full`` and ``masked_full_bwd`` at [384, 88] and
[128, 264] at the JAX package's groups, ``full_group``: forward 8 and 2,
backward 4 and 2 sequences a block; a checkout whose T6 takes ``warps`` in
place of ``g`` runs its 8 warps a block) and last T3
(``bench_attn_layer.attn_layer`` on ``layer_inputs`` at [384, 129, 768], g =
1, 2 and 4, each with and without the probs). For each call it prints one
JSON line: the kernel, the shape, the
sha256 of its output bytes (the first 16 hex digits) and its ms from CUDA
events. The card's name and power limit come first. Exits non-zero without
a CUDA device.

``--save`` also writes K1's output and probs, K3's output and K4's dqkv at
each of their shapes, K5's dqkv at its two, K6's output at its two model
shapes ([384, 129] and [128, 387]), K7's dqkv at its three shapes, T1's
output and probs, T2's output, T6's output and dqkv at its two shapes and
T3's output and probs (g = 1) to a file, and ``--diff`` prints, for two
such files (two checkouts' kernels on the same input), the largest
difference of each tensor, the share of elements that differ and the
largest difference in bf16 ulps of the first file's element.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys

import torch

H, C = 12, 768
D = C // H
SCALE = D ** -0.5
FILL = -65504.0


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def event_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def diff(path_a: str, path_b: str) -> dict:
    """{tensor: {max_abs, share_differing, max_bf16_ulps, share_over_one_ulp}}
    of two --save files (ulps of the first file's element; where that is 0,
    the difference; near-zero elements of a sum taken in another order give
    large ulps: share_over_one_ulp is ``_bench.bf16_off_share``, the share
    more than one ulp + 1e-6 of the first file's largest magnitude away)."""
    from editor_tpu_torch.tools import _bench  # this checkout's: --diff reads files only

    a, b = (torch.load(p, map_location="cpu") for p in (path_a, path_b))
    res = {}
    for name in a:
        x, y = a[name].float(), b[name].float()
        d = (x - y).abs()
        ulp = _bench.bf16_ulp(x)
        res[name] = dict(max_abs=float(d.max()), share_differing=float((d > 0).float().mean()),
                         max_bf16_ulps=float((d / torch.where(ulp > 0, ulp, 1.0)).max()),
                         share_over_one_ulp=_bench.bf16_off_share(y, x))
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--save", help="write K1's output and probs, K3's and K6's output, "
                    "K4's, K5's and K7's dqkv, T1's and T2's output, T6's output and "
                    "dqkv and T3's output and probs to this file")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"), help="compare two --save files")
    args = ap.parse_args(argv)
    if args.diff:
        print(json.dumps(diff(*args.diff)), flush=True)
        return
    if not torch.cuda.is_available():
        sys.exit("kernel_digest: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)
    from editor_tpu_torch import ops
    from editor_tpu_torch.tools import bench_attn, bench_attn2, bench_attn_layer, bench_full_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, mul=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * mul).to(bf)

    def mask(B, N, tile):
        m = torch.rand(B, N, generator=gen, device="cuda") < 0.5
        return (m | (torch.arange(N, device="cuda") % tile == 0)[None, :]).float()

    def line(name, shape, fn):
        out = fn()
        outs = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        print(json.dumps({"kernel": name, "shape": list(shape), "sha256": digest(*outs),
                          "ms": round(event_ms(fn, args.iters), 5)}), flush=True)

    qkv, g = randn(384, 129, 3 * C), randn(384, 129, C)
    probs = torch.empty(384, H, 129, 129, dtype=bf, device="cuda")
    line("K1 attention_qkv", qkv.shape,
         lambda: (ops.attention_qkv(qkv, H, SCALE, probs_out=probs)[0], probs))
    saved = {}
    if args.save:
        out, _ = ops.attention_qkv(qkv, H, SCALE, probs_out=probs)
        saved.update(out=out.cpu(), probs=probs.cpu())
    line("K4 attention_qkv_bwd", qkv.shape, lambda: ops.attention_qkv_bwd(qkv, g, H, SCALE))
    if args.save:
        saved[f"K4 dqkv {list(qkv.shape)}"] = ops.attention_qkv_bwd(qkv, g, H, SCALE).cpu()
    del qkv, g, probs
    maps = torch.empty(12, 384, H, 129, 129, dtype=bf, device="cuda")
    for l in range(12):
        maps[l] = torch.softmax(4.0 * torch.randn(384, H, 129, 129, generator=gen,
                                                  device="cuda"), dim=-1).to(bf)
    line("K2 rollout_chain", maps.shape, lambda: ops.rollout_chain(maps))
    del maps
    for B, N in ((384, 88), (128, 264)):
        qkv, m, g = randn(B, N, 3 * C), mask(B, N, 88), randn(B, N, C)
        line("K3 masked_attention_qkv", qkv.shape,
             lambda: ops.masked_attention_qkv(qkv, m, H, SCALE, FILL))
        if args.save:
            saved[f"K3 out {list(qkv.shape)}"] = ops.masked_attention_qkv(qkv, m, H, SCALE,
                                                                          FILL).cpu()
        line("K5 masked_attention_qkv_bwd", qkv.shape,
             lambda: ops.masked_attention_qkv_bwd(qkv, m, g, H, SCALE, FILL))
        if args.save:
            saved[f"K5 dqkv {list(qkv.shape)}"] = ops.masked_attention_qkv_bwd(
                qkv, m, g, H, SCALE, FILL).cpu()
    for B, N in ((384, 129), (128, 387), (128, 258)):
        qkv, m, g = randn(B, N, 3 * C), mask(B, N, 129), randn(B, N, C)
        line("K6 masked_attention_tiled", qkv.shape,
             lambda: ops.masked_attention_tiled(qkv, m, H, SCALE, FILL, 129))
        if args.save and N != 258:
            saved[f"K6 out [{B}, {N}]"] = ops.masked_attention_tiled(qkv, m, H, SCALE, FILL,
                                                                     129).cpu()
        line("K7 masked_attention_tiled_bwd", qkv.shape,
             lambda: ops.masked_attention_tiled_bwd(qkv, m, g, H, SCALE, FILL, 129))
        if args.save:
            saved[f"K7 dqkv [{B}, {N}]"] = ops.masked_attention_tiled_bwd(
                qkv, m, g, H, SCALE, FILL, 129).cpu()
    del qkv, m, g
    torch.cuda.empty_cache()
    x = randn(384 * 129, C, mul=2.0)
    for O, act in ((3 * C, ""), (4 * C, "gelu")):
        w = torch.randn(O, C, generator=gen, device="cuda") * 0.02
        b = torch.randn(O, generator=gen, device="cuda") * 0.02
        gm = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
        bt = 0.1 * torch.randn(C, generator=gen, device="cuda")
        line("K8 ln_matmul", (x.shape[0], C, O), lambda: ops.ln_matmul(x, w, b, gm, bt, 1e-6, act))
    del x
    for B, N, Hx, Dx in ((3, 17, H, D), (3, 200, H, D), (3, 512, H, D), (3, 129, 8, 96),
                         (3, 129, H, 32)):
        qkv, g = randn(B, N, 3 * Hx * Dx), randn(B, N, Hx * Dx)
        line("K4 attention_qkv_bwd", qkv.shape,
             lambda: ops.attention_qkv_bwd(qkv, g, Hx, Dx ** -0.5))
        if args.save:
            saved[f"K4 dqkv {list(qkv.shape)}"] = ops.attention_qkv_bwd(qkv, g, Hx,
                                                                        Dx ** -0.5).cpu()
    k3_shapes = [(3, 88, H, D), (1, 264, H, D)]
    k3_shapes += [(3, N, H, D) for N in (1, 15, 16, 17, 144, 145, 200, 512)]
    k3_shapes += [(3, 264, H, 32), (3, 264, 8, 96), (3, 264, 6, 128)]
    for B, N, Hx, Dx in k3_shapes:
        qkv, m = randn(B, N, 3 * Hx * Dx), mask(B, N, 88)
        line("K3 masked_attention_qkv", qkv.shape,
             lambda: ops.masked_attention_qkv(qkv, m, Hx, Dx ** -0.5, FILL))
        if args.save:
            saved[f"K3 out {list(qkv.shape)}"] = ops.masked_attention_qkv(qkv, m, Hx, Dx ** -0.5,
                                                                          FILL).cpu()
    del qkv, m
    q, k, v = (randn(384, 129, C) for _ in range(3))
    probs = torch.empty(384, H, 129, 129, dtype=bf, device="cuda")
    line("T1 headgrid_attn", q.shape,
         lambda: (bench_attn.headgrid_attn(q, k, v, H, SCALE, 1, 2, probs)[0], probs))
    if args.save:
        out, _ = bench_attn.headgrid_attn(q, k, v, H, SCALE, 1, 2, probs)
        saved.update({"T1 out": out.cpu(), "T1 probs": probs.cpu()})
    del q, k, v, probs
    qkv = randn(384, 129, 3 * C)
    line("T2 nomax_attn", qkv.shape, lambda: bench_attn2.nomax_attn(qkv, H, SCALE, 1))
    if args.save:
        saved["T2 out"] = bench_attn2.nomax_attn(qkv, H, SCALE, 1).cpu()
    del qkv
    t6 = bench_full_kernel
    old_t6 = "warps" in inspect.signature(t6.masked_full).parameters
    for B, N in ((384, 88), (128, 264)):
        qkv, m, g = randn(B, N, 3 * C), mask(B, N, 88), randn(B, N, C)
        if old_t6:  # the 8-warp CUDA-core bodies
            fwd = lambda: t6.masked_full(qkv, m, H, SCALE, warps=8)  # noqa: E731
            bwd = lambda: t6.masked_full_bwd(qkv, m, g, H, SCALE, warps=8)  # noqa: E731
        else:
            gf, gb = t6.full_group(N, B), t6.full_group(N, B, bwd=True)
            fwd = lambda: t6.masked_full(qkv, m, H, SCALE, gf)  # noqa: E731
            bwd = lambda: t6.masked_full_bwd(qkv, m, g, H, SCALE, gb)  # noqa: E731
        line("T6 masked_full", qkv.shape, fwd)
        line("T6 masked_full_bwd", qkv.shape, bwd)
        if args.save:
            saved[f"T6 out [{B}, {N}]"] = fwd().cpu()
            saved[f"T6 dqkv [{B}, {N}]"] = bwd().cpu()
    del qkv, m, g
    ins = bench_attn_layer.layer_inputs(gen)
    probs = torch.empty(384, H, 129, 129, dtype=bf, device="cuda")
    for g in (1, 2, 4):
        line(f"T3 attn_layer g={g} probs", ins[0].shape,
             lambda: bench_attn_layer.attn_layer(*ins, H, SCALE, 1e-6, g, probs))
        line(f"T3 attn_layer g={g}", ins[0].shape,
             lambda: bench_attn_layer.attn_layer(*ins, H, SCALE, 1e-6, g)[0])
    if args.save:
        out, _ = bench_attn_layer.attn_layer(*ins, H, SCALE, 1e-6, 1, probs)
        saved.update({"T3 out": out.cpu(), "T3 probs": probs.cpu()})
        torch.save(saved, args.save)


if __name__ == "__main__":
    main()
