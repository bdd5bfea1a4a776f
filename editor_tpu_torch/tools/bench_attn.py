"""T1: attention (K1's function) at other block shapes, from separate q, k
and v, on one CUDA device.

    python3 -m editor_tpu_torch.tools.bench_attn [--iters 20]

Counterpart of ``tools/bench_attn.py``, whose TPU kernel ``headgrid_attn``
reads q, k and v as separate arrays on a (sequence group, head) grid, with g
sequences and 1 or 2 heads per step. Here :func:`headgrid_attn` launches
``editor_attention_split`` (``csrc/attention_variants.cu``): K1's tensor-core
body in its ``kSplit`` form, q, k and v read as three row-strided tensors
(separate [B, N, C] copies, or the column views ``qkv.split(C, -1)`` of the
packed projection with no copy), each block walking ``hps`` heads of ``g``
sequences one pair after another. At the flagship shape (B = 384, N = 129,
C = 768, H = 12, random-normal bf16 qkv, seed 0) it prints, for probs off
and on, each layout, hps in (1, 2) and g in (1, 2, 4, 8): ms from CUDA
events, the relative error against the shipped K1 and the share of elements
more than one bf16 ulp off it (both round alike: 0 expected), and the bound;
each set beside K1 itself; then the plain version and SDPA. The card's name
and power limit come first. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch
import torch.nn.functional as F

from editor_tpu_torch.ops._checks import (check_kernel_tensor, check_probs_out,
                                          check_rows_tensor, compute_dtype)
from editor_tpu_torch.ops.fused_attention import check_k1_head_dim
from editor_tpu_torch.tools import _bench

B, N, C, H = 384, 129, 768, 12
D = C // H
SCALE = D ** -0.5


def split_softmax_av_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                           nomax: bool = False, dtype: Optional[torch.dtype] = None,
                           cls_fp32: bool = True):
    """The attention of the TPU variant bodies (``_split_softmax_av``, and
    ``_kernel_nomax`` with ``nomax``): q, k, v [..., N, D] -> (out [..., N, D],
    probs [..., N, N]), both in at least fp32. Logits, exp and sum in at
    least fp32; ``nomax`` drops the row max (exp of the raw logits, valid
    while |logit| < ~80); the patch keys' (m >= 1) probabilities are rounded
    to ``dtype`` (default q.dtype) before p.v, the cls key's (m = 0) is not
    (without ``cls_fp32`` it is too: a wrong form)."""
    cd = compute_dtype(q.dtype)
    logits = torch.matmul(q.to(cd), k.to(cd).transpose(-1, -2)) * scale
    e = torch.exp(logits if nomax else logits - logits.amax(-1, keepdim=True))
    p = e * (1.0 / e.sum(-1, keepdim=True))
    pr = p.to(dtype or q.dtype).to(cd)
    if cls_fp32:
        pr = torch.where(torch.arange(q.shape[-2], device=q.device) == 0, p, pr)
    return torch.matmul(pr, v.to(cd)), p


def cls_heavy(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """A copy of qkv [B, N, 3C] (rounded to bf16 by the caller) whose cls key
    carries most of each row's weight: every q component raised by 1 and
    k_0 = 7 / sqrt(D) in every component (at scale D^-0.5 its logit is ~7
    against ~N(0, 2) for the patch keys: p_0 ~ 0.6-0.75), and v_0 scaled by
    0.1, so that p_0 v_0 is about the size of the patch keys' sum. On these
    inputs rounding p_0 to bf16 moves ~3-4% of the outputs by more than one
    bf16 ulp; on random-normal ones (p_0 ~ 1/N) about 0.5%."""
    C = qkv.shape[-1] // 3
    D = C // num_heads
    x = qkv.clone()
    x[..., :C] += 1.0
    x[:, 0, C:2 * C] = 7.0 / D ** 0.5
    x[:, 0, 2 * C:] *= 0.1
    return x


def headgrid_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                        scale: float, with_probs: bool):
    """T1's function, the math of ``_headgrid_kernel``: q, k, v [B, N, C] ->
    out [B, N, C] (+ the full probs [B, H, N, N]) in q.dtype."""
    Bq, Nq, Cq = q.shape

    def heads(t):
        return t.reshape(Bq, Nq, num_heads, Cq // num_heads).transpose(1, 2)

    out, p = split_softmax_av_plain(heads(q), heads(k), heads(v), scale)
    out = out.to(q.dtype).transpose(1, 2).reshape(Bq, Nq, Cq)
    return (out, p.to(q.dtype)) if with_probs else out


def headgrid_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                  scale: float, g: int = 1, hps: int = 1, probs_out=None):
    """T1: attention from separate q, k, v [B, N, C] with ``hps`` (1 or 2)
    heads and ``g`` sequences per block; returns (out [B, N, C], probs_out).
    ``probs_out``: an optional [B, H, N, N] tensor that receives the
    post-softmax maps. CUDA: ``csrc/attention_variants.cu`` (bf16; a head dim
    K1 takes, and q, k and v each with unit element stride, a 16-byte aligned
    base and a row stride of a multiple of 16 bytes, e.g. the column views of
    a 16-byte aligned packed qkv); CPU: :func:`headgrid_attn_plain`."""
    Bq, Nq, Cq = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    if Cq % num_heads or hps not in (1, 2) or num_heads % hps or g < 1:
        raise ValueError(f"{Cq} columns, {num_heads} heads, {hps} heads and {g} "
                         "sequences per block do not fit")
    check_probs_out("headgrid_attn", probs_out, q, Bq, num_heads, Nq)
    if q.device.type == "cpu":
        if probs_out is None:
            return headgrid_attn_plain(q, k, v, num_heads, scale, False), None
        out, probs = headgrid_attn_plain(q, k, v, num_heads, scale, True)
        probs_out.copy_(probs)
        return out, probs_out
    from editor_tpu_torch.ops import _build

    Dq = Cq // num_heads
    check_k1_head_dim(Dq)
    # 16-byte cp.async copies of k's and v's rows
    lds = [check_rows_tensor(f"headgrid_attn {n}", t, Dq) for n, t in zip("qkv", (q, k, v))]
    if probs_out is not None:
        check_kernel_tensor("headgrid_attn probs_out", probs_out, 4)
    out = torch.empty((Bq, Nq, Cq), dtype=q.dtype, device=q.device)
    code = _build.library().editor_attention_split(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *lds, out.data_ptr(),
        probs_out.data_ptr() if probs_out is not None else None, Bq, Nq, num_heads, Dq,
        float(scale), hps, g, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "headgrid_attn")
    headgrid_attn.launches += 1
    return out, probs_out


headgrid_attn.launches = 0


def attention_bytes(with_probs: bool) -> float:
    """Bytes K1's function must move at the flagship shape: q, k, v read
    once, out (and the maps) written once."""
    return 2.0 * (B * N * 3 * C + B * N * C + (B * H * N * N if with_probs else 0))


def main(argv=None) -> None:
    from editor_tpu_torch import ops

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    _bench.start("bench_attn")
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(B, N, 3 * C, generator=gen, device="cuda").to(torch.bfloat16)
    views = qkv.split(C, -1)
    layouts = {"separate": [t.contiguous() for t in views], "views": views}
    want, _ = ops.attention_qkv(qkv, H, SCALE)
    flops = 4.0 * B * H * N * N * D
    probs = torch.empty(B, H, N, N, dtype=qkv.dtype, device="cuda")
    for wp in (False, True):
        po = probs if wp else None
        bnd = _bench.bound(flops, attention_bytes(wp))
        k1 = lambda: ops.attention_qkv(qkv, H, SCALE, probs_out=po)  # noqa: E731
        _bench.report(f"K1 attention_qkv probs={int(wp)} (shipped)",
                      _bench.cuda_ms(k1, args.iters), 0.0, bnd)
        for layout, (q, k, v) in layouts.items():
            for hps in (1, 2):
                for g in (1, 2, 4, 8):
                    out, _ = headgrid_attn(q, k, v, H, SCALE, g, hps, po)
                    ms = _bench.cuda_ms(lambda: headgrid_attn(q, k, v, H, SCALE, g, hps, po),
                                        args.iters)
                    _bench.report(f"headgrid probs={int(wp)} {layout:8s} hps={hps} g={g}", ms,
                                  _bench.rel_err(out, want), bnd,
                                  share_off_k1=f"{_bench.bf16_off_share(out, want):.2e}")
        _bench.report(f"K1 attention_qkv probs={int(wp)} (shipped, again)",
                      _bench.cuda_ms(k1, args.iters), 0.0, bnd)
    q, k, v = layouts["separate"]
    ref = headgrid_attn_plain(q, k, v, H, SCALE, False)
    ms = _bench.cuda_ms(lambda: headgrid_attn_plain(q, k, v, H, SCALE, True), args.iters)
    _bench.report("plain headgrid_attn_plain probs=1", ms, _bench.rel_err(ref, want))
    heads = [t.view(B, N, H, D).transpose(1, 2) for t in views]
    ms = _bench.cuda_ms(lambda: F.scaled_dot_product_attention(*heads, scale=SCALE), args.iters)
    _bench.report("library SDPA (no probs)", ms)


if __name__ == "__main__":
    main()
