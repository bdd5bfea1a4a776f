"""T2: K1 without the row max, and K6's block shape, on one CUDA device.

    python3 -m editor_tpu_torch.tools.bench_attn2 [--iters 20]

Counterpart of ``tools/bench_attn2.py``. Its TPU kernel ``nomax_attn``
(``_kernel_nomax``) is K1's attention with the exps of the raw logits: no row
max, so it is valid only while |logit| < ~80 (random-normal inputs, as in the
JAX script; the ×30 stress of chip_smoke's K1 check would overflow it).
:func:`nomax_attn` launches ``editor_attention_nomax``
(``csrc/attention_variants.cu``): K1's tensor-core body in its ``kNoMax``
form on the packed qkv, each block walking ``g`` sequences one after
another. The tool prints at [384, 129, 2304] (seed 0) the shipped K1 without
probs, T2 at g in (1, 2, 4) with its relative error against K1 and its plain
version and its share of elements more than one bf16 ulp off the plain
version, K1 again, and SDPA; then the JAX
script's second half: the uncompacted tail's masked attention K6 at
[128, 387] (three tiles) at groups 1 and 2 and [384, 129] (one tile) at 4
and 8, as the TPU script sweeps ``_pallas_masked_from_qkv(group=g)``: the
tensor-core kernel with each block walking g sequences, beside K6's own
launch (group 0), with ``equal_to_group0`` (each pair is computed as K6's
block computes it: equal bit for bit). The card's name and power limit come
first. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from editor_tpu_torch.ops._checks import check_kernel_tensor
from editor_tpu_torch.ops.fused_attention import check_k1_head_dim
from editor_tpu_torch.tools import _bench
from editor_tpu_torch.tools.bench_attn import (SCALE, B, C, D, H, N, attention_bytes,
                                               split_softmax_av_plain)


def nomax_attn_plain(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """T2's function, the math of ``_kernel_nomax``: qkv [B, N, 3C] -> out
    [B, N, C] in qkv.dtype, softmax without the row max."""
    Bq, Nq, C3 = qkv.shape
    Dq = C3 // 3 // num_heads
    q, k, v = qkv.reshape(Bq, Nq, 3, num_heads, Dq).permute(2, 0, 3, 1, 4)
    out, _ = split_softmax_av_plain(q, k, v, scale, nomax=True)
    return out.to(qkv.dtype).transpose(1, 2).reshape(Bq, Nq, C3 // 3)


def nomax_attn(qkv: torch.Tensor, num_heads: int, scale: float, g: int = 1) -> torch.Tensor:
    """T2: attention from the packed qkv [B, N, 3C] without the row max, ``g``
    sequences per block -> [B, N, C]. CUDA: ``csrc/attention_variants.cu``
    (bf16, contiguous, 16-byte aligned, a head dim K1 takes); CPU:
    :func:`nomax_attn_plain`."""
    Bq, Nq, C3 = qkv.shape
    if C3 % (3 * num_heads) or g < 1:
        raise ValueError(f"qkv width {C3}, {num_heads} heads, {g} sequences per block")
    if qkv.device.type == "cpu":
        return nomax_attn_plain(qkv, num_heads, scale)
    from editor_tpu_torch.ops import _build

    Dq = C3 // 3 // num_heads
    check_k1_head_dim(Dq)
    check_kernel_tensor("nomax_attn qkv", qkv, 3, Dq, Nq, align=16)
    out = torch.empty((Bq, Nq, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    code = _build.library().editor_attention_nomax(
        qkv.data_ptr(), out.data_ptr(), Bq, Nq, num_heads, Dq, float(scale), g,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(code, "nomax_attn")
    nomax_attn.launches += 1
    return out


nomax_attn.launches = 0


def main(argv=None) -> None:
    from editor_tpu_torch import ops
    from editor_tpu_torch.ops.masked_attention import MASK_FILL

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    _bench.start("bench_attn2")
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(B, N, 3 * C, generator=gen, device="cuda").to(torch.bfloat16)
    want, _ = ops.attention_qkv(qkv, H, SCALE)
    bnd = _bench.bound(4.0 * B * H * N * N * D, attention_bytes(False))
    k1 = lambda: ops.attention_qkv(qkv, H, SCALE)  # noqa: E731
    _bench.report("K1 attention_qkv probs=0 (shipped)", _bench.cuda_ms(k1, args.iters), 0.0, bnd)
    ref = nomax_attn_plain(qkv, H, SCALE)
    for g in (1, 2, 4):
        out = nomax_attn(qkv, H, SCALE, g)
        ms = _bench.cuda_ms(lambda: nomax_attn(qkv, H, SCALE, g), args.iters)
        _bench.report(f"nomax g={g}", ms, _bench.rel_err(out, want), bnd,
                      relerr_vs_plain=f"{_bench.rel_err(out, ref):.2e}",
                      share_off_plain=f"{_bench.bf16_off_share(out, ref):.2e}")
    _bench.report("K1 attention_qkv probs=0 (shipped, again)", _bench.cuda_ms(k1, args.iters),
                  0.0, bnd)
    ms = _bench.cuda_ms(lambda: nomax_attn_plain(qkv, H, SCALE), args.iters)
    _bench.report("plain nomax_attn_plain", ms, _bench.rel_err(ref, want))
    heads = [t.view(B, N, H, D).transpose(1, 2) for t in qkv.split(C, -1)]
    ms = _bench.cuda_ms(lambda: F.scaled_dot_product_attention(*heads, scale=SCALE), args.iters)
    _bench.report("library SDPA", ms)

    # the tail: K6 over the JAX script's groups, masks as the JAX script's
    tile, B2 = 129, 128
    mask = torch.rand(B2, tile, generator=gen, device="cuda") > 0.5
    mask[:, 0] = True
    for name, Bm, m, groups in (("joint N=387", B2, mask.repeat(1, 3), (1, 2)),
                                ("modal N=129", 3 * B2, mask.repeat(3, 1), (4, 8))):
        m = m.float()
        Nm = m.shape[1]
        x = torch.randn(Bm, Nm, 3 * C, generator=gen, device="cuda").to(torch.bfloat16)
        base = ops.masked_attention_tiled(x, m, H, SCALE, MASK_FILL, tile)
        pairs = float((m.sum(1) ** 2).sum())
        b6 = _bench.bound(4.0 * H * D * pairs, 2.0 * Bm * Nm * 4 * C + 4.0 * Bm * Nm)
        ms = _bench.cuda_ms(lambda: ops.masked_attention_tiled(x, m, H, SCALE, MASK_FILL, tile),
                            args.iters)
        _bench.report(f"K6 {name} group=0", ms, 0.0, b6)
        for g in groups:
            out = ops.masked_attention_tiled(x, m, H, SCALE, MASK_FILL, tile, group=g)
            ms = _bench.cuda_ms(lambda: ops.masked_attention_tiled(x, m, H, SCALE, MASK_FILL,
                                                                   tile, group=g), args.iters)
            _bench.report(f"K6 {name} g={g}", ms, _bench.rel_err(out, base), b6,
                          equal_to_group0=bool(torch.equal(out, base)))


if __name__ == "__main__":
    main()
