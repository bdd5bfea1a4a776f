"""T5: the rollout chain with several maps in flight, and K1's block shape,
on one CUDA device.

    python3 -m editor_tpu_torch.tools.bench_rollout2 [--iters 20]

Counterpart of ``tools/bench_rollout2.py``, whose TPU kernel ``chain_multi``
(``multi_kernel``) steps T layers per grid step for g (b, h) pairs, with
T4's ``bf16dot`` rounding. On the H100 the counterpart of T layers per step
is T maps in flight: :func:`chain_multi` launches the multi entry of
``csrc/rollout_chain.cu``, where each block walks its g pairs' L maps through
a ring of T map slots in shared memory filled by ``cp.async`` (one [129, 129]
bf16 map is 33 KB, so T <= 6). At L = 12, B = 128, H = 12, N = 129 (uniform
random maps as the JAX script's, seed 0) it prints for T in (2, 3, 4, 6) and
g in (1, 2, 4) the ms from CUDA events, the relative error against the fp32
plain chain and the bound, with the relative error against
:func:`chain_multi_plain` and the share of outputs more than 8 fp32 ulps off
it; then K2. The second half is the JAX script's
probs-kernel sweep: K1's function at [384, 129, 2304] with and without the
probs, at other block shapes (1 or 2 heads and 1, 2 or 4 sequences per
block: :func:`~editor_tpu_torch.tools.bench_attn.headgrid_attn` on the column
views of the packed qkv), against the shipped K1. The card's name and power
limit come first. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse

import torch

from editor_tpu_torch.ops._checks import check_kernel_tensor
from editor_tpu_torch.tools import _bench
from editor_tpu_torch.tools.bench_rollout import (_check_chain_args, chain_bound, chain_plain,
                                                  uniform_maps)

MAPS_IN_FLIGHT = (2, 3, 4, 6)
PAIRS = (1, 2, 4)


def chain_multi_plain(probs: torch.Tensor) -> torch.Tensor:
    """T5's function, the math of ``multi_kernel``: T4's ``bf16`` chain
    (grouping the layers changes no sum)."""
    return chain_plain(probs, "bf16")


@torch.no_grad()
def chain_multi(probs: torch.Tensor, T: int = 4, g: int = 1) -> torch.Tensor:
    """T5: the ``bf16`` rollout chain of probs [L, B, H, N, N] -> [B, H, N-1]
    fp32 with T (:data:`MAPS_IN_FLIGHT`) maps in flight per block and g
    (b, h) pairs per block. CUDA: ``csrc/rollout_chain.cu`` (bf16,
    contiguous, 16-byte aligned); CPU: :func:`chain_multi_plain`."""
    Np = _check_chain_args("chain_multi", probs, g, PAIRS)
    if T not in MAPS_IN_FLIGHT:
        raise ValueError(f"chain_multi: maps in flight {T} not in {MAPS_IN_FLIGHT}")
    if probs.device.type == "cpu":
        return chain_multi_plain(probs)
    check_kernel_tensor("chain_multi probs", probs, 5, tokens=Np, align=16)
    from editor_tpu_torch.ops import _build

    Lp, Bp, Hp = probs.shape[:3]
    out = torch.empty((Bp, Hp, Np - 1), dtype=torch.float32, device=probs.device)
    code = _build.library().editor_rollout_multi(
        probs.data_ptr(), out.data_ptr(), Lp, Bp * Hp, Np, T, g,
        torch.cuda.current_stream(probs.device).cuda_stream)
    _build.check(code, "chain_multi")
    chain_multi.launches += 1
    return out


chain_multi.launches = 0


def main(argv=None) -> None:
    from editor_tpu_torch import ops
    from editor_tpu_torch.tools.bench_attn import (SCALE, B, C, D, H, N, attention_bytes,
                                                   headgrid_attn)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    _bench.start("bench_rollout2")
    gen = torch.Generator(device="cuda").manual_seed(0)
    probs = uniform_maps(gen)
    want = chain_plain(probs, "f32")
    plain = chain_multi_plain(probs)
    bnd = chain_bound(probs)
    for T in MAPS_IN_FLIGHT:
        for g in PAIRS:
            out = chain_multi(probs, T, g)
            ms = _bench.cuda_ms(lambda: chain_multi(probs, T, g), args.iters)
            _bench.report(f"multi T={T} g={g}", ms, _bench.rel_err(out, want), bnd,
                          relerr_vs_plain=f"{_bench.rel_err(out, plain):.2e}",
                          mismatch_share=f"{_bench.mismatch_share(out, plain):.4f}")
    ms = _bench.cuda_ms(lambda: ops.rollout_chain(probs), args.iters)
    _bench.report("K2 rollout_chain (shipped)", ms,
                  _bench.rel_err(ops.rollout_chain(probs), want), bnd)
    del probs

    # K1's function over its block shape, with and without the probs
    qkv = torch.randn(B, N, 3 * C, generator=gen, device="cuda").to(torch.bfloat16)
    views = qkv.split(C, -1)
    maps = torch.empty(B, H, N, N, dtype=qkv.dtype, device="cuda")
    want, _ = ops.attention_qkv(qkv, H, SCALE)
    flops = 4.0 * B * H * N * N * D
    for wp in (True, False):
        po = maps if wp else None
        b1 = _bench.bound(flops, attention_bytes(wp))
        ms = _bench.cuda_ms(lambda: ops.attention_qkv(qkv, H, SCALE, probs_out=po), args.iters)
        _bench.report(f"attn probs={int(wp)} K1 (shipped)", ms, 0.0, b1)
        for hps in (1, 2):
            for g in (1, 2, 4):
                out, _ = headgrid_attn(*views, H, SCALE, g, hps, po)
                ms = _bench.cuda_ms(lambda: headgrid_attn(*views, H, SCALE, g, hps, po),
                                    args.iters)
                _bench.report(f"attn probs={int(wp)} hps={hps} g={g}", ms,
                              _bench.rel_err(out, want), b1)


if __name__ == "__main__":
    main()
