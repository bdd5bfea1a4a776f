"""T4: the rollout chain (K2's function) with other operand rounding,
reduction order and pairs per block, on one CUDA device.

    python3 -m editor_tpu_torch.tools.bench_rollout [--iters 20]

Counterpart of ``tools/bench_rollout.py``, whose TPU kernel ``chain``
(``variant_kernel``) computes K2's chain three ways (``how``) with g (b, h)
pairs per grid step. :func:`chain` launches the variant entry of
``csrc/rollout_chain.cu``:

* ``f32`` (the TPU's ``f32dot``, K2's math): fp32 products, one thread per
  column;
* ``bf16`` (``bf16dot``): v[n >= 1] rounded to bf16 before each patch
  column's product, v[0] and the cls column fp32;
* ``rows`` (``vpu``): f32's math, each warp summing a slice of the rows and a
  block reduction over the warps;

with ``g`` pairs per block. The maps are the port's full [L, B, H, N, N]
(the TPU's split pp/pc layout existed for lane padding); the tool builds
them as ``cat(pc, pp)`` of uniform random pp [L, B, H, N, N-1] and pc
[L, B, H, N], as the JAX script builds its reference, at L = 12, B = 128,
H = 12, N = 129 (seed 0). It prints for each variant and g the ms from CUDA
events, the relative error against the fp32 plain chain, and the bound, with
the relative error against the variant's own plain version and the share of
outputs more than 8 fp32 ulps off it (``_bench.mismatch_share``: near 0 where
both round at the same points); then K2 and the plain versions. The card's name and power limit come first.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse

import torch

from editor_tpu_torch.ops._checks import check_kernel_tensor, compute_dtype
from editor_tpu_torch.ops.rollout import rollout_from_probs_plain
from editor_tpu_torch.tools import _bench

HOWS = ("f32", "bf16", "rows")
PAIRS = (1, 2, 4)
L, B, H, N = 12, 128, 12, 129


@torch.no_grad()
def chain_plain(probs: torch.Tensor, how: str = "bf16") -> torch.Tensor:
    """T4's function, the math of ``variant_kernel``: probs [L, B, H, N, N]
    -> the [B, H, N-1] patch part of the rollout cls row, in at least fp32.
    ``bf16``: each step's patch columns take v[n >= 1] rounded to bf16 (the
    TPU's bf16 matrix operand), the cls column and v[0] stay unrounded;
    ``f32`` and ``rows``: K2's plain chain."""
    if how not in HOWS:
        raise ValueError(f"how must be one of {HOWS}, got {how!r}")
    if how != "bf16":
        return rollout_from_probs_plain(probs)
    cd = compute_dtype(probs.dtype)
    v = probs[-1][..., 0, :].to(cd)
    for a in reversed(probs[:-1]):
        a = a.to(cd)
        cls = torch.einsum("...n,...n->...", v, a[..., :, 0])
        vb = v[..., 1:].to(torch.bfloat16).to(cd)
        patch = v[..., :1] * a[..., 0, 1:] + torch.einsum("...n,...nm->...m", vb, a[..., 1:, 1:])
        v = torch.cat([cls[..., None], patch], dim=-1)
    return v[..., 1:]


def _check_chain_args(name: str, probs: torch.Tensor, g: int, pairs) -> int:
    if probs.dim() != 5 or probs.shape[-1] != probs.shape[-2]:
        raise ValueError(f"{name}: probs must be [L, B, H, N, N], got {tuple(probs.shape)}")
    if g not in pairs:
        raise ValueError(f"{name}: pairs per block {g} not in {pairs}")
    return probs.shape[-1]


@torch.no_grad()
def chain(probs: torch.Tensor, how: str = "bf16", g: int = 1) -> torch.Tensor:
    """T4: the rollout chain of probs [L, B, H, N, N] -> [B, H, N-1] fp32,
    computed as ``how`` (:data:`HOWS`) with ``g`` (:data:`PAIRS`) (b, h)
    pairs per block. CUDA: ``csrc/rollout_chain.cu`` (bf16, contiguous);
    CPU: :func:`chain_plain`."""
    Np = _check_chain_args("chain", probs, g, PAIRS)
    if how not in HOWS:
        raise ValueError(f"how must be one of {HOWS}, got {how!r}")
    if probs.device.type == "cpu":
        return chain_plain(probs, how)
    check_kernel_tensor("chain probs", probs, 5, tokens=Np)
    from editor_tpu_torch.ops import _build

    Lp, Bp, Hp = probs.shape[:3]
    out = torch.empty((Bp, Hp, Np - 1), dtype=torch.float32, device=probs.device)
    code = _build.library().editor_rollout_variant(
        probs.data_ptr(), out.data_ptr(), Lp, Bp * Hp, Np, HOWS.index(how), g,
        torch.cuda.current_stream(probs.device).cuda_stream)
    _build.check(code, "chain")
    chain.launches += 1
    return out


chain.launches = 0


def uniform_maps(gen: torch.Generator, shape=(L, B, H, N)) -> torch.Tensor:
    """cat(pc, pp) of uniform random pc [..., N] and pp [..., N, N-1] in bf16,
    the maps of the JAX scripts."""
    *lead, Nm = shape
    pp = torch.rand(*lead, Nm, Nm - 1, generator=gen, device="cuda").to(torch.bfloat16)
    pc = torch.rand(*lead, Nm, generator=gen, device="cuda").to(torch.bfloat16)
    return torch.cat([pc[..., None], pp], dim=-1)


def chain_bound(probs: torch.Tensor) -> tuple:
    """Every map read once, the fp32 rows written once; L - 1 vector-matrix
    products."""
    Lp, Bp, Hp, Np, _ = probs.shape
    Z = Bp * Hp
    return _bench.bound(2.0 * (Lp - 1) * Z * Np * Np, 2.0 * Lp * Z * Np * Np + 4.0 * Z * (Np - 1))


def main(argv=None) -> None:
    from editor_tpu_torch import ops

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    _bench.start("bench_rollout")
    gen = torch.Generator(device="cuda").manual_seed(0)
    probs = uniform_maps(gen)
    want = chain_plain(probs, "f32")
    plain = {how: chain_plain(probs, how) for how in HOWS}
    bnd = chain_bound(probs)
    for how in HOWS:
        for g in PAIRS:
            out = chain(probs, how, g)
            ms = _bench.cuda_ms(lambda: chain(probs, how, g), args.iters)
            _bench.report(f"{how:4s} g={g}", ms, _bench.rel_err(out, want), bnd,
                          relerr_vs_plain=f"{_bench.rel_err(out, plain[how]):.2e}",
                          mismatch_share=f"{_bench.mismatch_share(out, plain[how]):.4f}")
    out = ops.rollout_chain(probs)
    ms = _bench.cuda_ms(lambda: ops.rollout_chain(probs), args.iters)
    _bench.report("K2 rollout_chain (shipped)", ms, _bench.rel_err(out, want), bnd)
    for how in ("f32", "bf16"):
        ms = _bench.cuda_ms(lambda: chain_plain(probs, how), args.iters)
        _bench.report(f"plain chain_plain {how}", ms, _bench.rel_err(plain[how], want),
                      mismatch_share=f"{_bench.mismatch_share(plain[how], plain['bf16']):.4f}")


if __name__ == "__main__":
    main()
