"""T6: the block-shape sweep of the compact tail's masked attention (K3) and
its VJP (K5) on one CUDA device.

    python3 -m editor_tpu_torch.tools.bench_full_kernel [--iters 20]

Counterpart of ``tools/bench_full_kernel.py``, which runs the TPU kernel
bodies of K3 and K5 (``_qkv_masked_full_kernel``,
``_qkv_masked_full_bwd_kernel``) at other group sizes g (sequences per grid
step). On the H100 the block-shape knob of the CUDA-core bodies of K3 and
K5 is the warps per block (``FWD_WARPS`` and ``BWD_WARPS`` of
``ops.masked_attention``; the model paths launch 4): :func:`masked_full` and
:func:`masked_full_bwd` launch K3 and K5 with it. At 4 warps both are their
tensor-core kernels (K3 the masked instance of K1's forward,
``csrc/attention_fwd_mma.cuh``; K5 the instance without cls keys of the
backward K4 and K7 share, ``csrc/attention_bwd_mma.cuh``); at 8 and 16 warps
K3, and at 8 warps K5, are the CUDA-core bodies (``csrc/masked_attention.cu``,
``csrc/attention_bwd.cuh``) that T6 sweeps. Their launches are counted
where K3 and K5 launch: at 4 warps in ``launches``, at any other in
``variant_launches`` of ``ops.masked_attention_qkv`` and
``ops.masked_attention_qkv_bwd``. At the flagship eval batch (B = 128: 384
sequences of N = 88 per modality, 128 of N = 264 joint; random-normal bf16
qkv and cotangent, mask rand < 0.8, seed 0) the tool prints for each warp
count the ms from CUDA events, the relative error against the shipped 4-warp
launch and the plain version, the share of elements more than one bf16 ulp
off the 4-warp kernel (the two round at the same points, so it is near 0),
and the bound (the least time the card could take: forward 4 H D flops a
valid pair against qkv + out, backward 10 H D against qkv + g + dqkv, both
read once and written once, over the valid pairs of this mask); then the
plain versions and SDPA (forward with a key mask; backward as (forward +
backward) - forward). The card's name and power limit come first. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from editor_tpu_torch import ops
from editor_tpu_torch.ops.masked_attention import BWD_WARPS, FWD_WARPS, MASK_FILL
from editor_tpu_torch.tools import _bench

H, C = 12, 768
D = C // H
SCALE = D ** -0.5
SHAPES = ((384, 88), (128, 264))

# the plain versions in the TPU bodies' forms, which the JAX script runs
# (the fill added, every exp rounded, lazy normalisation)
masked_full_plain = ops.masked_attention_qkv_tpu_plain
masked_full_bwd_plain = ops.masked_attention_qkv_bwd_plain


def masked_full(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int, scale: float,
                warps: int = 8, mask_fill: float = MASK_FILL) -> torch.Tensor:
    """T6 forward: K3 (``ops.masked_attention_qkv``) with ``warps`` warps per
    block. CUDA: ``csrc/masked_attention.cu``; CPU: :data:`masked_full_plain`
    (K3's own CPU path is the model's XLA form)."""
    if warps not in FWD_WARPS:
        raise ValueError(f"warps per block {warps} not in {FWD_WARPS}")
    if qkv.device.type == "cpu":
        return masked_full_plain(qkv, mask, num_heads, scale, mask_fill)
    return ops.masked_attention_qkv(qkv, mask, num_heads, scale, mask_fill, warps=warps)


def masked_full_bwd(qkv: torch.Tensor, mask: torch.Tensor, g: torch.Tensor, num_heads: int,
                    scale: float, warps: int = 8, mask_fill: float = MASK_FILL) -> torch.Tensor:
    """T6 backward: K5 (``ops.masked_attention_qkv_bwd``) with ``warps`` warps
    per block. CUDA: ``csrc/masked_attention_bwd.cu``; CPU:
    :data:`masked_full_bwd_plain`."""
    return ops.masked_attention_qkv_bwd(qkv, mask, g, num_heads, scale, mask_fill,
                                        warps=warps)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    _bench.start("bench_full_kernel")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, N in SHAPES:
        qkv = torch.randn(B, N, 3 * C, generator=gen, device="cuda").to(torch.bfloat16)
        m = (torch.rand(B, N, generator=gen, device="cuda") < 0.8).float()
        g = torch.randn(B, N, C, generator=gen, device="cuda").to(torch.bfloat16)
        pairs = float((m.sum(1) ** 2).sum())  # the work this mask needs
        heads = [t.view(B, N, H, D).transpose(1, 2) for t in qkv.split(C, -1)]
        keys = m.bool()[:, None, None, :]

        ref = masked_full_plain(qkv, m, H, SCALE)
        base = masked_full(qkv, m, H, SCALE, 4)
        bnd = _bench.bound(4.0 * H * D * pairs, 2.0 * B * N * 4 * C + 4.0 * B * N)
        for w in FWD_WARPS:
            out = masked_full(qkv, m, H, SCALE, w)
            ms = _bench.cuda_ms(lambda: masked_full(qkv, m, H, SCALE, w), args.iters)
            _bench.report(f"fwd B={B} N={N} warps={w}", ms, _bench.rel_err(out, base), bnd,
                          relerr_vs_plain=f"{_bench.rel_err(out, ref):.2e}",
                          share_off_4_warps=f"{_bench.bf16_off_share(out, base):.2e}")
        ms = _bench.cuda_ms(lambda: masked_full_plain(qkv, m, H, SCALE), args.iters)
        _bench.report(f"fwd B={B} N={N} plain", ms, _bench.rel_err(ref, base))
        ms = _bench.cuda_ms(lambda: F.scaled_dot_product_attention(*heads, attn_mask=keys,
                                                                   scale=SCALE), args.iters)
        _bench.report(f"fwd B={B} N={N} library SDPA (key mask)", ms)

        ref = masked_full_bwd_plain(qkv, m, g, H, SCALE)
        base = masked_full_bwd(qkv, m, g, H, SCALE, 4)
        # reads qkv, g and the mask, writes dqkv; logits, dat, dq, dk, dv
        bnd = _bench.bound(10.0 * H * D * pairs, 2.0 * B * N * 7 * C + 4.0 * B * N)
        for w in BWD_WARPS:
            out = masked_full_bwd(qkv, m, g, H, SCALE, w)
            ms = _bench.cuda_ms(lambda: masked_full_bwd(qkv, m, g, H, SCALE, w), args.iters)
            _bench.report(f"bwd B={B} N={N} warps={w}", ms, _bench.rel_err(out, base), bnd,
                          relerr_vs_plain=f"{_bench.rel_err(out, ref):.2e}",
                          share_off_4_warps=f"{_bench.bf16_off_share(out, base):.2e}")
        ms = _bench.cuda_ms(lambda: masked_full_bwd_plain(qkv, m, g, H, SCALE), args.iters)
        _bench.report(f"bwd B={B} N={N} plain", ms, _bench.rel_err(ref, base))
        ms = sdpa_bwd_ms(heads, g, keys, args.iters)
        _bench.report(f"bwd B={B} N={N} library SDPA bwd (key mask)", ms)


def sdpa_bwd_ms(heads, g: torch.Tensor, keys, iters: int) -> float:
    """The backward of one scaled_dot_product_attention call on contiguous
    head tensors, timed as (forward + backward) - forward."""
    q, k, v = (t.contiguous().requires_grad_() for t in heads)
    gh = g.view(*g.shape[:2], H, D).transpose(1, 2).contiguous()

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=keys, scale=SCALE)

    both = _bench.cuda_ms(lambda: torch.autograd.grad(fwd(), (q, k, v), gh), iters)
    return both - _bench.cuda_ms(fwd, iters)


if __name__ == "__main__":
    main()
