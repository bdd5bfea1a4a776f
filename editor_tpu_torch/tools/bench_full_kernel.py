"""T6: the group sweep of the compact tail's masked attention (K3) and its
VJP (K5) on one CUDA device.

    python3 -m editor_tpu_torch.tools.bench_full_kernel [--iters 20]

Counterpart of ``tools/bench_full_kernel.py``, which runs the TPU kernel
bodies of K3 and K5 (``_qkv_masked_full_kernel``,
``_qkv_masked_full_bwd_kernel``) at other group sizes g (sequences per grid
step): 4, 8, 16 and 32 at [384, 88], 1, 2 and 4 at [128, 264]. On the H100
the same knob is the sequences a block walks: :func:`masked_full` and
:func:`masked_full_bwd` launch K3 and K5 with ``group=g``, their
tensor-core kernels (K3 the masked instance of K1's forward,
``csrc/attention_fwd_mma.cuh``; K5 the instance without cls keys of the
backward K4 and K7 share, ``csrc/attention_bwd_mma.cuh``) with each block
walking g (head, sequence) pairs one after another, each computed as K3's or
K5's own block computes it, so the output is K3's or K5's at ``group=0``
bit for bit. Their launches are counted where K3 and K5 launch: at group 0
in ``launches``, at any other in ``variant_launches`` of
``ops.masked_attention_qkv`` and ``ops.masked_attention_qkv_bwd``. At the
flagship eval batch (B = 128: 384 sequences of N = 88 per modality, 128 of
N = 264 joint; random-normal bf16 qkv and cotangent, mask rand < 0.8, seed
0) the tool prints K3 (K5) at group 0, then for each g its ms from CUDA
events, ``equal_to_group0``, its relative error against the plain version
and the bound (the least time the card could take: forward 4 H D flops a
valid pair against qkv + out, backward 10 H D against qkv + g + dqkv, both
read once and written once, over the valid pairs of this mask); then the
plain versions and SDPA (forward with a key mask; backward as (forward +
backward) - forward). :func:`full_group` is the JAX package's own choice of
g (``_full_group``). The card's name and power limit come first. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from editor_tpu_torch import ops
from editor_tpu_torch.ops.masked_attention import MASK_FILL
from editor_tpu_torch.tools import _bench

H, C = 12, 768
D = C // H
SCALE = D ** -0.5
# the JAX tool's shapes and groups
SWEEP = (((384, 88), (4, 8, 16, 32)), ((128, 264), (1, 2, 4)))

# the plain versions in the TPU bodies' forms, which the JAX script runs
# (the fill added, every exp rounded, lazy normalisation)
masked_full_plain = ops.masked_attention_qkv_tpu_plain
masked_full_bwd_plain = ops.masked_attention_qkv_bwd_plain


def full_group(N: int, B: int, bwd: bool = False) -> int:
    """The sequences a grid step the JAX package's K3 and K5 take
    (``editor_tpu/ops/masked_attention.py::_full_group``): forward 8 up to
    128 tokens, 2 up to 320, else 1; backward 4 up to 128, else 2; halved
    until g divides B."""
    if bwd:
        g = 4 if N <= 128 else 2
    else:
        g = 8 if N <= 128 else (2 if N <= 320 else 1)
    while B % g:
        g //= 2
    return max(g, 1)


def _check_g(g: int) -> None:
    if g < 1:
        raise ValueError(f"g = {g}: T6 walks at least one sequence a block "
                         "(group 0 is K3's and K5's own launch)")


def masked_full(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int, scale: float,
                g: int, mask_fill: float = MASK_FILL) -> torch.Tensor:
    """T6 forward: K3 (``ops.masked_attention_qkv``) walking ``g`` >= 1
    sequences a block. CUDA: ``csrc/masked_attention.cu``; CPU:
    :data:`masked_full_plain` (K3's own CPU path is the model's XLA form)."""
    _check_g(g)
    if qkv.device.type == "cpu":
        return masked_full_plain(qkv, mask, num_heads, scale, mask_fill)
    return ops.masked_attention_qkv(qkv, mask, num_heads, scale, mask_fill, group=g)


def masked_full_bwd(qkv: torch.Tensor, mask: torch.Tensor, g_out: torch.Tensor,
                    num_heads: int, scale: float, g: int,
                    mask_fill: float = MASK_FILL) -> torch.Tensor:
    """T6 backward: K5 (``ops.masked_attention_qkv_bwd``) walking ``g`` >= 1
    sequences a block. CUDA: ``csrc/masked_attention_bwd.cu``; CPU:
    :data:`masked_full_bwd_plain`."""
    _check_g(g)
    return ops.masked_attention_qkv_bwd(qkv, mask, g_out, num_heads, scale, mask_fill,
                                        group=g)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    _bench.start("bench_full_kernel")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (B, N), groups in SWEEP:
        qkv = torch.randn(B, N, 3 * C, generator=gen, device="cuda").to(torch.bfloat16)
        m = (torch.rand(B, N, generator=gen, device="cuda") < 0.8).float()
        g_out = torch.randn(B, N, C, generator=gen, device="cuda").to(torch.bfloat16)
        pairs = float((m.sum(1) ** 2).sum())  # the work this mask needs
        heads = [t.view(B, N, H, D).transpose(1, 2) for t in qkv.split(C, -1)]
        keys = m.bool()[:, None, None, :]

        ref = masked_full_plain(qkv, m, H, SCALE)
        base = ops.masked_attention_qkv(qkv, m, H, SCALE)
        bnd = _bench.bound(4.0 * H * D * pairs, 2.0 * B * N * 4 * C + 4.0 * B * N)
        ms = _bench.cuda_ms(lambda: ops.masked_attention_qkv(qkv, m, H, SCALE), args.iters)
        _bench.report(f"fwd B={B} N={N} K3 group=0", ms, _bench.rel_err(base, ref), bnd)
        for g in groups:
            out = masked_full(qkv, m, H, SCALE, g)
            ms = _bench.cuda_ms(lambda: masked_full(qkv, m, H, SCALE, g), args.iters)
            _bench.report(f"fwd B={B} N={N} g={g}", ms, _bench.rel_err(out, ref), bnd,
                          equal_to_group0=bool(torch.equal(out, base)),
                          jax_group=g == full_group(N, B))
        ms = _bench.cuda_ms(lambda: masked_full_plain(qkv, m, H, SCALE), args.iters)
        _bench.report(f"fwd B={B} N={N} plain", ms, _bench.rel_err(ref, base))
        ms = _bench.cuda_ms(lambda: F.scaled_dot_product_attention(*heads, attn_mask=keys,
                                                                   scale=SCALE), args.iters)
        _bench.report(f"fwd B={B} N={N} library SDPA (key mask)", ms)

        ref = masked_full_bwd_plain(qkv, m, g_out, H, SCALE)
        base = ops.masked_attention_qkv_bwd(qkv, m, g_out, H, SCALE)
        # reads qkv, g and the mask, writes dqkv; logits, dat, dq, dk, dv
        bnd = _bench.bound(10.0 * H * D * pairs, 2.0 * B * N * 7 * C + 4.0 * B * N)
        ms = _bench.cuda_ms(lambda: ops.masked_attention_qkv_bwd(qkv, m, g_out, H, SCALE),
                            args.iters)
        _bench.report(f"bwd B={B} N={N} K5 group=0", ms, _bench.rel_err(base, ref), bnd)
        for g in groups:
            out = masked_full_bwd(qkv, m, g_out, H, SCALE, g)
            ms = _bench.cuda_ms(lambda: masked_full_bwd(qkv, m, g_out, H, SCALE, g),
                                args.iters)
            _bench.report(f"bwd B={B} N={N} g={g}", ms, _bench.rel_err(out, ref), bnd,
                          equal_to_group0=bool(torch.equal(out, base)),
                          jax_group=g == full_group(N, B, bwd=True))
        ms = _bench.cuda_ms(lambda: masked_full_bwd_plain(qkv, m, g_out, H, SCALE), args.iters)
        _bench.report(f"bwd B={B} N={N} plain", ms, _bench.rel_err(ref, base))
        ms = sdpa_bwd_ms(heads, g_out, keys, args.iters)
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
