"""T3: the attention half-layer, proj(attention(LN(x))), in one kernel, on
one CUDA device.

    python3 -m editor_tpu_torch.tools.bench_attn_layer [--iters 20]

Counterpart of ``tools/bench_attn_layer.py``, whose TPU kernel ``attn_layer``
(``_attn_layer_kernel``) runs LayerNorm, the qkv product, the attention and
the projection of g sequences per grid step with both weight matrices
resident. :func:`attn_layer` launches ``csrc/attn_layer.cu``: one block per
``g`` sequences, the weights streamed through shared memory (4.7 MB of bf16
weights cannot stay resident in a block's 227 KB). At B = 384, N = 129,
C = 768, H = 12 with the JAX script's inputs (x randn * 0.5, LayerNorm
weight rand + 0.5, bias randn * 0.1, weights randn * 0.03, biases randn *
0.02, all bf16, seed 0) the tool prints the composed port path
(``F.layer_norm`` -> ``F.linear`` -> K1 -> ``F.linear``) with and without
the probs, the same chain with SDPA in K1's place, then T3 at g in (1, 2, 4)
with and without the probs: ms from CUDA events, the relative error against
the composed path, and the bound; then the plain version. The card's name
and power limit come first. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from editor_tpu_torch.ops._checks import check_kernel_tensor, check_probs_out, compute_dtype
from editor_tpu_torch.tools import _bench
from editor_tpu_torch.tools.bench_attn import split_softmax_av_plain

B, N, C, H = 384, 129, 768, 12
D = C // H
SCALE = D ** -0.5
EPS = 1e-6


def attn_layer_plain(x: torch.Tensor, lnw: torch.Tensor, lnb: torch.Tensor,
                     wqkv: torch.Tensor, bqkv: torch.Tensor, wp: torch.Tensor,
                     bp: torch.Tensor, num_heads: int, scale: float, eps: float,
                     with_probs: bool):
    """T3's function with the rounding points of ``_attn_layer_kernel``: x
    [B, N, C] -> out [B, N, C] (+ the full probs [B, H, N, N]) in x.dtype.
    Weights stored in x out (``wqkv`` [C, 3C], ``wp`` [C, C]). LayerNorm
    statistics in at least fp32 and y rounded to x.dtype; qkv = y . wqkv +
    bqkv rounded; the attention of ``_split_softmax_av``, each head's output
    rounded; out = att . wp + bp, one rounding."""
    cd = compute_dtype(x.dtype)
    Bx, Nx, Cx = x.shape
    xf = x.to(cd)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps) * lnw.to(cd) + lnb.to(cd)).to(x.dtype)
    qkv = (torch.matmul(y.to(cd), wqkv.to(cd)) + bqkv.to(cd)).to(x.dtype)
    q, k, v = qkv.reshape(Bx, Nx, 3, num_heads, Cx // num_heads).permute(2, 0, 3, 1, 4)
    att, p = split_softmax_av_plain(q, k, v, scale)
    att = att.to(x.dtype).transpose(1, 2).reshape(Bx, Nx, Cx)
    out = (torch.matmul(att.to(cd), wp.to(cd)) + bp.to(cd)).to(x.dtype)
    return (out, p.to(x.dtype)) if with_probs else out


def attn_layer(x: torch.Tensor, lnw: torch.Tensor, lnb: torch.Tensor, wqkv: torch.Tensor,
               bqkv: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor, num_heads: int,
               scale: float, eps: float = EPS, g: int = 1, probs_out=None):
    """T3: proj(attention(LN(x))) + bp in one launch, ``g`` sequences per
    block; returns (out [B, N, C], probs_out). ``probs_out``: an optional
    [B, H, N, N] tensor that receives the post-softmax maps. CUDA:
    ``csrc/attn_layer.cu`` (bf16 everywhere, C a multiple of 32, contiguous
    16-byte aligned tensors); CPU: :func:`attn_layer_plain`."""
    Bx, Nx, Cx = x.shape
    shapes = {"lnw": (lnw, (Cx,)), "lnb": (lnb, (Cx,)), "wqkv": (wqkv, (Cx, 3 * Cx)),
              "bqkv": (bqkv, (3 * Cx,)), "wp": (wp, (Cx, Cx)), "bp": (bp, (Cx,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"attn_layer {name} {tuple(t.shape)} != {shape}")
    if Cx % num_heads or g < 1:
        raise ValueError(f"{Cx} columns, {num_heads} heads, {g} sequences per block")
    check_probs_out("attn_layer", probs_out, x, Bx, num_heads, Nx)
    args = (x, lnw, lnb, wqkv, bqkv, wp, bp, num_heads, scale, eps)
    if x.device.type == "cpu":
        if probs_out is None:
            return attn_layer_plain(*args, False), None
        out, probs = attn_layer_plain(*args, True)
        probs_out.copy_(probs)
        return out, probs_out
    if Cx % 32:
        raise ValueError(f"attn_layer: the kernel takes C % 32 == 0, got {Cx}")
    Dx = Cx // num_heads
    check_kernel_tensor("attn_layer x", x, 3, Dx, Nx, align=16)
    for name, (t, shape) in shapes.items():
        check_kernel_tensor(f"attn_layer {name}", t, len(shape), align=16)
    if probs_out is not None:
        check_kernel_tensor("attn_layer probs_out", probs_out, 4)
    from editor_tpu_torch.ops import _build

    out = torch.empty_like(x)
    qkv_ws = torch.empty((Bx, Nx, 3 * Cx), dtype=x.dtype, device=x.device)
    att_ws = torch.empty_like(x)
    code = _build.library().editor_attn_layer(
        x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
        wp.data_ptr(), bp.data_ptr(), out.data_ptr(),
        probs_out.data_ptr() if probs_out is not None else None, qkv_ws.data_ptr(),
        att_ws.data_ptr(), Bx, Nx, num_heads, Dx, float(scale), float(eps), g,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "attn_layer")
    attn_layer.launches += 1
    return out, probs_out


attn_layer.launches = 0


def layer_inputs(gen: torch.Generator, Bx: int = B, Nx: int = N, Cx: int = C,
                 device: str = "cuda") -> tuple:
    """The JAX script's inputs: x, lnw, lnb, wqkv, bqkv, wp, bp in bf16."""
    def r(*shape, mul=1.0, add=0.0, uniform=False):
        t = (torch.rand if uniform else torch.randn)(*shape, generator=gen, device=device)
        return (t * mul + add).to(torch.bfloat16)

    return (r(Bx, Nx, Cx, mul=0.5), r(Cx, uniform=True, add=0.5), r(Cx, mul=0.1),
            r(Cx, 3 * Cx, mul=0.03), r(3 * Cx, mul=0.02), r(Cx, Cx, mul=0.03),
            r(Cx, mul=0.02))


def composed(x, lnw, lnb, wqkv, bqkv, wp, bp, num_heads, scale, eps=EPS, probs_out=None,
             attention=None):
    """The composed port path in x.dtype: ``F.layer_norm`` -> ``F.linear`` ->
    K1 (or ``attention(qkv)``, e.g. SDPA) -> ``F.linear``."""
    from editor_tpu_torch import ops

    y = F.layer_norm(x, (x.shape[-1],), lnw, lnb, eps)
    qkv = F.linear(y, wqkv.t(), bqkv)
    if attention is None:
        att, _ = ops.attention_qkv(qkv, num_heads, scale, probs_out=probs_out)
    else:
        att = attention(qkv)
    return F.linear(att, wp.t(), bp)


def sdpa_from_qkv(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """SDPA on the head views of the packed qkv -> [B, N, C]."""
    Bq, Nq, C3 = qkv.shape
    Dq = C3 // 3 // num_heads
    q, k, v = qkv.view(Bq, Nq, 3, num_heads, Dq).permute(2, 0, 3, 1, 4)
    out = F.scaled_dot_product_attention(q, k, v, scale=scale)
    return out.transpose(1, 2).reshape(Bq, Nq, C3 // 3)


def layer_bound(Bx: int = B, Nx: int = N, Cx: int = C, num_heads: int = H,
                with_probs: bool = False) -> tuple:
    """The two products and the attention against x, the weights and out (and
    the maps) moved once."""
    flops = 2.0 * Bx * Nx * Cx * 4 * Cx + 4.0 * Bx * Nx * Nx * Cx
    nbytes = 2.0 * (2 * Bx * Nx * Cx + 4 * Cx * Cx + 6 * Cx
                    + (Bx * num_heads * Nx * Nx if with_probs else 0))
    return _bench.bound(flops, nbytes)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    _bench.start("bench_attn_layer")
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = layer_inputs(gen)
    maps = torch.empty(B, H, N, N, dtype=torch.bfloat16, device="cuda")
    want = composed(*inputs, H, SCALE)
    for wp in (False, True):
        po = maps if wp else None
        ms = _bench.cuda_ms(lambda: composed(*inputs, H, SCALE, probs_out=po), args.iters)
        _bench.report(f"composed (LN, linear, K1, linear) probs={int(wp)}", ms, 0.0,
                      layer_bound(with_probs=wp))
    sdpa = composed(*inputs, H, SCALE, attention=lambda t: sdpa_from_qkv(t, H, SCALE))
    ms = _bench.cuda_ms(lambda: composed(*inputs, H, SCALE,
                                         attention=lambda t: sdpa_from_qkv(t, H, SCALE)),
                        args.iters)
    _bench.report("library chain (LN, linear, SDPA, linear) probs=0", ms,
                  _bench.rel_err(sdpa, want), layer_bound())
    for wp in (False, True):
        po = maps if wp else None
        for g in (1, 2, 4):
            out, _ = attn_layer(*inputs, H, SCALE, EPS, g, po)
            ms = _bench.cuda_ms(lambda: attn_layer(*inputs, H, SCALE, EPS, g, po), args.iters)
            _bench.report(f"fused layer probs={int(wp)} g={g}", ms, _bench.rel_err(out, want),
                          layer_bound(with_probs=wp))
    ref = attn_layer_plain(*inputs, H, SCALE, EPS, False)
    ms = _bench.cuda_ms(lambda: attn_layer_plain(*inputs, H, SCALE, EPS, True), args.iters)
    _bench.report("plain attn_layer_plain probs=1", ms, _bench.rel_err(ref, want))


if __name__ == "__main__":
    main()
