"""T3: the attention half-layer, proj(attention(LN(x))), in one kernel, on
one CUDA device.

    python3 -m editor_tpu_torch.tools.bench_attn_layer [--iters 20]

Counterpart of ``tools/bench_attn_layer.py``, whose TPU kernel ``attn_layer``
(``_attn_layer_kernel``) runs LayerNorm, the qkv product, the attention and
the projection of g sequences per grid step with both weight matrices
resident. :func:`attn_layer` launches ``csrc/attn_layer.cu``: one block per
``g`` sequences, its two products on the tensor-core GEMM body
``csrc/ln_gemm_mma.cuh`` in chunks of 144 rows (a sequence) with the rows
and the weights streamed through a cp.async ring (4.7 MB of bf16 weights
cannot stay resident in a block's 227 KB), its attention on K1's forward
body. At B = 384, N = 129,
C = 768, H = 12 with the JAX script's inputs (x randn * 0.5, LayerNorm
weight rand + 0.5, bias randn * 0.1, weights randn * 0.03, biases randn *
0.02, all bf16, seed 0) the tool prints the composed port path
(``F.layer_norm`` -> ``F.linear`` -> K1 -> ``F.linear``) with and without
the probs, the same chain with SDPA in K1's place, then T3 at g in (1, 2, 4)
with and without the probs: ms from CUDA events, the relative error against
the composed path, the bound, the weight bytes the call streams through L2
(:func:`weight_bytes`) and TFLOP/s; then the plain version. The card's name
and power limit come first. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from editor_tpu_torch.ops._checks import (GEMM_MAX_C, MAX_TOKENS, check_kernel_tensor,
                                          check_probs_out, compute_dtype)
from editor_tpu_torch.tools import _bench
from editor_tpu_torch.tools.bench_attn import split_softmax_av_plain

B, N, C, H = 384, 129, 768, 12
D = C // H
SCALE = D ** -0.5
EPS = 1e-6


def _layer_norm(x: torch.Tensor, lnw: torch.Tensor, lnb: torch.Tensor, eps: float):
    """LN(x) in at least fp32 (statistics of each row, biased variance)."""
    cd = compute_dtype(x.dtype)
    xf = x.to(cd)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * lnw.to(cd) + lnb.to(cd)


def _attention(qkv: torch.Tensor, num_heads: int, scale: float, dtype: torch.dtype,
               cls_fp32: bool = True):
    """:func:`bench_attn.split_softmax_av_plain` on qkv [B, N, 3C] in at
    least fp32: (att [B, N, C], probs [B, H, N, N]) unrounded, the
    probabilities rounded to ``dtype`` before p.v."""
    Bx, Nx, C3 = qkv.shape
    q, k, v = qkv.reshape(Bx, Nx, 3, num_heads, C3 // 3 // num_heads).permute(2, 0, 3, 1, 4)
    att, p = split_softmax_av_plain(q, k, v, scale, dtype=dtype, cls_fp32=cls_fp32)
    return att.transpose(1, 2).reshape(Bx, Nx, C3 // 3), p


def qkv_plain(x: torch.Tensor, lnw: torch.Tensor, lnb: torch.Tensor, wqkv: torch.Tensor,
              bqkv: torch.Tensor, eps: float, round_y: bool = True) -> torch.Tensor:
    """T3's first stage in the TPU kernel's form: qkv = y . wqkv + bqkv with
    fp32 sums, rounded to x.dtype, y = LN(x) rounded to x.dtype (without
    ``round_y`` left in fp32: a wrong form)."""
    cd = compute_dtype(x.dtype)
    y = _layer_norm(x, lnw, lnb, eps)
    if round_y:
        y = y.to(x.dtype).to(cd)
    return (torch.matmul(y, wqkv.to(cd)) + bqkv.to(cd)).to(x.dtype)


def proj_plain(att: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """T3's last stage: att . wp + bp with fp32 sums, rounded once to dtype."""
    cd = compute_dtype(dtype)
    return (torch.matmul(att.to(cd), wp.to(cd)) + bp.to(cd)).to(dtype)


def _attn_layer(x, lnw, lnb, wqkv, bqkv, wp, bp, num_heads: int, scale: float, eps: float,
                with_probs: bool, round_qkv: bool = True, round_att: bool = True,
                cls_fp32: bool = True):
    """T3's function with each of its rounding points switchable: the plain
    version keeps all of them, :func:`attn_layer_form` moves one."""
    cd = compute_dtype(x.dtype)
    y = _layer_norm(x, lnw, lnb, eps).to(x.dtype).to(cd)
    qkv = torch.matmul(y, wqkv.to(cd)) + bqkv.to(cd)
    if round_qkv:
        qkv = qkv.to(x.dtype).to(cd)
    att, p = _attention(qkv, num_heads, scale, x.dtype, cls_fp32)
    if round_att:
        att = att.to(x.dtype)
    out = proj_plain(att, wp, bp, x.dtype)
    return (out, p.to(x.dtype)) if with_probs else out


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
    return _attn_layer(x, lnw, lnb, wqkv, bqkv, wp, bp, num_heads, scale, eps, with_probs)


# The wrong forms T3's share test must tell from the plain version: qkv or
# the attention's output left in fp32, or the cls key's probability rounded
# too (attention_qkv_plain's form)
WRONG_FORMS = {"qkv_fp32": dict(round_qkv=False), "att_fp32": dict(round_att=False),
               "cls_rounded": dict(cls_fp32=False)}


def attn_layer_form(x, lnw, lnb, wqkv, bqkv, wp, bp, num_heads: int, scale: float,
                    eps: float, form: str) -> torch.Tensor:
    """T3's output in one of :data:`WRONG_FORMS`: the plain version with one
    rounding point dropped or added."""
    return _attn_layer(x, lnw, lnb, wqkv, bqkv, wp, bp, num_heads, scale, eps, False,
                       **WRONG_FORMS[form])


def stage_shares(x, lnw, lnb, wqkv, bqkv, wp, bp, num_heads: int, scale: float, eps: float,
                 qkv: torch.Tensor, att: torch.Tensor, out: torch.Tensor) -> tuple:
    """T3's share test read stage by stage, each stage against the TPU form
    computed from the kernel's own input to it (``attn_layer_stages``: its
    qkv and attention workspaces): qkv against :func:`qkv_plain`, att
    against K1's TPU-form attention of that qkv, out against
    :func:`proj_plain` of that att. (The output end to end is chaotic in the
    qkv product's summation order: ~0.07% of qkv elements rounding the
    other way move ~3% of the outputs by more than one bf16 ulp.) Returns
    (the three shares, the wrong forms' shares at the stage where each
    acts): ``y_fp32`` (the LayerNorm's output not rounded) at qkv;
    ``qkv_fp32`` (the attention of the unrounded qkv) and ``cls_rounded``
    (the cls key's probability rounded too) at att; ``att_fp32`` (the
    projection of the unrounded attention) at out."""
    from editor_tpu_torch.ops.fused_attention import attention_qkv_tpu_plain

    dt = x.dtype
    cd = compute_dtype(dt)
    y = _layer_norm(x, lnw, lnb, eps).to(dt).to(cd)
    qkv_unrounded = torch.matmul(y, wqkv.to(cd)) + bqkv.to(cd)
    refs = {"qkv": qkv_plain(x, lnw, lnb, wqkv, bqkv, eps),
            "att": attention_qkv_tpu_plain(qkv, num_heads, scale, False),
            "out": proj_plain(att, wp, bp, dt)}
    shares = {name: _bench.bf16_off_share(got, refs[name])
              for name, got in (("qkv", qkv), ("att", att), ("out", out))}
    forms = {"y_fp32": ("qkv", qkv_plain(x, lnw, lnb, wqkv, bqkv, eps, round_y=False)),
             "qkv_fp32": ("att", _attention(qkv_unrounded, num_heads, scale, dt)[0]),
             "cls_rounded": ("att", _attention(qkv.to(cd), num_heads, scale, dt,
                                               cls_fp32=False)[0]),
             "att_fp32": ("out", proj_plain(_attention(qkv.to(cd), num_heads, scale, dt)[0],
                                            wp, bp, dt))}
    wrong = {form: _bench.bf16_off_share(got.to(dt), refs[stage])
             for form, (stage, got) in forms.items()}
    return shares, wrong


# Rows a chunk of the kernel's products (csrc/attn_layer.cu, T3Cfg::BM): each
# chunk streams both weight matrices once
CHUNK_ROWS = 144


def check_t3_shape(N: int, C: int, num_heads: int) -> None:
    """Raise unless T3's CUDA kernel takes N tokens of C = H D features: D a
    head dim K1 takes (a multiple of 16 up to 128), C up to ``GEMM_MAX_C``,
    1 <= N <= MAX_TOKENS."""
    if C % num_heads:
        raise ValueError(f"attn_layer: {C} columns do not split into {num_heads} heads")
    D = C // num_heads
    if D % 16 or not 16 <= D <= 128 or C > GEMM_MAX_C or not 1 <= N <= MAX_TOKENS:
        raise ValueError(f"attn_layer: the kernel takes D a multiple of 16 up to 128, C up to "
                         f"{GEMM_MAX_C} and N <= {MAX_TOKENS}, got D = {D}, C = {C}, N = {N}")


def weight_bytes(Bx: int, Nx: int, Cx: int, g: int) -> int:
    """Bytes of wqkv and wp one call streams through L2: every chunk of
    :data:`CHUNK_ROWS` of a block's g N rows reads both once."""
    blocks = -(-Bx // g)
    chunks = sum(-(-min(g, Bx - b * g) * Nx // CHUNK_ROWS) for b in range(blocks))
    return chunks * 4 * Cx * Cx * 2


def _check_layer(x, lnw, lnb, wqkv, bqkv, wp, bp, num_heads: int, g: int, probs_out) -> None:
    Bx, Nx, Cx = x.shape
    shapes = {"lnw": (lnw, (Cx,)), "lnb": (lnb, (Cx,)), "wqkv": (wqkv, (Cx, 3 * Cx)),
              "bqkv": (bqkv, (3 * Cx,)), "wp": (wp, (Cx, Cx)), "bp": (bp, (Cx,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"attn_layer {name} {tuple(t.shape)} != {shape}")
    if Cx % num_heads or g < 1:
        raise ValueError(f"{Cx} columns, {num_heads} heads, {g} sequences per block")
    check_probs_out("attn_layer", probs_out, x, Bx, num_heads, Nx)
    if x.device.type == "cpu":
        return
    check_t3_shape(Nx, Cx, num_heads)
    check_kernel_tensor("attn_layer x", x, 3, Cx // num_heads, Nx, align=16)
    for name, (t, shape) in shapes.items():
        check_kernel_tensor(f"attn_layer {name}", t, len(shape), align=16)
    if probs_out is not None:
        check_kernel_tensor("attn_layer probs_out", probs_out, 4)


def _launch(x, lnw, lnb, wqkv, bqkv, wp, bp, num_heads: int, scale: float, eps: float, g: int,
            probs_out) -> tuple:
    """One launch of ``csrc/attn_layer.cu`` (the inputs checked): (out, the
    qkv workspace, the attention workspace)."""
    from editor_tpu_torch.ops import _build

    Bx, Nx, Cx = x.shape
    out = torch.empty_like(x)
    qkv_ws = torch.empty((Bx, Nx, 3 * Cx), dtype=x.dtype, device=x.device)
    att_ws = torch.empty_like(x)
    code = _build.library().editor_attn_layer(
        x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
        wp.data_ptr(), bp.data_ptr(), out.data_ptr(),
        probs_out.data_ptr() if probs_out is not None else None, qkv_ws.data_ptr(),
        att_ws.data_ptr(), Bx, Nx, num_heads, Cx // num_heads, float(scale), float(eps), g,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "attn_layer")
    attn_layer.launches += 1
    return out, qkv_ws, att_ws


def attn_layer(x: torch.Tensor, lnw: torch.Tensor, lnb: torch.Tensor, wqkv: torch.Tensor,
               bqkv: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor, num_heads: int,
               scale: float, eps: float = EPS, g: int = 1, probs_out=None):
    """T3: proj(attention(LN(x))) + bp in one launch, ``g`` sequences per
    block; returns (out [B, N, C], probs_out). ``probs_out``: an optional
    [B, H, N, N] tensor that receives the post-softmax maps. CUDA:
    ``csrc/attn_layer.cu`` (bf16 everywhere, :func:`check_t3_shape`,
    contiguous 16-byte aligned tensors); CPU: :func:`attn_layer_plain`."""
    _check_layer(x, lnw, lnb, wqkv, bqkv, wp, bp, num_heads, g, probs_out)
    args = (x, lnw, lnb, wqkv, bqkv, wp, bp, num_heads, scale, eps)
    if x.device.type == "cpu":
        if probs_out is None:
            return attn_layer_plain(*args, False), None
        out, probs = attn_layer_plain(*args, True)
        probs_out.copy_(probs)
        return out, probs_out
    return _launch(*args, g, probs_out)[0], probs_out


def attn_layer_stages(x: torch.Tensor, lnw: torch.Tensor, lnb: torch.Tensor,
                      wqkv: torch.Tensor, bqkv: torch.Tensor, wp: torch.Tensor,
                      bp: torch.Tensor, num_heads: int, scale: float, eps: float = EPS,
                      g: int = 1) -> tuple:
    """:func:`attn_layer` with its stages: (out, qkv [B, N, 3C], att [B, N,
    C]), the kernel's two workspaces as its third phase left them (for
    :func:`stage_shares`; CPU: the plain stages, :func:`qkv_plain`, K1's
    TPU-form attention and :func:`proj_plain`)."""
    from editor_tpu_torch.ops.fused_attention import attention_qkv_tpu_plain

    _check_layer(x, lnw, lnb, wqkv, bqkv, wp, bp, num_heads, g, None)
    if x.device.type == "cpu":
        qkv = qkv_plain(x, lnw, lnb, wqkv, bqkv, eps)
        att = attention_qkv_tpu_plain(qkv, num_heads, scale, False)
        return proj_plain(att, wp, bp, x.dtype), qkv, att
    return _launch(x, lnw, lnb, wqkv, bqkv, wp, bp, num_heads, scale, eps, g, None)


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


def layer_flops(Bx: int = B, Nx: int = N, Cx: int = C) -> float:
    """The two products' and the attention's operations."""
    return 2.0 * Bx * Nx * Cx * 4 * Cx + 4.0 * Bx * Nx * Nx * Cx


def layer_bound(Bx: int = B, Nx: int = N, Cx: int = C, num_heads: int = H,
                with_probs: bool = False) -> tuple:
    """The two products and the attention against x, the weights and out (and
    the maps) moved once."""
    flops = layer_flops(Bx, Nx, Cx)
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
                          layer_bound(with_probs=wp), l2_weight_gb=weight_bytes(B, N, C, g) / 1e9,
                          tflops=f"{layer_flops() / ms / 1e9:.1f}")
    ref = attn_layer_plain(*inputs, H, SCALE, EPS, False)
    ms = _bench.cuda_ms(lambda: attn_layer_plain(*inputs, H, SCALE, EPS, True), args.iters)
    _bench.report("plain attn_layer_plain probs=1", ms, _bench.rel_err(ref, want))


if __name__ == "__main__":
    main()
