"""Fused LayerNorm -> matmul + bias (-> GELU) (K8).

Counterpart of ``editor_tpu/ops/fused_linear.py``: the normalised
activations stay in fast memory between the LayerNorm and the product, and
an optional erf-GELU is applied before the one output write. As in the JAX
package it is a library op on no model path: the JAX backbone keeps it out
(``editor_tpu/models/vit.py:379-384``), so the port's does too.

On a CUDA tensor :func:`ln_matmul` launches ``csrc/ln_matmul.cu`` (bf16 x,
C and O multiples of 16, C up to ``GEMM_MAX_C``: the tensor-core GEMM
body ``csrc/ln_gemm_mma.cuh`` with the LayerNorm prologue) or raises; on a
CPU tensor it runs :func:`ln_matmul_plain`. :func:`ln_matmul_fn` is the autograd form: K8
forward, and a backward that differentiates the plain version on the saved
inputs (the JAX ``custom_vjp`` recomputes through XLA the same way; there is
no backward kernel).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from editor_tpu_torch.ops import _flops
from editor_tpu_torch.ops._checks import GEMM_MAX_C, check_kernel_tensor, compute_dtype

ACTS = ("", "gelu")


def check_k8_shape(C: int, O: int) -> None:
    """Raise unless K8's CUDA kernel takes C input and O output features:
    multiples of 16 (the tensor-core tiles are 16 deep), C at most
    ``GEMM_MAX_C``."""
    if C < 16 or O < 16 or C % 16 or O % 16 or C > GEMM_MAX_C:
        raise ValueError(f"the CUDA kernel takes C and O in multiples of 16 and C <= "
                         f"{GEMM_MAX_C}, got {C}, {O}")


def f32_param(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` as a contiguous fp32 tensor on ``device`` whose base is 16-byte
    aligned (K8 reads gamma and beta with 16-byte loads): a fresh copy where
    the converted tensor is a view at another offset."""
    t = t.to(device=device, dtype=torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ln_matmul_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                    ln_weight: torch.Tensor, ln_bias: torch.Tensor, eps: float = 1e-6,
                    act: str = "") -> torch.Tensor:
    """LayerNorm(x; ln_weight, ln_bias) @ weight^T + bias, optionally GELU'd.

    x [..., C]; ``weight`` [O, C] in the torch Linear layout (the JAX op
    takes [C, O]); returns [..., O] in x's dtype. The TPU kernel's rounding
    points (``fused_linear._kernel``): LayerNorm in at least fp32, y rounded
    to x.dtype, the product with the weight in x.dtype accumulated in at
    least fp32, the bias and the exact erf-GELU in that precision, one
    rounding at the end. (``_xla_ln_matmul`` rounds the product before the
    bias; at f64 the two agree.)"""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    cd = compute_dtype(x.dtype)
    xf = x.to(cd)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * ln_weight.to(cd) + ln_bias.to(cd)
    out = torch.matmul(y.to(x.dtype).to(cd), weight.to(x.dtype).to(cd).t())
    if bias is not None:
        out = out + bias.to(cd)
    if act == "gelu":
        out = F.gelu(out)
    return out.to(x.dtype)


@_flops.counted(_flops.ln_matmul)
def ln_matmul(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              ln_weight: torch.Tensor, ln_bias: torch.Tensor, eps: float = 1e-6,
              act: str = "") -> torch.Tensor:
    """K8: LayerNorm -> matmul + bias -> optional GELU in one kernel.

    x [..., C]; ``weight`` [O, C], the torch Linear layout (cast to x's
    dtype per call, as the JAX op casts its [C, O] weight); ``bias`` [O] or
    None; ``ln_weight``, ``ln_bias`` [C]. CUDA: ``csrc/ln_matmul.cu`` (bf16
    x, :func:`check_k8_shape`, any row count); CPU: :func:`ln_matmul_plain`."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    C = x.shape[-1]
    O = weight.shape[0]
    if weight.shape != (O, C) or ln_weight.shape != (C,) or ln_bias.shape != (C,):
        raise ValueError(f"weight {tuple(weight.shape)}, LN {tuple(ln_weight.shape)} / "
                         f"{tuple(ln_bias.shape)} do not fit x [..., {C}]")
    if bias is not None and bias.shape != (O,):
        raise ValueError(f"bias {tuple(bias.shape)} != ({O},)")
    if x.device.type == "cpu":
        return ln_matmul_plain(x, weight, bias, ln_weight, ln_bias, eps, act)
    check_k8_shape(C, O)
    x2 = x.reshape(-1, C)
    check_kernel_tensor("ln_matmul x", x2, 2, align=16)
    w = weight.to(x.dtype).contiguous()
    check_kernel_tensor("ln_matmul weight", w, 2, align=16)
    f32 = [None if t is None else f32_param(t, x.device) for t in (bias, ln_weight, ln_bias)]
    from editor_tpu_torch.ops import _build

    T = x2.shape[0]
    out = torch.empty((T, O), dtype=x.dtype, device=x.device)
    ys = torch.empty_like(x2)  # the normalised rows, streamed back by the later column tiles
    code = _build.library().editor_ln_matmul(
        x2.data_ptr(), w.data_ptr(), None if f32[0] is None else f32[0].data_ptr(),
        f32[1].data_ptr(), f32[2].data_ptr(), out.data_ptr(), ys.data_ptr(), T, C, O, float(eps),
        int(act == "gelu"), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "ln_matmul")
    ln_matmul.launches += 1
    return out.reshape(*x.shape[:-1], O)


ln_matmul.launches = 0


class _LnMatmul(torch.autograd.Function):
    """K8 forward; the backward differentiates :func:`ln_matmul_plain`."""

    @staticmethod
    def forward(ctx, x, weight, bias, ln_weight, ln_bias, eps, act):
        ctx.save_for_backward(x, weight, bias, ln_weight, ln_bias)
        ctx.eps, ctx.act = eps, act
        return ln_matmul(x, weight, bias, ln_weight, ln_bias, eps, act)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = ln_matmul_plain(*inputs, ctx.eps, ctx.act)
        wrt = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
        return (*(next(grads) if t is not None and t.requires_grad else None
                  for t in inputs), None, None)


def ln_matmul_fn(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 ln_weight: torch.Tensor, ln_bias: torch.Tensor, eps: float = 1e-6,
                 act: str = "") -> torch.Tensor:
    """:func:`ln_matmul` under autograd: the JAX ``custom_vjp`` of
    ``ln_matmul``, whose backward recomputes the plain graph."""
    return _LnMatmul.apply(x, weight, bias, ln_weight, ln_bias, eps, act)
