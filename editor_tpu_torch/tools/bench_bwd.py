"""The frequency stage and the backward attention kernels K4 and K7 at the
flagship's shapes, on one CUDA device.

    python3 -m editor_tpu_torch.tools.bench_bwd

Counterpart of ``tools/bench_bwd.py`` (seed 0, bf16, CUDA events through
``_bench.cuda_ms``), one line a case:

* the frequency mask (``models.frequency.frequency_token_select``, keep 10,
  stride and window 16) on B = 128 random-normal 256x128 images a modality;
* K4 (``ops.attention_qkv_bwd``) at the backbone's [384, 129, 2304] on
  random-normal qkv and cotangent;
* K7 (``ops.masked_attention_tiled_bwd``, tiles of 129) at [384, 129] and
  [128, 387] on JAX's random half-kept mask (``rand > 0.5`` over [128, 129],
  every cls token kept; stacked three times over the rows for [384, 129]
  and over the columns for [128, 387]).

Each kernel line carries its bound (``_bench.bound``: each input read and
the output written once; the work 10 H D products over Σ valid² query-key
pairs) and the backward of one ``scaled_dot_product_attention`` call (with
the key mask for K7), timed as (forward + backward) - forward. JAX sweeps
its kernels' ``group`` (the TPU's block choice); K4's and K7's layout
follows from N and D, with no ``group``, so each shape is timed once and the
line says the group is fixed. The card's name and power limit come first. A
case that fails prints ``FAIL`` and its error, and the tool then exits
non-zero; it exits non-zero without a CUDA device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from editor_tpu_torch.tools import _bench

FILL = -65504.0
FIXED = "fixed"  # the group column of a kernel line: K4 and K7 take no group


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    B, N, C = t.shape
    return t.view(B, N, H, C // H).transpose(1, 2).contiguous()


def sdpa_bwd_ms(qkv: torch.Tensor, g: torch.Tensor, H: int, scale: float,
                key_mask: Optional[torch.Tensor] = None, iters: int = 30) -> float:
    """The backward of one ``scaled_dot_product_attention`` call on qkv's
    heads (``key_mask`` [B, N] of kept keys), timed as (forward + backward)
    - forward."""
    q, k, v = (_heads(t, H).requires_grad_() for t in qkv.chunk(3, dim=-1))
    gh = _heads(g, H)
    mask = None if key_mask is None else key_mask.bool()[:, None, None, :]

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)

    both = _bench.cuda_ms(lambda: torch.autograd.grad(fwd(), (q, k, v), gh), iters=iters)
    return both - _bench.cuda_ms(fwd, iters=iters)


def bwd_bound(qkv: torch.Tensor, g: torch.Tensor, H: int,
              mask: Optional[torch.Tensor] = None) -> tuple:
    """(ms, "bytes" or "operations") of a backward kernel: qkv, g (and the
    fp32 mask) read and dqkv written once; 10 H D flops a valid query-key
    pair (the recomputed logits, dv, dp, dq and dk)."""
    B, N, C3 = qkv.shape
    D = C3 // 3 // H
    pairs = float((mask.sum(1) ** 2).sum()) if mask is not None else float(B * N * N)
    nbytes = 2.0 * B * N * (C3 + C3 // 3 + C3) + (4.0 * B * N if mask is not None else 0.0)
    return _bench.bound(10.0 * H * D * pairs, nbytes)


def run(B: int = 128, N: int = 129, C: int = 768, H: int = 12, hw=(256, 128),
        iters: int = 30, device="cuda") -> Tuple[Dict[str, Optional[float]], List[str]]:
    """Time the cases (one line each); returns ({case: ms or None}, the
    labels of the cases that failed). K4 at [3B, N, 3C], K7 at [3B, N] and
    [B, 3N] with tiles of N; the frequency mask on B images of ``hw``."""
    from editor_tpu_torch import ops
    from editor_tpu_torch.models.frequency import frequency_token_select

    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

    scale = (C // H) ** -0.5
    failed: List[str] = []
    out: Dict[str, Optional[float]] = {}
    print(f"B={B} N={N} C={C} H={H} bf16 device={device}", flush=True)

    images = [randn(B, *hw, 3) for _ in range(3)]
    out["frequency"] = t = _bench.case("frequency", lambda: _bench.cuda_ms(
        lambda: frequency_token_select(images, keep=10, stride=16, window=16), iters=iters),
        failed)
    if t is not None:
        _bench.report("frequency", t)
    del images

    def kernel(label, fn, qkv, g, mask=None):
        def measure():
            ms = _bench.cuda_ms(fn, iters=iters)
            return ms, sdpa_bwd_ms(qkv, g, H, scale, mask, iters=iters)
        r = _bench.case(label, measure, failed)
        out[label] = None if r is None else r[0]
        if r is not None:
            _bench.report(label, r[0], bound_ms=bwd_bound(qkv, g, H, mask),
                          sdpa_bwd_ms=f"{r[1]:.4f}", group=FIXED)

    qkv, g = randn(3 * B, N, 3 * C), randn(3 * B, N, C)
    kernel(f"attention_qkv_bwd [{3 * B}, {N}, {3 * C}]",
           lambda: ops.attention_qkv_bwd(qkv, g, H, scale), qkv, g)
    mask = (torch.rand(B, N, generator=gen, device=device) > 0.5).float()
    mask[:, 0] = 1.0
    for m in (mask.repeat(3, 1), mask.repeat(1, 3)):
        Bm, Nm = m.shape
        qkv, g = randn(Bm, Nm, 3 * C), randn(Bm, Nm, C)
        kernel(f"masked_attention_tiled_bwd [{Bm}, {Nm}]",
               lambda: ops.masked_attention_tiled_bwd(qkv, m, g, H, scale, FILL, N),
               qkv, g, m)
    return out, failed


def main(argv=None) -> None:
    """No arguments (``argv`` is accepted for a uniform entry point)."""
    _bench.start("bench_bwd")
    _, failed = run()
    _bench.finish("bench_bwd", failed)


if __name__ == "__main__":
    main()
