"""Masked multi-head attention from the raw qkv projection (K3, K6) and its
VJPs (K5, K7).

Counterpart of ``editor_tpu/ops/masked_attention.py``, the hot op of the HMA
fusion block: logits are masked with ``mask_fill`` (-65504) where
``mask_q * mask_k == 0``, softmaxed, and output rows multiplied by the query
mask, so fully masked rows come out 0.

Two kernel pairs, chosen by :func:`masked_attention_from_qkv` with the JAX
dispatch rule (:func:`masked_attention_route`):

* sequences of 1 + 128-token tiles (the uncompacted fusion tail, N = 129 per
  modality and 258 or 387 joint) go to K6, :func:`masked_attention_tiled`
  (``csrc/masked_attention.cu``), and its VJP K7,
  :func:`masked_attention_tiled_bwd` (``csrc/masked_attention_bwd.cu``): the
  TPU kernels' split form, each tile's cls-key column in fp32 and the fill
  added as a bias;
* any other N <= 512 (the compact tail, N = 88 and 264) goes to K3,
  :func:`masked_attention_qkv` (``csrc/masked_attention.cu``), and its VJP K5,
  :func:`masked_attention_qkv_bwd` (``csrc/masked_attention_bwd.cu``): full
  logits, every weight rounded.

On a CUDA tensor each wrapper launches its kernel (bf16 qkv, N <= 512) or
raises; on a CPU tensor it runs its plain version. :func:`masked_attention_qkv_fn`
and :func:`masked_attention_tiled_fn` join each pair under autograd for the
train step; the mask gets no gradient. K3 and K6 are the masked instances of
K1's tensor-core forward (``csrc/attention_fwd_mma.cuh``; K6 with each tile's
cls key in fp32) and K5 the instance without cls keys of the tensor-core
backward that K4 and K7 share (``csrc/attention_bwd_mma.cuh``). K3, K5 and K6
take ``group``: 0 (the model paths) launches one sequence a block and counts
in the wrapper's ``launches``; g >= 1 walks g sequences a block through the
same body (T6, the JAX tool's group sweep of K3 and K5, and K6's sweep in
``tools/bench_attn2.py``; bit-identical to group 0) and counts in its
``variant_launches``. The plain version in the rounding form of K3's
TPU kernel, which the CUDA kernel follows, is
:func:`masked_attention_qkv_tpu_plain`; the model's CPU path keeps
:func:`masked_attention_qkv_plain`, the XLA form. K5's, K6's and K7's plain
versions are in their TPU kernels' forms.
"""

from __future__ import annotations

import ctypes

import torch

from editor_tpu_torch.ops import _flops
from editor_tpu_torch.ops._checks import MAX_TOKENS, check_kernel_tensor, compute_dtype

MASK_FILL = -65504.0  # reference: vit_pytorch.py:252


def check_group(group: int) -> None:
    """Raise unless ``group`` is a number of sequences a block walks: 0 (the
    model paths' launch) or more."""
    if group < 0:
        raise ValueError(f"group {group} < 0: sequences a block walks, 0 for the model "
                         "paths' launch")


def count_launch(fn, group: int) -> None:
    """Count one launch of ``fn``'s kernel where it launches: group 0 (the
    model paths) in ``fn.launches``, any other group in
    ``fn.variant_launches``."""
    if group == 0:
        fn.launches += 1
    else:
        fn.variant_launches += 1


def _heads(qkv: torch.Tensor, num_heads: int):
    """[B, N, 3C] -> q, k, v [B, H, N, D] in the compute dtype."""
    B, N, C3 = qkv.shape
    D = C3 // 3 // num_heads
    qkv5 = qkv.reshape(B, N, 3, num_heads, D).permute(2, 0, 3, 1, 4)
    return qkv5.to(compute_dtype(qkv.dtype)).unbind(0)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[B, H, N, D] -> [B, N, H * D]."""
    B, H, N, D = t.shape
    return t.transpose(1, 2).reshape(B, N, H * D)


def _cls_keys(N: int, tile: int, device) -> torch.Tensor:
    """[N] bool: the cls key of each ``tile``-token tile (m % tile == 0)."""
    return torch.arange(N, device=device) % tile == 0


def masked_attention_qkv_plain(qkv: torch.Tensor, mask: torch.Tensor,
                               num_heads: int, scale: float,
                               mask_fill: float = MASK_FILL) -> torch.Tensor:
    """qkv: [B, N, 3C], mask: [B, N] (1 = keep) -> [B, N, C].

    Same math as ``_xla_masked_from_qkv``: at-least-fp32 logits, masked
    pairs replaced by ``mask_fill``, softmax, query rows re-masked, weights
    cast to qkv.dtype before the product with v."""
    q, k, v = _heads(qkv, num_heads)
    cd = q.dtype
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    m = mask.to(cd)
    pair = m[:, None, :, None] * m[:, None, None, :]
    logits = torch.where(pair == 0, torch.full_like(logits, mask_fill), logits)
    attn = torch.softmax(logits, dim=-1) * m[:, None, :, None]
    out = torch.matmul(attn.to(qkv.dtype).to(cd), v).to(qkv.dtype)
    return _merge_heads(out)


def masked_attention_qkv_tpu_plain(qkv: torch.Tensor, mask: torch.Tensor,
                                   num_heads: int, scale: float,
                                   mask_fill: float = MASK_FILL) -> torch.Tensor:
    """K3's function in its TPU kernel's form (``_qkv_masked_full_kernel``),
    which the CUDA kernel follows: qkv [B, N, 3C], mask [B, N] -> [B, N, C]
    in qkv.dtype.

    At-least-fp32 logits times ``scale`` with ``mask_fill`` ADDED where the
    pair mask is 0; a row-max-stabilised softmax; every exp rounded to
    qkv.dtype before e.v; the sum of the unrounded exps and the query mask
    scale the output rows (lazy normalisation). It differs from
    :func:`masked_attention_qkv_plain` (normalised weights, re-masked, then
    rounded) in where it rounds, and at f64 not at all. Used by the tests
    and chip_smoke; the model's CPU path keeps the XLA form."""
    q, k, v = _heads(qkv, num_heads)
    cd = q.dtype
    m = mask.to(cd)
    pair = m[:, None, :, None] * m[:, None, None, :]
    logits = (torch.matmul(q, k.transpose(-1, -2)) * scale
              + torch.where(pair == 0, mask_fill, 0.0).to(cd))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    rw = m[:, None, :, None] / e.sum(-1, keepdim=True)
    return _merge_heads((torch.matmul(e.to(qkv.dtype).to(cd), v) * rw).to(qkv.dtype))


def masked_attention_tiled_plain(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
                                 scale: float, mask_fill: float = MASK_FILL,
                                 tile: int = 129) -> torch.Tensor:
    """K6's function in its TPU kernel's form (``_qkv_masked_kernel``):
    qkv [B, N, 3C], mask [B, N], N a multiple of ``tile`` -> [B, N, C].

    At-least-fp32 logits with ``mask_fill`` ADDED where the pair mask is 0;
    a row-max-stabilised softmax over all tiles; the exps of patch keys
    rounded to qkv.dtype before e.v, each tile's cls key (m % tile == 0)
    kept in fp32; the sum of the unrounded exps and the query mask scale the
    output rows (lazy normalisation). At f64 it equals
    ``_xla_masked_from_qkv``."""
    q, k, v = _heads(qkv, num_heads)
    cd = q.dtype
    m = mask.to(cd)
    pair = m[:, None, :, None] * m[:, None, None, :]
    logits = (torch.matmul(q, k.transpose(-1, -2)) * scale
              + torch.where(pair == 0, mask_fill, 0.0).to(cd))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    rw = m[:, None, :, None] / e.sum(-1, keepdim=True)
    e = torch.where(_cls_keys(qkv.shape[1], tile, qkv.device), e, e.to(qkv.dtype).to(cd))
    return _merge_heads((torch.matmul(e, v) * rw).to(qkv.dtype))


def _masked_bwd_plain(qkv, mask, g, num_heads, scale, mask_fill, tile):
    """The masked attention VJP in its TPU kernels' form, the fill added as a
    bias: tile 0 is K5 (``_qkv_masked_full_bwd_kernel``: every key's attn and
    dl rounded), tile > 0 is K7 (``_qkv_masked_bwd_kernel``: each tile's cls
    key unrounded)."""
    q, k, v = _heads(qkv, num_heads)
    cd = q.dtype
    B, N, C = g.shape
    gh = g.reshape(B, N, num_heads, C // num_heads).transpose(1, 2).to(cd)
    m = mask.to(cd)
    pair = m[:, None, :, None] * m[:, None, None, :]
    logits = (torch.matmul(q, k.transpose(-1, -2)) * scale
              + torch.where(pair == 0, mask_fill, 0.0).to(cd))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    inv = 1.0 / e.sum(-1, keepdim=True)
    attn = e * inv * m[:, None, :, None]
    dat = torch.matmul(gh, v.transpose(-1, -2))
    r0 = (dat * e).sum(-1, keepdim=True) * inv
    dl = attn * (dat - r0) * scale
    if tile:
        cls = _cls_keys(N, tile, qkv.device)
        dl = torch.where(cls, dl, dl.to(qkv.dtype).to(cd))
        ab = torch.where(cls, attn, attn.to(qkv.dtype).to(cd))
    else:
        dl, ab = dl.to(qkv.dtype).to(cd), attn.to(qkv.dtype).to(cd)
    dq = torch.matmul(dl, k)
    dk = torch.matmul(dl.transpose(-1, -2), q)
    dv = torch.matmul(ab.transpose(-1, -2), gh)
    return torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(
        B, N, 3 * C).to(qkv.dtype)


def masked_attention_qkv_bwd_plain(qkv: torch.Tensor, mask: torch.Tensor,
                                   g: torch.Tensor, num_heads: int, scale: float,
                                   mask_fill: float = MASK_FILL) -> torch.Tensor:
    """K5's function, the VJP of :func:`masked_attention_qkv_plain` in qkv:
    qkv [B, N, 3C], mask [B, N], g [B, N, C] -> dqkv [B, N, 3C] in qkv.dtype.

    Explicit VJP in at least fp32 (the math of ``jax.vjp`` of
    ``_xla_masked_from_qkv``) in the TPU kernel's form
    (``_qkv_masked_full_bwd_kernel``), which the CUDA kernel follows:
    ``mask_fill`` ADDED to the logits where the pair mask is 0 (a masked key
    of a valid row exps to 0 as if replaced, and masked rows are zeroed, so
    at f64 it equals the XLA oracle's VJP); r0 = sum(dat * e) / sum(e) over
    the row, dl = attn * (dat - r0) * scale with attn already re-masked;
    every key's attn and dl rounded to qkv.dtype before the products (K7's
    form, :func:`masked_attention_tiled_bwd_plain`, keeps each tile's cls key
    in fp32)."""
    return _masked_bwd_plain(qkv, mask, g, num_heads, scale, mask_fill, 0)


def masked_attention_tiled_bwd_plain(qkv: torch.Tensor, mask: torch.Tensor,
                                     g: torch.Tensor, num_heads: int, scale: float,
                                     mask_fill: float = MASK_FILL,
                                     tile: int = 129) -> torch.Tensor:
    """K7's function, the VJP of :func:`masked_attention_tiled_plain` in
    qkv, in its TPU kernel's form (``_qkv_masked_bwd_kernel``): as
    :func:`masked_attention_qkv_bwd_plain` with each tile's cls-key attn and
    dl kept in fp32 (only the patch keys' are rounded to qkv.dtype). At f64
    it equals ``jax.vjp`` of ``_xla_masked_from_qkv``."""
    return _masked_bwd_plain(qkv, mask, g, num_heads, scale, mask_fill, tile)


def _check_args(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
                g: torch.Tensor = None, tile: int = 0, group: int = 0) -> int:
    """Shape checks shared by the wrappers; returns the head dim."""
    check_group(group)
    B, N, C3 = qkv.shape
    if C3 % (3 * num_heads):
        raise ValueError(f"qkv width {C3} is not 3 x heads ({num_heads}) x D")
    if mask.shape != (B, N):
        raise ValueError(f"mask {tuple(mask.shape)} != {(B, N)}")
    if g is not None and g.shape != (B, N, C3 // 3):
        raise ValueError(f"g {tuple(g.shape)} != {(B, N, C3 // 3)}")
    if tile and N % tile:
        raise ValueError(f"{N} tokens are not a whole number of {tile}-token tiles")
    return C3 // 3 // num_heads


def _kernel_inputs(name: str, qkv: torch.Tensor, mask: torch.Tensor, D: int,
                   g: torch.Tensor = None) -> torch.Tensor:
    """Check the CUDA tensors (qkv and g 16-byte aligned: the tensor-core
    kernels copy the head's rows with 16-byte cp.async); returns the mask as
    contiguous fp32."""
    N = qkv.shape[1]
    check_kernel_tensor(f"{name} qkv", qkv, 3, D, N, align=16)
    if g is not None:
        check_kernel_tensor(f"{name} g", g, 3, D, N, align=16)
    if mask.device != qkv.device:
        raise ValueError(f"mask on {mask.device}, qkv on {qkv.device}")
    return mask.to(torch.float32).contiguous()


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


MMA_MAX_HEAD_DIM = 128  # the widest head the tensor-core kernels dispatch


def _check_mma_head_dim(name: str, D: int) -> None:
    """Raise unless a tensor-core kernel takes head dim ``D``: its tiles are
    16 deep, so a multiple of 16 up to 128 (one template instance each)."""
    if D % 16 or not 0 < D <= MMA_MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} is not a multiple of 16 up to "
                         f"{MMA_MAX_HEAD_DIM}")


def check_k3_head_dim(D: int) -> None:
    """Raise unless K3's tensor-core kernel takes head dim ``D``."""
    _check_mma_head_dim("masked_attention_qkv", D)


TILED_MIN_TILE = 16  # K6's and K7's smallest tile: a 16-key tile holds at most one cls key


def _check_tiled_shape(name: str, D: int, tile: int) -> None:
    _check_mma_head_dim(name, D)
    if tile < TILED_MIN_TILE:
        raise ValueError(f"{name}: tile {tile} < {TILED_MIN_TILE} tokens")


def check_k6_shape(D: int, tile: int) -> None:
    """Raise unless K6's tensor-core kernel takes head dim ``D`` and
    ``tile``-token tiles: D a multiple of 16 up to 128, and tile >= 16, the
    shapes its backward K7 takes (:func:`check_k7_shape`), so that the
    autograd pair never runs a forward whose backward is refused."""
    _check_tiled_shape("masked_attention_tiled", D, tile)


def check_k5_head_dim(D: int) -> None:
    """Raise unless K5's tensor-core kernel takes head dim ``D`` (at every N
    up to 512)."""
    _check_mma_head_dim("masked_attention_qkv_bwd", D)


@_flops.counted(_flops.attention)
def masked_attention_qkv(qkv: torch.Tensor, mask: torch.Tensor,
                         num_heads: int, scale: float,
                         mask_fill: float = MASK_FILL, group: int = 0) -> torch.Tensor:
    """K3: masked attention from the raw qkv; ``mask`` [B, N] in any dtype.
    CUDA: the tensor-core kernel (``csrc/attention_fwd_mma.cuh``; qkv 16-byte
    aligned, :func:`check_k3_head_dim`), one sequence a block at ``group`` 0,
    ``group`` sequences a block otherwise (T6). CPU:
    :func:`masked_attention_qkv_plain` at any group."""
    D = _check_args(qkv, mask, num_heads, group=group)
    if qkv.device.type == "cpu":
        return masked_attention_qkv_plain(qkv, mask, num_heads, scale, mask_fill)
    check_k3_head_dim(D)
    mask32 = _kernel_inputs("masked_attention_qkv", qkv, mask, D)
    from editor_tpu_torch.ops import _build

    B, N, C3 = qkv.shape
    out = torch.empty((B, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    code = _build.library().editor_masked_attention(
        qkv.data_ptr(), mask32.data_ptr(), out.data_ptr(), B, N, num_heads, D,
        float(scale), float(mask_fill), group, _stream(qkv))
    _build.check(code, "masked_attention_qkv")
    count_launch(masked_attention_qkv, group)
    return out


masked_attention_qkv.launches = 0
masked_attention_qkv.variant_launches = 0


@_flops.counted(_flops.attention)
def masked_attention_tiled(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
                           scale: float, mask_fill: float = MASK_FILL,
                           tile: int = 129, group: int = 0) -> torch.Tensor:
    """K6: masked attention from the raw qkv over ``tile``-token tiles (N a
    multiple of ``tile``); ``mask`` [B, N] in any dtype. CUDA: the
    tensor-core kernel (``csrc/attention_fwd_mma.cuh``; qkv 16-byte aligned,
    :func:`check_k6_shape`), one sequence a block at ``group`` 0, ``group``
    sequences a block otherwise (the group sweep). CPU:
    :func:`masked_attention_tiled_plain` at any tile and group."""
    D = _check_args(qkv, mask, num_heads, tile=tile, group=group)
    if qkv.device.type == "cpu":
        return masked_attention_tiled_plain(qkv, mask, num_heads, scale, mask_fill, tile)
    check_k6_shape(D, tile)
    mask32 = _kernel_inputs("masked_attention_tiled", qkv, mask, D)
    from editor_tpu_torch.ops import _build

    B, N, C3 = qkv.shape
    out = torch.empty((B, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    code = _build.library().editor_masked_attention_tiled(
        qkv.data_ptr(), mask32.data_ptr(), out.data_ptr(), B, N, num_heads, D,
        float(scale), float(mask_fill), tile, group, _stream(qkv))
    _build.check(code, "masked_attention_tiled")
    count_launch(masked_attention_tiled, group)
    return out


masked_attention_tiled.launches = 0
masked_attention_tiled.variant_launches = 0


@_flops.counted(_flops.attention_bwd)
def masked_attention_qkv_bwd(qkv: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                             num_heads: int, scale: float,
                             mask_fill: float = MASK_FILL, group: int = 0) -> torch.Tensor:
    """K5: dqkv [B, N, 3C] from qkv, the mask [B, N] and the output's
    cotangent g [B, N, C]. CUDA: the tensor-core kernel
    (``csrc/attention_bwd_mma.cuh``; qkv and g 16-byte aligned,
    :func:`check_k5_head_dim`, a [B H, Np, Np] bf16 scratch pair where its
    chunked instance needs one: ``editor_masked_attention_bwd_scratch``
    gives Np), one sequence a block at ``group`` 0, ``group`` sequences a
    block otherwise (T6). CPU: :func:`masked_attention_qkv_bwd_plain` at any
    group."""
    D = _check_args(qkv, mask, num_heads, g, group=group)
    if qkv.device.type == "cpu":
        return masked_attention_qkv_bwd_plain(qkv, mask, g, num_heads, scale, mask_fill)
    check_k5_head_dim(D)
    mask32 = _kernel_inputs("masked_attention_qkv_bwd", qkv, mask, D, g)
    from editor_tpu_torch.ops import _build

    lib = _build.library()
    B, N, _ = qkv.shape
    side = ctypes.c_int()
    _build.check(lib.editor_masked_attention_bwd_scratch(N, D, ctypes.byref(side)),
                 "masked_attention_qkv_bwd")
    dqkv = torch.empty_like(qkv)
    scratch = [None, None]
    if side.value:  # per-(b, h) scratch of the rounded attn and dl
        scratch = [torch.empty((B * num_heads, side.value, side.value), dtype=qkv.dtype,
                               device=qkv.device) for _ in range(2)]
    code = lib.editor_masked_attention_bwd(
        qkv.data_ptr(), mask32.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in scratch),
        B, N, num_heads, D, float(scale), float(mask_fill), group, _stream(qkv))
    _build.check(code, "masked_attention_qkv_bwd")
    count_launch(masked_attention_qkv_bwd, group)
    return dqkv


masked_attention_qkv_bwd.launches = 0
masked_attention_qkv_bwd.variant_launches = 0


def check_k7_shape(D: int, tile: int) -> None:
    """Raise unless K7's CUDA kernel takes head dim ``D`` and ``tile``-token
    tiles: its tensor-core tiles are 16 deep, so D is a multiple of 16 up to
    128, and a 16-key tile holds at most one cls key, so tile >= 16."""
    _check_tiled_shape("masked_attention_tiled_bwd", D, tile)


def k7_scratch_stride(N: int) -> int:
    """Row stride (and rows) of K7's scratch maps: N rounded up to 16, so that
    every row starts 32-byte aligned and the padded rows and keys are there."""
    return (N + 15) // 16 * 16


@_flops.counted(_flops.attention_bwd)
def masked_attention_tiled_bwd(qkv: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                               num_heads: int, scale: float, mask_fill: float = MASK_FILL,
                               tile: int = 129) -> torch.Tensor:
    """K7: dqkv [B, N, 3C] of K6 from qkv, the mask [B, N] and the output's
    cotangent g [B, N, C]. CUDA: ``csrc/masked_attention_bwd.cu`` (bf16,
    contiguous, qkv and g 16-byte aligned, :func:`check_k7_shape`; a
    [B H, Np, Np] bf16 scratch pair, Np = :func:`k7_scratch_stride`, 0.98 GB
    at [128, 387]); CPU: :func:`masked_attention_tiled_bwd_plain`."""
    D = _check_args(qkv, mask, num_heads, g, tile=tile)
    if qkv.device.type == "cpu":
        return masked_attention_tiled_bwd_plain(qkv, mask, g, num_heads, scale, mask_fill,
                                                tile)
    check_k7_shape(D, tile)
    mask32 = _kernel_inputs("masked_attention_tiled_bwd", qkv, mask, D, g)
    from editor_tpu_torch.ops import _build

    B, N, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    # per-(b, h) scratch of the rounded attn and dl (masked_attention_bwd.cu)
    Np = k7_scratch_stride(N)
    pst = torch.empty((B * num_heads, Np, Np), dtype=qkv.dtype, device=qkv.device)
    dlst = torch.empty_like(pst)
    code = _build.library().editor_masked_attention_tiled_bwd(
        qkv.data_ptr(), mask32.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
        pst.data_ptr(), dlst.data_ptr(), B, N, num_heads, D, float(scale),
        float(mask_fill), tile, _stream(qkv))
    _build.check(code, "masked_attention_tiled_bwd")
    masked_attention_tiled_bwd.launches += 1
    return dqkv


masked_attention_tiled_bwd.launches = 0


class _MaskedAttention(torch.autograd.Function):
    """tile 0: K3 forward, K5 backward; tile > 0: K6 forward, K7 backward.
    No gradient for the mask."""

    @staticmethod
    def forward(ctx, qkv, mask, num_heads, scale, mask_fill, tile):
        ctx.save_for_backward(qkv, mask)
        ctx.args = (num_heads, scale, mask_fill)
        ctx.tile = tile
        if tile:
            return masked_attention_tiled(qkv, mask, *ctx.args, tile)
        return masked_attention_qkv(qkv, mask, *ctx.args)

    @staticmethod
    def backward(ctx, g_out):
        qkv, mask = ctx.saved_tensors
        g_out = g_out.contiguous()
        if ctx.tile:
            dqkv = masked_attention_tiled_bwd(qkv, mask, g_out, *ctx.args, ctx.tile)
        else:
            dqkv = masked_attention_qkv_bwd(qkv, mask, g_out, *ctx.args)
        return dqkv, None, None, None, None, None


def masked_attention_qkv_fn(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
                            scale: float, mask_fill: float = MASK_FILL) -> torch.Tensor:
    """:func:`masked_attention_qkv` under autograd, with
    :func:`masked_attention_qkv_bwd` as its backward."""
    return _MaskedAttention.apply(qkv, mask.detach(), num_heads, scale, mask_fill, 0)


def masked_attention_tiled_fn(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
                              scale: float, mask_fill: float = MASK_FILL,
                              tile: int = 129) -> torch.Tensor:
    """:func:`masked_attention_tiled` under autograd, with
    :func:`masked_attention_tiled_bwd` as its backward."""
    if tile <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
    return _MaskedAttention.apply(qkv, mask.detach(), num_heads, scale, mask_fill, tile)


def masked_attention_route(n_tokens: int, tile: int) -> str:
    """The kernel pair the JAX dispatch (``masked_attention_from_qkv``,
    editor_tpu/ops/masked_attention.py:505-514) gives a sequence of
    ``n_tokens`` cut into ``tile``-token tiles: ``"tiled"`` (K6/K7) when it is
    a whole number of 1 + 128k-token tiles, else ``"full"`` (K3/K5) up to
    512 tokens, else ``"plain"`` (where JAX takes its XLA path). With the
    tail uncompacted at ``MODEL.STRIDE_SIZE`` 12, a modality's 211 tokens
    are ``"full"`` and the 633-token joint sequence is ``"plain"``, as in
    JAX."""
    if tile and n_tokens % tile == 0 and (tile - 1) % 128 == 0:
        return "tiled"
    if n_tokens <= MAX_TOKENS:
        return "full"
    return "plain"


def masked_attention_from_qkv(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
                              scale: float, mask_fill: float = MASK_FILL,
                              tile: int = 129, use_kernels: bool = True,
                              seq_mesh=None) -> torch.Tensor:
    """Masked attention from the raw qkv under autograd, through the kernel
    pair :func:`masked_attention_route` picks (``use_kernels=False``: the
    plain version of the XLA oracle's math, :func:`masked_attention_qkv_plain`,
    differentiated by autograd). qkv [B, N, 3C], mask [B, N] -> [B, N, C].

    ``seq_mesh`` (a ``DeviceMesh`` with a 'seq' dimension, or a process
    group) of more than one rank: the masked ring over it
    (``parallel.ring.ring_masked_attention``: each rank its sequence block
    of q, k and v, the outputs all-gathered with autograd), as JAX's."""
    if seq_mesh is not None:
        from editor_tpu_torch.parallel.mesh import axis_group
        from editor_tpu_torch.parallel.ring import ring_masked_attention
        if axis_group(seq_mesh, "seq")[1] > 1:
            q, k, v = (t.to(qkv.dtype) for t in _heads(qkv, num_heads))
            out = ring_masked_attention(q, k, v, mask, seq_mesh, scale, mask_fill)
            return _merge_heads(out)
    route = masked_attention_route(qkv.shape[1], tile) if use_kernels else "plain"
    if route == "tiled":
        return masked_attention_tiled_fn(qkv, mask, num_heads, scale, mask_fill, tile)
    if route == "full":
        return masked_attention_qkv_fn(qkv, mask, num_heads, scale, mask_fill)
    return masked_attention_qkv_plain(qkv, mask, num_heads, scale, mask_fill)
