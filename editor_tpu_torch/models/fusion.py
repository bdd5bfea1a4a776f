"""HMA: the hierarchical masked aggregation fusion block.

Counterpart of ``editor_tpu/models/fusion.py``: per-modality masked
attention + masked MLP residual blocks (batched modality-major), a joint
masked block over the concatenated [RGB|NIR|TIR] tokens, output LayerNorm
and re-mask. Masking as in the reference: tokens multiplied by the mask
before qkv and fc1, logits filled with -65504 where ``mask_q * mask_k == 0``,
attention rows multiplied by the query mask. LayerNorm eps is torch's default
1e-5 and every Linear is bias-free. Attention goes through
:func:`~editor_tpu_torch.ops.masked_attention_from_qkv` with the tile JAX
passes (the per-modality length in the modality blocks, the mask's length in
the joint block): the uncompacted tail (1 + 128-token tiles) runs K6 with
K7 as its backward, the compact tail K3 with K5; with ``use_kernels=False``
the plain version of the XLA math. In training the OCFR loss
(:mod:`~editor_tpu_torch.models.ocfr`) runs on the refined per-modality cls
tokens and moves the ``memory_cls`` centers.

With ``num_experts`` > 0 the joint MLP is a GShard mixture of experts
(``blockmask_moe_init``; :mod:`~editor_tpu_torch.parallel.moe`): its
parameters are ``FUSE_block.moe_mlp.{router, w1, b1, w2, b2}`` in the JAX
layout (router [C, E], w1 [E, C, F], b1 [E, F], w2 [E, F, C], b2 [E, C]; the
reference has no MoE, so these names are the port's own), and the block also
returns the Switch load-balance loss. The routing runs over ``moe_mesh``'s
'expert' group with the experts sharded (``moe_ffn``), as ``moe_shards``
independent shards on one device, or over all the tokens; under
``batch_group`` each of the three is the global batch's. ``seq_mesh``: every
masked attention runs sequence-sharded over the mesh's 'seq' group as the
masked ring (``parallel.ring``).
"""

from __future__ import annotations

import operator
from typing import List, Optional, Tuple

import torch
from torch import nn

from editor_tpu_torch import ops
from editor_tpu_torch.models.layers import LayerNorm, Linear, gelu, new_param
from editor_tpu_torch.models.ocfr import ocfr_update_and_loss
from editor_tpu_torch.parallel import moe as moe_mod
from editor_tpu_torch.parallel.collectives import all_gather
from editor_tpu_torch.ops._checks import compute_dtype

LN_EPS = 1e-5  # torch nn.LayerNorm default (BlockMask uses the default)
MODALITY_NAMES = ("R", "N", "T")


class MaskedAttention(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, bias=False, device=device)
        self.proj = Linear(dim, dim, bias=False, device=device)


class MaskedMlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, bias=False, device=device)
        self.fc2 = Linear(hidden, dim, bias=False, device=device)


class ClassCenters(nn.Module):
    """OCFR class-center memory: training state, moved in place by
    :func:`~editor_tpu_torch.models.ocfr.ocfr_update_and_loss`."""

    def __init__(self, num_classes: int, dim: int, device=None):
        super().__init__()
        for name in ("RGB", "NIR", "TIR"):
            self.register_buffer(f"{name}_centers",
                                 torch.zeros(num_classes, dim, device=device))


def _tile_mask(mask: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """Repeat a [B, n, 1] mask along tokens when the sequence is a k x concat."""
    if mask.shape[1] != n_tokens:
        mask = mask.repeat(1, n_tokens // mask.shape[1], 1)
    return mask


def _attention(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int, tile: int,
               use_kernels: bool, seq_mesh=None) -> torch.Tensor:
    scale = (qkv.shape[-1] // 3 // num_heads) ** -0.5
    return ops.masked_attention_from_qkv(qkv, mask, num_heads, scale, ops.MASK_FILL, tile,
                                         use_kernels, seq_mesh=seq_mesh)


def _ln_modal(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over [M, B, n, C] with per-modality affine [M, C]."""
    cd = compute_dtype(x.dtype)
    y = torch.nn.functional.layer_norm(x.to(cd), x.shape[-1:], eps=LN_EPS)
    y = y * weight[:, None, None, :].to(cd) + bias[:, None, None, :].to(cd)
    return y.to(x.dtype)


def _linear_modal(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """[M, B, n, C] @ per-modality torch-layout weights [M, D, C]^T (no bias),
    as one batched matmul over [M, B*n, C]: a broadcast [M, 1, C, D] weight
    would be materialised B times by ``torch.matmul``."""
    M, B, n, C = x.shape
    y = torch.bmm(x.reshape(M, B * n, C), weight.to(x.dtype).transpose(1, 2))
    return y.reshape(M, B, n, -1)


class MoEMlp(nn.Module):
    """The MoE joint MLP's parameters (``moe_init``'s shapes, JAX layout)."""

    def __init__(self, dim: int, hidden: int, num_experts: int, device=None):
        super().__init__()
        E = num_experts
        self.router = new_param(dim, E, device=device)
        self.w1 = new_param(E, dim, hidden, device=device)
        self.b1 = new_param(E, hidden, device=device)
        self.w2 = new_param(E, hidden, dim, device=device)
        self.b2 = new_param(E, dim, device=device)

    def params(self) -> "moe_mod.MoEParams":
        return moe_mod.MoEParams(self.router, self.w1, self.b1, self.w2, self.b2)


class BlockMask(nn.Module):
    """Parameter names follow the reference ``BlockMask`` (``FUSE_block.*``);
    with ``num_experts`` > 0 the joint ``mlp`` is ``moe_mlp``."""

    def __init__(self, dim: int, num_classes: int, mlp_ratio: float = 4.0,
                 num_heads: int = 12, num_experts: int = 0, device=None):
        super().__init__()
        if 0 < num_experts < 2:
            raise ValueError(f"MOE_EXPERTS must be >= 2 (top-k routing with k=2), got "
                             f"{num_experts}; use MOE_EXPERTS 0 for the dense MLP")
        hidden = int(dim * mlp_ratio)
        self.num_heads = num_heads
        for mod in MODALITY_NAMES:
            setattr(self, f"norm{mod}", LayerNorm(dim, LN_EPS, device=device))
            setattr(self, f"attn{mod}", MaskedAttention(dim, device=device))
            setattr(self, f"norm{mod}_", LayerNorm(dim, LN_EPS, device=device))
            setattr(self, f"mlp{mod}", MaskedMlp(dim, hidden, device=device))
        self.norm1 = LayerNorm(dim, LN_EPS, device=device)
        self.attn1 = MaskedAttention(dim, device=device)
        self.norm2 = LayerNorm(dim, LN_EPS, device=device)
        if num_experts:
            self.moe_mlp = MoEMlp(dim, hidden, num_experts, device=device)
        else:
            self.mlp = MaskedMlp(dim, hidden, device=device)
        self.out_norm = LayerNorm(dim, LN_EPS, device=device)
        self.memory_cls = ClassCenters(num_classes, dim, device=device)

    def _stack(self, fmt: str, path: str, M: int) -> torch.Tensor:
        """One parameter of the first M per-modality modules, stacked: [M, ...]."""
        get = operator.attrgetter(path)
        return torch.stack([get(getattr(self, fmt.format(m))) for m in MODALITY_NAMES[:M]])

    def _modal_blocks(self, feats: List[torch.Tensor], mask: torch.Tensor,
                      use_kernels: bool, seq_mesh=None) -> List[torch.Tensor]:
        """The per-modality masked attention + MLP residual blocks, batched
        modality-major over a [M, B, n, C] stack (same math as M calls)."""
        X = torch.stack(feats)
        M, B, n, C = X.shape
        m4 = mask[None].to(X.dtype)                # [1, B, n, 1]
        mask_flat = mask[..., 0].repeat(M, 1)      # [M*B, n]
        y = _ln_modal(X, self._stack("norm{}", "weight", M),
                      self._stack("norm{}", "bias", M))
        qkv = _linear_modal(y * m4, self._stack("attn{}", "qkv.weight", M))
        out = _attention(qkv.reshape(M * B, n, 3 * C), mask_flat, self.num_heads, n,
                         use_kernels, seq_mesh)
        X = X + _linear_modal(out.reshape(M, B, n, C),
                              self._stack("attn{}", "proj.weight", M))
        y = _ln_modal(X, self._stack("norm{}_", "weight", M),
                      self._stack("norm{}_", "bias", M))
        h = gelu(_linear_modal(y * m4, self._stack("mlp{}", "fc1.weight", M)))
        X = X + _linear_modal(h, self._stack("mlp{}", "fc2.weight", M))
        return list(X.unbind(0))

    def forward(self, modal_feats: List[torch.Tensor], mask_patches: torch.Tensor,
                use_kernels: bool = True, labels: Optional[torch.Tensor] = None,
                ocfr_momentum: float = 0.8, batch_group=None, seq_mesh=None,
                moe_mesh=None, moe_shards: int = 1, valid_rows: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        """modal_feats: 2-3 per-modality [B, 1+P, C]; mask_patches: [B, P, 1]
        float union mask (no cls entry). Returns (fused [B, M(1+P), C], OCFR
        loss or None, MoE aux loss or None), ``blockmask_apply``'s tuple
        without the centers; in training (``labels`` [B] given) the OCFR
        loss is computed and the class centers move. With ``batch_group``
        the OCFR sees the global batch: the refined cls tokens are
        all-gathered with autograd, and ``labels`` are the global batch's;
        the MoE routes the global batch, in training and in eval, with or
        without ``moe_mesh`` or ``moe_shards`` (``valid_rows``: see
        :func:`moe_masked_mlp`)."""
        B = modal_feats[0].shape[0]
        dtype = modal_feats[0].dtype
        ones = torch.ones((B, 1, 1), dtype=mask_patches.dtype, device=mask_patches.device)
        mask = torch.cat([ones, mask_patches], dim=1)  # [B, 1+P, 1]
        refined = self._modal_blocks(modal_feats, mask, use_kernels, seq_mesh)
        ocfr_loss = None
        if labels is not None:
            mem = self.memory_cls
            cls = [f[:, 0] for f in refined]
            if batch_group is not None:
                cls = list(all_gather(torch.stack(cls, dim=1), batch_group).unbind(1))
            ocfr_loss = ocfr_update_and_loss(
                [mem.RGB_centers, mem.NIR_centers, mem.TIR_centers][:len(refined)],
                cls, labels, momentum=ocfr_momentum)

        x = torch.cat(refined, dim=1)
        m = _tile_mask(mask, x.shape[1]).to(dtype)
        qkv = self.attn1.qkv(self.norm1(x) * m)
        # the tile is the per-modality length, before the mask is repeated
        x = x + self.attn1.proj(_attention(qkv, m[..., 0], self.num_heads, mask.shape[1],
                                           use_kernels, seq_mesh))
        moe_aux = None
        if hasattr(self, "moe_mlp"):
            y, moe_aux = moe_masked_mlp(self.moe_mlp.params(), self.norm2(x), m,
                                        moe_mesh=moe_mesh, moe_shards=moe_shards,
                                        batch_group=batch_group, valid_rows=valid_rows)
            x = x + y
        else:
            x = x + self.mlp.fc2(gelu(self.mlp.fc1(self.norm2(x) * m)))
        fused = self.out_norm(x) * m
        return fused, ocfr_loss, moe_aux


def moe_masked_mlp(p: "moe_mod.MoEParams", x: torch.Tensor, m: torch.Tensor,
                   moe_mesh=None, moe_shards: int = 1, batch_group=None, k: int = 2,
                   capacity_factor: float = 2.0, valid_rows: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_masked_mlp``: the masked joint MLP as the GShard MoE over the
    B*N tokens of x [B, N, C] (m: the [B, N, 1] mask, multiplied in first).
    ``moe_mesh``: experts and tokens sharded over its 'expert' group
    (``moe_ffn``); else ``moe_shards`` S independent shards of T/S tokens,
    each with its own capacity (the meshed run's one-device oracle); else
    one routing over all the tokens. Under ``batch_group`` x is this rank's
    rows of a global batch and each form is the global batch's function
    (``parallel.moe``'s module docstring). ``valid_rows`` (the last form
    only): the (global) batch's rows past it are padding, last in order, so
    they take no real row's slot, and the capacity counts the real rows'
    tokens (the aux loss counts every row). Returns (y [B, N, C], aux
    loss)."""
    B, N, C = x.shape
    z = (x * m).reshape(B * N, C)
    if valid_rows is not None and (moe_mesh is not None or moe_shards != 1):
        raise ValueError("valid_rows= takes the routing over all the tokens, "
                         "not moe_mesh= or moe_shards=")
    if moe_mesh is not None:
        y, aux = moe_mod.moe_ffn(p, z, moe_mesh, k, capacity_factor, group=batch_group)
    elif moe_shards != 1:
        y, aux = moe_mod.moe_ffn_shards(p, z, moe_shards, k, capacity_factor,
                                        group=batch_group)
    else:
        cap = (None if valid_rows is None else
               moe_mod.capacity_of(valid_rows * N, p.router.shape[-1], k, capacity_factor))
        y, aux = moe_mod.moe_ffn_dense(p, z, k, capacity_factor, capacity=cap,
                                       group=batch_group)
    return y.reshape(B, N, C), aux
