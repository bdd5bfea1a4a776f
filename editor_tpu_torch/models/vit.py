"""ViT backbone for object ReID (eval forward).

Counterpart of ``editor_tpu/models/vit.py``: patch embed (a strided conv),
cls token, learned pos embed, SIE camera/view embedding scaled by
``sie_xishu``, pre-LN blocks with erf-GELU and LN eps 1e-6, final norm, and
the attention rollout that SFTS consumes. Public layout as in JAX: NHWC
images in, ``[B, 1+P, C]`` tokens and a ``[B, H, P]`` rollout out.

Each block's attention runs from the raw ``[B, N, 3C]`` qkv through K1
(:func:`~editor_tpu_torch.ops.attention_qkv`), which writes that layer's
probabilities into one stacked ``[L, B, H, N, N]`` buffer; K2
(:func:`~editor_tpu_torch.ops.rollout_chain`) reduces the stack. With
``use_kernels=False`` the plain versions run instead, on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from editor_tpu_torch import ops
from editor_tpu_torch.models.layers import LayerNorm, Linear, gelu, new_param


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: Tuple[int, int] = (256, 128)
    patch_size: int = 16
    stride_size: Tuple[int, int] = (16, 16)
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    camera: int = 0
    view: int = 0
    sie_xishu: float = 3.0
    ln_eps: float = 1e-6
    num_fc_classes: int = 1000  # legacy ImageNet head kept for checkpoint parity
    # activation recompute options of the JAX train step (training is not
    # ported yet; kept so configs transfer)
    remat: bool = False
    remat_policy: str = "block"
    remat_skip_last: int = 0

    @property
    def num_y(self) -> int:
        return (self.img_size[0] - self.patch_size) // self.stride_size[0] + 1

    @property
    def num_x(self) -> int:
        return (self.img_size[1] - self.patch_size) // self.stride_size[1] + 1

    @property
    def num_patches(self) -> int:
        return self.num_x * self.num_y

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def scale(self) -> float:
        return self.qk_scale if self.qk_scale is not None else self.head_dim ** -0.5


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.proj = nn.Module()
        self.proj.weight = new_param(cfg.embed_dim, cfg.in_chans, p, p, device=device)
        self.proj.bias = new_param(cfg.embed_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, P, C], row-major over the patch grid."""
        w = self.proj.weight.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.cfg.stride_size)
        y = y + self.proj.bias.to(x.dtype)[:, None, None]
        return y.flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        C = cfg.embed_dim
        self.qkv = Linear(C, 3 * C, bias=cfg.qkv_bias, device=device)
        self.proj = Linear(C, C, device=device)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        hid = int(cfg.embed_dim * cfg.mlp_ratio)
        self.fc1 = Linear(cfg.embed_dim, hid, device=device)
        self.fc2 = Linear(hid, cfg.embed_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm1 = LayerNorm(cfg.embed_dim, cfg.ln_eps, device=device)
        self.attn = Attention(cfg, device=device)
        self.norm2 = LayerNorm(cfg.embed_dim, cfg.ln_eps, device=device)
        self.mlp = Mlp(cfg, device=device)

    def forward(self, x: torch.Tensor, probs_out: torch.Tensor,
                use_kernels: bool) -> torch.Tensor:
        """Pre-LN block; writes this layer's attention maps into probs_out."""
        cfg = self.cfg
        qkv = self.attn.qkv(self.norm1(x))
        if use_kernels:
            out, _ = ops.attention_qkv(qkv, cfg.num_heads, cfg.scale, probs_out)
        else:
            out, probs = ops.attention_qkv_plain(qkv, cfg.num_heads, cfg.scale, True)
            probs_out.copy_(probs)
        x = x + self.attn.proj(out)
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Module):
    """Parameter names follow the reference ``Trans`` (``BACKBONE.base.*``)."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        C = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg, device=device)
        self.cls_token = new_param(1, 1, C, device=device)
        self.pos_embed = new_param(1, cfg.num_patches + 1, C, device=device)
        n_sie = self._sie_rows()
        self.sie_embed = new_param(n_sie, 1, C, device=device) if n_sie else None
        self.blocks = nn.ModuleList(Block(cfg, device=device) for _ in range(cfg.depth))
        self.norm = LayerNorm(C, cfg.ln_eps, device=device)
        self.fc = Linear(C, cfg.num_fc_classes, device=device)

    def _sie_rows(self) -> int:
        cfg = self.cfg
        if cfg.camera > 1 and cfg.view > 1:
            return cfg.camera * cfg.view
        if cfg.camera > 1:
            return cfg.camera
        if cfg.view > 1:
            return cfg.view
        return 0

    def embed(self, x: torch.Tensor, camera_id: Optional[torch.Tensor] = None,
              view_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Patchify + cls token + pos embed + SIE (``vit_embed``)."""
        cfg = self.cfg
        tokens = self.patch_embed(x)
        B = tokens.shape[0]
        cls = self.cls_token.to(tokens.dtype).expand(B, 1, cfg.embed_dim)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        if self.sie_embed is None:
            return tokens
        if cfg.camera > 1 and cfg.view > 1:
            row = _ids(camera_id, "camera") * cfg.view + _ids(view_id, "view")
        elif cfg.camera > 1:
            row = _ids(camera_id, "camera")
        else:
            row = _ids(view_id, "view")
        return tokens + cfg.sie_xishu * self.sie_embed[row].to(tokens.dtype)

    def forward(self, x: torch.Tensor, camera_id: Optional[torch.Tensor] = None,
                view_id: Optional[torch.Tensor] = None, use_kernels: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, H, W, 3] NHWC -> (tokens [B, 1+P, C], rollout [B, H, P]).

        The rollout is at least fp32: the patch part of the cls row of
        A_{L-1} @ ... @ A_0 (SFTS's ``last_map[:, :, 0, 1:]``)."""
        cfg = self.cfg
        tokens = self.embed(x, camera_id, view_id)
        B, N, _ = tokens.shape
        probs = torch.empty((cfg.depth, B, cfg.num_heads, N, N), dtype=tokens.dtype,
                            device=tokens.device)
        for l, blk in enumerate(self.blocks):
            tokens = blk(tokens, probs[l], use_kernels)
        tokens = self.norm(tokens)
        rollout = (ops.rollout_chain(probs) if use_kernels
                   else ops.rollout_from_probs_plain(probs))
        return tokens, rollout


def _ids(ids: Optional[torch.Tensor], what: str) -> torch.Tensor:
    if ids is None:
        raise ValueError(f"this backbone has a SIE {what} embedding: pass {what} ids")
    return ids.long()
