"""ViT backbone for object ReID (eval and training forward).

Counterpart of ``editor_tpu/models/vit.py``: patch embed (a strided conv),
cls token, learned pos embed, SIE camera/view embedding scaled by
``sie_xishu``, pre-LN blocks with erf-GELU and LN eps 1e-6, final norm, and
the attention rollout that SFTS consumes. Public layout as in JAX: NHWC
images in, ``[B, 1+P, C]`` tokens and a ``[B, H, P]`` rollout out.

Each block's attention runs from the raw ``[B, N, 3C]`` qkv through K1
(:func:`~editor_tpu_torch.ops.attention_qkv_fn`, whose backward is K4),
which writes that layer's probabilities into one stacked ``[L, B, H, N, N]``
buffer outside the autograd graph; K2
(:func:`~editor_tpu_torch.ops.rollout_chain`) reduces the stack. With
``use_kernels=False`` the plain versions run instead, on any device, and
autograd differentiates them directly.

Training adds per-sample stochastic depth at ``linspace(0, drop_path_rate,
depth)`` per block (one fp32 uniform draw per sample and branch, drawn for
all blocks up front from the caller's generator), dropout where
``drop_rate > 0``, and attention dropout where ``attn_drop_rate > 0``: no
kernel has it, so the block then takes the plain attention (as JAX leaves
its kernel for the XLA path; K1 and K4 do not launch in such a step) and
the rollout reads the dropped weights, as JAX's does.

With ``remat`` the first ``depth - remat_skip_last`` blocks recompute their
activations in the backward under JAX's policies: ``block`` keeps the
block's input alone; ``dots`` the Linear products (qkv, proj, fc1) and
recomputes the attention (K1 launches again); ``names`` qkv, the attention
output and fc1; ``attn_out`` the attention output and fc1, its qkv rebuilt
by its product for K4 (``names`` and ``attn_out`` launch K1 once). Each
policy is a chain of ``torch.utils.checkpoint`` regions whose inputs are
exactly what JAX's saves; a region's recompute re-runs the region (torch
recomputes up to the last tensor it saved), so a product JAX's dead-code
pass skips may run again. The recompute replays what the forward drew from
the caller's generator (:func:`_checkpoint`), so dropout and attention
dropout compose with every policy and give the gradients of the step
without remat.

Tensor parallelism (``tp`` a :class:`TPGroup`, from ``Editor.forward(
tp_mesh=)``): the blocks hold this rank's Megatron shards
(``parallel.tp.shard_editor``): qkv and fc1 column-parallel behind
``copy_to_group``, proj and fc2 row-parallel before ``reduce_from_group``
(each partial product rounded to the compute dtype before the sum, as
JAX's) with their biases added once after it. K1 (with its probs) and K4 run on the
rank's H/tp heads of the shard-major qkv block, K2 reduces those heads'
probs, and the rollout rows are all-gathered over the model group into
``[B, H, P]`` in global head order. Every rank of the group draws the same
drop-path and dropout values (the same generator; a dropout on the hidden
shard draws the full width and keeps its columns).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from editor_tpu_torch import ops
from editor_tpu_torch.ops._checks import compute_dtype
from editor_tpu_torch.models.layers import (LayerNorm, Linear, drop_path, dropout, gelu,
                                            linear, new_param)
from editor_tpu_torch.parallel.collectives import copy_to_group, reduce_from_group


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
    # activation recompute of the train step under JAX's policies (block,
    # dots, names, attn_out) for the first depth - remat_skip_last blocks
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


def vit_base_config(**kw) -> ViTConfig:
    """vit_base_patch16_224 factory args (reference: vit_pytorch.py:693-701)."""
    return ViTConfig(embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0,
                     qkv_bias=True, **kw)


def vit_small_config(**kw) -> ViTConfig:
    """vit_small_patch16_224 (reference: vit_pytorch.py:704-714): its qk
    scale is 768^-0.5, not head_dim^-0.5."""
    kw.setdefault("qk_scale", 768 ** -0.5)
    return ViTConfig(embed_dim=768, depth=8, num_heads=8, mlp_ratio=3.0,
                     qkv_bias=False, **kw)


def deit_small_config(**kw) -> ViTConfig:
    """deit_small_patch16_224 (reference: vit_pytorch.py:717-727)."""
    return ViTConfig(embed_dim=384, depth=12, num_heads=6, mlp_ratio=4.0,
                     qkv_bias=True, **kw)


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """A model group of tensor parallelism: its process group, size and
    this rank's index in it."""
    group: Any
    size: int
    rank: int


def tp_group(mesh) -> Optional[TPGroup]:
    """The :class:`TPGroup` of a ('data', 'model') mesh whose model axis is
    above 1, else None (JAX's ``tp_mesh.shape.get("model", 1) > 1``)."""
    from editor_tpu_torch.parallel.mesh import model_group, model_rank, model_size
    if model_size(mesh) <= 1:
        return None
    return TPGroup(model_group(mesh), model_size(mesh), model_rank(mesh))


def _row_parallel(x: torch.Tensor, lin: Linear, tp: TPGroup) -> torch.Tensor:
    """A row-parallel Linear: this rank's partial product in x's dtype,
    summed over the group, then the bias once (JAX's GSPMD form: each
    partial is rounded to x's dtype before the all-reduce)."""
    y = reduce_from_group(linear(x, lin.weight), tp.group)
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


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

    def hidden(self, x: torch.Tensor, tp: Optional[TPGroup] = None) -> torch.Tensor:
        """fc1's output (before the GELU): JAX's checkpoint name ``fc1``."""
        return self.fc1(x if tp is None else copy_to_group(x, tp.group))

    def out(self, f: torch.Tensor, rate: float = 0.0,
            generator: Optional[torch.Generator] = None,
            tp: Optional[TPGroup] = None) -> torch.Tensor:
        """GELU, dropout, fc2, dropout from fc1's output ``f``."""
        y = gelu(f)
        if tp is None:
            return dropout(self.fc2(dropout(y, rate, generator)), rate, generator)
        w = y.shape[-1]
        y = dropout(y, rate, generator, width=w * tp.size, offset=w * tp.rank)
        return dropout(_row_parallel(y, self.fc2, tp), rate, generator)


def _attention_dropped(qkv: torch.Tensor, num_heads: int, scale: float, rate: float,
                       generator: Optional[torch.Generator]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention with dropout on its softmax weights (JAX's XLA path in
    training with ``attn_drop_rate > 0``; no kernel has it): qkv [B, N, 3C]
    -> (out [B, N, C], probs [B, H, N, N]). At-least-fp32 logits and
    softmax, the weights dropped (inverted, drawn from ``generator``), cast
    to qkv's dtype before the p.v product; the probs the rollout reads are
    the dropped weights, as JAX's."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    cd = compute_dtype(qkv.dtype)
    q, k, v = qkv.reshape(B, N, 3, num_heads, C // num_heads).permute(2, 0, 3, 1, 4).to(cd)
    attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    probs = dropout(attn, rate, generator).to(qkv.dtype)
    out = torch.matmul(probs.to(cd), v).to(qkv.dtype)
    return out.transpose(1, 2).reshape(B, N, C), probs


def _checkpoint(fn, *args, generator: Optional[torch.Generator] = None):
    """``torch.utils.checkpoint`` of ``fn(*args)`` whose recompute draws
    what the forward drew from ``generator``: its state at the call is
    replayed for the recompute, and the generator is put back where it was
    before the recompute (``preserve_rng_state`` covers only the default
    generators)."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False)
    entry = generator.get_state()
    calls = []

    def run(*a):
        calls.append(None)
        if len(calls) == 1:  # the forward
            return fn(*a)
        left = generator.get_state()
        generator.set_state(entry)
        try:
            return fn(*a)
        finally:  # also when the recompute stops early
            generator.set_state(left)

    return checkpoint(run, *args, use_reentrant=False)


@contextlib.contextmanager
def _recomputed_saves(recompute):
    """Every tensor autograd saves inside the block is dropped and rebuilt
    by ``recompute()`` when the backward reads it (one checkpointed tensor:
    the attention function's qkv under the ``attn_out`` policy)."""
    def unpack(_):
        with torch.no_grad():
            return recompute()

    with torch.autograd.graph.saved_tensors_hooks(lambda t: None, unpack):
        yield


REMAT_POLICIES = ("block", "dots", "names", "attn_out")


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm1 = LayerNorm(cfg.embed_dim, cfg.ln_eps, device=device)
        self.attn = Attention(cfg, device=device)
        self.norm2 = LayerNorm(cfg.embed_dim, cfg.ln_eps, device=device)
        self.mlp = Mlp(cfg, device=device)

    def forward(self, x: torch.Tensor, probs_out: torch.Tensor, use_kernels: bool,
                rate: float = 0.0, u: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                tp: Optional[TPGroup] = None, training: bool = False,
                remat: Optional[str] = None) -> torch.Tensor:
        """Pre-LN block; writes this layer's attention maps into probs_out.

        Training: ``u`` [2, B, 1, 1] holds the drop-path draws of the two
        branches at this block's ``rate``; ``generator`` feeds dropout and,
        with ``attn_drop_rate > 0``, the attention's (the plain attention
        then, as JAX leaves its kernel). ``tp``: the block holds its shards;
        ``probs_out`` is [B, H/tp, N, N]. ``remat``: the activation
        recompute policy (:data:`REMAT_POLICIES`), None for none; each keeps
        what JAX's policy saves (``vit_apply``) and recomputes the rest."""
        cfg = self.cfg
        heads = cfg.num_heads if tp is None else cfg.num_heads // tp.size
        drop_attn = training and cfg.attn_drop_rate > 0
        u0, u1 = (None, None) if u is None else (u[0], u[1])

        def qkv_of(x):  # LN, qkv: JAX's checkpoint name ``qkv``
            h = self.norm1(x)
            return self.attn.qkv(h if tp is None else copy_to_group(h, tp.group))

        def attend(qkv):  # JAX's ``attn_out``
            if drop_attn:
                out, probs = _attention_dropped(qkv, heads, cfg.scale, cfg.attn_drop_rate,
                                                generator)
            elif use_kernels:
                return ops.attention_qkv_fn(qkv, heads, cfg.scale, probs_out)[0]
            else:
                out, probs = ops.attention_qkv_plain(qkv, heads, cfg.scale, True)
            probs_out.copy_(probs.detach())  # the rollout stays outside the graph
            return out

        def proj_of(out):
            return self.attn.proj(out) if tp is None else _row_parallel(out, self.attn.proj, tp)

        def add_attn(x, p):
            return x + drop_path(dropout(p, cfg.drop_rate, generator), rate, u0)

        def with_fc1(x1):  # (x1, fc1's output: JAX's ``fc1``)
            return x1, self.mlp.hidden(self.norm2(x1), tp)

        def mlp_of(f):
            return drop_path(self.mlp.out(f, cfg.drop_rate, generator, tp), rate, u1)

        def whole(x):
            x1, f = with_fc1(add_attn(x, proj_of(attend(qkv_of(x)))))
            return x1 + mlp_of(f)

        if remat is None:
            return whole(x)
        ck = functools.partial(_checkpoint, generator=generator)
        if remat == "block":  # the block's input alone
            return ck(whole, x)
        kernel_attn = use_kernels and not drop_attn  # K1/K4 save only qkv
        if remat == "dots":  # x and the Linear products; K1 recomputed
            qkv = ck(qkv_of, x)
            p = ck(lambda q: proj_of(attend(q)), qkv)
            x1, f = ck(lambda x, p: with_fc1(add_attn(x, p)), x, p)
        elif remat == "names":  # x, qkv, attn_out, fc1
            qkv = ck(qkv_of, x)
            out = attend(qkv) if kernel_attn else ck(attend, qkv)
            x1, f = ck(lambda x, o: with_fc1(add_attn(x, proj_of(o))), x, out)
        elif remat == "attn_out":  # x, attn_out, fc1; qkv recomputed by its product
            if kernel_attn:
                qkv = ck(qkv_of, x)
                with _recomputed_saves(lambda: qkv_of(x)):
                    out = attend(qkv)
            else:
                out = ck(lambda x: attend(qkv_of(x)), x)
            x1, f = ck(lambda x, o: with_fc1(add_attn(x, proj_of(o))), x, out)
        else:
            raise ValueError(f"unknown remat policy {remat!r}: one of {REMAT_POLICIES}")
        return x1 + ck(mlp_of, f)


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

    def run_blocks(self, tokens: torch.Tensor, l0: int, l1: int, probs: torch.Tensor,
                   use_kernels: bool = True, draws: Optional[torch.Tensor] = None,
                   tp: Optional[TPGroup] = None) -> torch.Tensor:
        """Blocks ``l0..l1-1`` on ``tokens`` [b, N, C] (one pipeline stage's
        work on one microbatch), each at its global layer index: block l
        writes its maps into ``probs[l - l0]`` ([l1 - l0, b, H(/tp), N, N])
        and, with ``draws`` ([depth, 2, b, 1, 1], these rows of the draws
        :meth:`forward` makes in training), applies drop path at its rate
        of ``linspace(0, drop_path_rate, depth)`` with ``draws[l]``."""
        cfg = self.cfg
        rates = torch.linspace(0.0, cfg.drop_path_rate, cfg.depth, dtype=torch.float64).tolist()
        for l in range(l0, l1):
            kw = {} if draws is None else {"rate": rates[l], "u": draws[l]}
            tokens = self.blocks[l](tokens, probs[l - l0], use_kernels, tp=tp, **kw)
        return tokens

    def forward(self, x: torch.Tensor, camera_id: Optional[torch.Tensor] = None,
                view_id: Optional[torch.Tensor] = None, use_kernels: bool = True,
                training: bool = False, generator: Optional[torch.Generator] = None,
                tp: Optional[TPGroup] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, H, W, 3] NHWC -> (tokens [B, 1+P, C], rollout [B, H, P]).

        The rollout is at least fp32: the patch part of the cls row of
        A_{L-1} @ ... @ A_0 (SFTS's ``last_map[:, :, 0, 1:]``). In training
        the random draws come from ``generator`` (on x's device). ``tp``:
        the blocks hold this rank's shards (``parallel.tp.shard_editor``)."""
        cfg = self.cfg
        heads = cfg.num_heads
        if tp is not None:
            if training and cfg.attn_drop_rate > 0:
                raise NotImplementedError("attn_drop_rate > 0 under tensor parallelism")
            if cfg.num_heads % tp.size:
                raise ValueError(f"num_heads {cfg.num_heads} not divisible by tp {tp.size}")
            heads = cfg.num_heads // tp.size
        qkv_rows = self.blocks[0].attn.qkv.weight.shape[0]
        if qkv_rows != 3 * heads * cfg.head_dim:
            raise ValueError(f"the backbone's qkv has {qkv_rows} rows, "
                             f"{3 * heads * cfg.head_dim} at tp {1 if tp is None else tp.size}: "
                             "cut a full model with parallel.tp.shard_editor and pass "
                             "tp_mesh= on every call")
        tokens = self.embed(x, camera_id, view_id)
        B, N, _ = tokens.shape
        if training:
            tokens = dropout(tokens, cfg.drop_rate, generator)
            rates = torch.linspace(0.0, cfg.drop_path_rate, cfg.depth,
                                   dtype=torch.float64).tolist()
            draws = torch.rand((cfg.depth, 2, B, 1, 1), generator=generator,
                               device=tokens.device, dtype=torch.float32)
        n_remat = (max(cfg.depth - cfg.remat_skip_last, 0)
                   if training and cfg.remat else 0)
        probs = torch.empty((cfg.depth, B, heads, N, N), dtype=tokens.dtype,
                            device=tokens.device)
        for l, blk in enumerate(self.blocks):
            # the probs slice rides in the closures: the recompute writes it
            # again, which a checkpointed input may not see
            kw = (dict(rate=rates[l], u=draws[l], generator=generator, training=True)
                  if training else {})
            tokens = blk(tokens, probs[l], use_kernels, tp=tp,
                         remat=cfg.remat_policy if l < n_remat else None, **kw)
        tokens = self.norm(tokens)
        rollout = (ops.rollout_chain(probs) if use_kernels
                   else ops.rollout_from_probs_plain(probs))
        if tp is not None:  # heads are independent in the chain: gather them
            from editor_tpu_torch.parallel.collectives import _all_gather0
            with torch.no_grad():
                g = _all_gather0(rollout, tp.group)  # [tp, B, H/tp, P]
            rollout = g.permute(1, 0, 2, 3).reshape(B, cfg.num_heads, -1)
        return tokens, rollout


def _ids(ids: Optional[torch.Tensor], what: str) -> torch.Tensor:
    if ids is None:
        raise ValueError(f"this backbone has a SIE {what} embedding: pass {what} ids")
    return ids.long()
