"""Tensor parallelism of the ViT backbone: counterpart of
``editor_tpu/parallel/tp.py``.

Megatron's split of each backbone block over the mesh's 'model' group: the
qkv and fc1 Linears are column-parallel (a rank keeps its output rows of the
torch ``[out, in]`` weight and their bias), proj and fc2 row-parallel (a rank
keeps its input columns; the bias is added once, after the all-reduce); every
other parameter (LayerNorms, patch embed, cls and pos embeddings, the fusion
block, the heads, BN) stays replicated. The collectives are
``collectives.copy_to_group`` before qkv and fc1 and
``collectives.reduce_from_group`` after proj and fc2, so every replicated
parameter gets the same full gradient on every rank of a model group.

The fused qkv output is laid out ``[q heads | k heads | v heads]``, so a
contiguous split would give a rank all of q and half of k.
:func:`permute_qkv_params` reorders the qkv rows shard-major (``[q, k, v]`` of
heads ``0..H/t-1``, then of the next H/t heads, ...), so that rank s's block
is a self-contained qkv of its own H/t heads, on which the attention kernel K1
runs unchanged; the attention output stays in global head order, so proj
needs no permutation.

Checkpoints are written in the canonical layout (gathered over the model
group, un-permuted, the optimizer's slots with their parameters):
:func:`gather_state_dict`, :func:`gather_train_state`; a canonical one is
cut for a rank by :func:`shard_state_dict`, :func:`shard_train_state`
(:func:`permute_train_state` permutes a payload).
:func:`shard_editor` cuts a full model in place.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

# name -> the dim a rank's block is cut along (torch layout)
_SHARDED = re.compile(r"^BACKBONE\.base\.blocks\.\d+\.(attn\.qkv|attn\.proj|mlp\.fc1|mlp\.fc2)"
                      r"\.(weight|bias)$")
_QKV = re.compile(r"^BACKBONE\.base\.blocks\.\d+\.attn\.qkv\.(weight|bias)$")


def shard_dim(name: str) -> Optional[int]:
    """The dim along which ``name``'s tensor is cut over the model group:
    0 for the column-parallel qkv and fc1 (weight and bias), 1 for the
    row-parallel proj and fc2 weights; None for a replicated tensor (the
    row-parallel biases among them)."""
    m = _SHARDED.match(name)
    if m is None:
        return None
    layer, kind = m.groups()
    if layer in ("attn.qkv", "mlp.fc1"):
        return 0
    return 1 if kind == "weight" else None


def qkv_tp_permutation(num_heads: int, head_dim: int, tp: int) -> np.ndarray:
    """Row permutation pi with new_w[j] = w[pi[j]]: the flat
    ``[q_h* | k_h* | v_h*]`` qkv rows -> tp contiguous blocks, each
    ``[q | k | v]`` over H/tp heads (JAX's column permutation)."""
    H, D = num_heads, head_dim
    C = H * D
    if H % tp:
        raise ValueError(f"num_heads {H} not divisible by tp {tp}")
    hl = H // tp
    idx = []
    for s in range(tp):
        for part in range(3):
            for h in range(s * hl, (s + 1) * hl):
                idx.extend(range(part * C + h * D, part * C + (h + 1) * D))
    return np.asarray(idx, dtype=np.int64)


def _qkv_perm(t: torch.Tensor, num_heads: int, tp: int, inverse: bool) -> torch.Tensor:
    perm = qkv_tp_permutation(num_heads, t.shape[0] // (3 * num_heads), tp)
    if inverse:
        perm = np.argsort(perm)
    return t[torch.from_numpy(perm).to(t.device)]


def permute_qkv_params(sd: Dict[str, Any], num_heads: int, tp: int,
                       inverse: bool = False) -> Dict[str, Any]:
    """A copy of ``sd`` (a state dict, or any dict keyed by parameter names)
    with every backbone block's qkv weight rows and bias in the shard-major
    layout (or back, ``inverse=True``). Other entries are shared."""
    if tp <= 1:
        return dict(sd)
    return {k: (_qkv_perm(v, num_heads, tp, inverse) if _QKV.match(k) else v)
            for k, v in sd.items()}


def _cut(sd: Dict[str, Any], tp: int, rank: int) -> Dict[str, Any]:
    """Block ``rank`` of tp (cloned) of every sharded tensor of ``sd``."""
    out = {}
    for k, v in sd.items():
        d = shard_dim(k)
        if d is None:
            out[k] = v
            continue
        if v.shape[d] % tp:
            raise ValueError(f"{k}: dim {d} of {tuple(v.shape)} not divisible by tp {tp}")
        out[k] = v.chunk(tp, dim=d)[rank].clone()
    return out


def _gathered(sd: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Every sharded tensor of ``sd`` all-gathered over ``group`` and
    concatenated in rank order (a collective), on the tensor's device (a
    host tensor goes through the current card under NCCL)."""
    import torch.distributed as dist

    from editor_tpu_torch.parallel.collectives import _all_gather0
    card = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend(group) == "nccl" else None)
    out = {}
    for k, v in sd.items():
        d = shard_dim(k)
        if d is not None:
            with torch.no_grad():
                x = v.detach()
                x = x if card is None or x.is_cuda else x.to(card)
                v = torch.cat(list(_all_gather0(x, group).unbind(0)), dim=d).to(v.device)
        out[k] = v
    return out


def shard_state_dict(sd: Dict[str, Any], num_heads: int, tp: int, rank: int
                     ) -> Dict[str, Any]:
    """Model rank ``rank``'s state dict of a canonical (full, un-permuted)
    one: qkv permuted shard-major, then every sharded tensor cut into tp
    blocks along its :func:`shard_dim` and block ``rank`` kept (cloned)."""
    if tp <= 1:
        return dict(sd)
    return _cut(permute_qkv_params(sd, num_heads, tp), tp, rank)


def gather_state_dict(sd: Dict[str, torch.Tensor], num_heads: int, group
                      ) -> Dict[str, torch.Tensor]:
    """The canonical state dict of a model group's shards (a collective:
    every rank of ``group`` calls it with its own ``sd``): each sharded
    tensor all-gathered and concatenated in rank order, qkv un-permuted."""
    import torch.distributed as dist
    return permute_qkv_params(_gathered(sd, group), num_heads, dist.get_world_size(group),
                              inverse=True)


def slot_names(model: nn.Module, optimizer) -> List[List[str]]:
    """The parameter name of each optimizer slot, per group in group order
    (the layout of ``Optimizer.state_dict()['state']``)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [[names[id(p)] for p in g["params"]] for g in optimizer.groups]


def _map_slots(opt_sd: Dict[str, Any], names: List[List[str]], fn) -> Dict[str, Any]:
    """``opt_sd`` with ``fn({name: slot})`` in place of each slot."""
    state = []
    for group_names, slots in zip(names, opt_sd["state"]):
        state.append({k: [fn({n: t})[n] for n, t in zip(group_names, ts)]
                      for k, ts in slots.items()})
    return dict(opt_sd, state=state)


def permute_train_state(payload: Dict[str, Any], names: List[List[str]], num_heads: int,
                        tp: int, inverse: bool = False) -> Dict[str, Any]:
    """A train-state payload (``utils.checkpoint.train_state``: ``model``, a
    state dict, and ``optimizer``, an ``Optimizer.state_dict()`` whose slots
    ``names`` names, :func:`slot_names`) with the qkv permutation applied to
    the parameters and to their SGD momentum or AdamW moments (or undone,
    ``inverse=True``)."""
    perm = lambda sd: permute_qkv_params(sd, num_heads, tp, inverse)
    return dict(payload, model=perm(payload["model"]),
                optimizer=_map_slots(payload["optimizer"], names, perm))


def gather_train_state(payload: Dict[str, Any], names: List[List[str]], num_heads: int,
                       group) -> Dict[str, Any]:
    """A rank's payload of shards -> the canonical one (a collective over
    the model ``group``): the parameters and their slots gathered, then
    un-permuted."""
    import torch.distributed as dist
    gathered = dict(payload, model=_gathered(payload["model"], group),
                    optimizer=_map_slots(payload["optimizer"], names,
                                         lambda sd: _gathered(sd, group)))
    return permute_train_state(gathered, names, num_heads, dist.get_world_size(group),
                               inverse=True)


def shard_train_state(payload: Dict[str, Any], names: List[List[str]], num_heads: int,
                      tp: int, rank: int) -> Dict[str, Any]:
    """The inverse of :func:`gather_train_state` for model rank ``rank``."""
    p = permute_train_state(payload, names, num_heads, tp)
    return dict(p, model=_cut(p["model"], tp, rank),
                optimizer=_map_slots(p["optimizer"], names, lambda sd: _cut(sd, tp, rank)))


@torch.no_grad()
def shard_editor(model: nn.Module, mesh) -> nn.Module:
    """Cut a full :class:`~editor_tpu_torch.models.editor.Editor` in place
    into this rank's Megatron shards over ``mesh``'s 'model' group
    (:func:`shard_state_dict`): each sharded parameter is replaced by a new
    ``nn.Parameter`` holding its block, so build the optimizer after this
    call. Every rank of the group must hold the same full model. Returns
    ``model``."""
    from editor_tpu_torch.parallel.mesh import model_rank, model_size
    tp, rank = model_size(mesh), model_rank(mesh)
    if tp <= 1:
        return model
    H = model.cfg.vit.num_heads
    full = {n: p for n, p in model.named_parameters() if shard_dim(n) is not None}
    C = model.cfg.vit.embed_dim
    if model.BACKBONE.base.blocks[0].attn.qkv.weight.shape[0] != 3 * C:
        raise ValueError("the backbone is already cut for tensor parallelism")
    cut = shard_state_dict(full, H, tp, rank)
    for name, block in cut.items():
        owner, attr = name.rsplit(".", 1)
        mod = model.get_submodule(owner)
        old = getattr(mod, attr)
        setattr(mod, attr, nn.Parameter(block.contiguous(), requires_grad=old.requires_grad))
    return model


def gather_editor_state(model: nn.Module, group) -> Dict[str, torch.Tensor]:
    """The canonical state dict of a model cut by :func:`shard_editor` (a
    collective over the model ``group``)."""
    return gather_state_dict(model.state_dict(), model.cfg.vit.num_heads, group)

