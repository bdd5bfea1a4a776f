"""The EDITOR backbone through the pipeline: counterpart of
``editor_tpu/parallel/pipeline_vit.py`` (the reference's ``Pipe`` around a
real model, distributed/pipeline/sync/pipe.py:172).

The ViT's blocks are cut into S contiguous stages of depth/S blocks over
the mesh's 'stage' group and run through :func:`.pipeline.pipeline_apply`;
the patch embedding (every rank embeds all 3B rows of the modality-major
batch) and the tail (final LayerNorm, SFTS, fusion, BN-necks, OCFR, losses)
run replicated on every stage, so the tail sees the full batch as without
the pipeline. Each block runs as :meth:`VisionTransformer.run_blocks` runs
it: K1 writes its attention maps (K4 its backward; under ``remat`` K1 runs
again in the backward's recompute).

What crosses a stage boundary is (tokens [b, 1+P, C], the rollout product
[b, H, 1+P, 1+P] fp32 [, the drop-path draws [b, depth, 2]]): the rollout
A_L @ ... @ A_1 that SFTS needs is carried forward as the running product,
each block's maps folded in as ``prod = A_l.float() @ prod`` outside the
graph (the reference's Part_Attention recurrence, SFTS.py:148-152), from the
fp32 identity; the scan backbone's reverse chain (K2) would have to flow
backward through the stages, so K2 does not run here. Matmul associativity
makes the two equal up to rounding. The result's rollout is the cls row over
the patch keys, ``prod[:, :, 0, 1:]``.

Drop path: in training the backbone draws ``torch.rand((depth, 2, 3B, 1,
1))`` from the generator at the point :meth:`VisionTransformer.forward`
does, and each microbatch carries its rows, so with the same generator state
the pipelined backbone drops what the scan backbone drops, draw for draw.
At a drop-path rate of 0 the residual branches are added as they are, as
JAX's pipelined backbone adds them (the scan backbone rounds them through
fp32, a no-op at bf16 and fp32). Dropout is refused in training, as in JAX.

Tensor parallelism inside the stages (a mesh whose 'model' axis is above 1,
the model cut by ``parallel.tp.shard_editor``): each (stage, model) rank
runs its stage's blocks on its Megatron shards, K1 and K4 on H/tp heads; the
rollout product rides the model group on its heads dimension (heads are
independent in the chain) and the rollout rows are all-gathered at the end.

The model stays whole on every rank (the optimizer, checkpoints and
converters see the canonical layout); a rank computes only its stage's
blocks, and :meth:`PipelineBackbone.reduce_grads` makes the gradient whole
over the stage group before the optimizer step (``engine.train.
build_train_step(backbone=)``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from editor_tpu_torch.parallel import collectives as C
from editor_tpu_torch.parallel.mesh import axis_group, stage_rank, stage_size
from editor_tpu_torch.parallel.pipeline import is_recomputing, pipeline_apply

# the parameters the pipeline's own graph reaches: the embedding (stage 0)
# and the blocks (their stage); every other one is the replicated tail's
_PIPELINE_SIDE = ("BACKBONE.base.patch_embed.", "BACKBONE.base.cls_token",
                  "BACKBONE.base.pos_embed", "BACKBONE.base.sie_embed",
                  "BACKBONE.base.blocks.")


def make_stage_fn(vit, l0: int, l1: int, use_kernels: bool, drop_path: bool,
                  tp=None) -> Callable:
    """``stage_fn(blocks, act)`` for :func:`pipeline_apply`: blocks ``l0..l1-1``
    of the :class:`VisionTransformer` ``vit`` on the microbatch's tokens,
    each block's maps folded into the carried rollout product in fp32 (not
    in the backward's recompute, where the product is not used).
    ``act`` is (tokens, prod) or, with ``drop_path``, (tokens, prod, u), u
    [b, depth, 2] the rows' drop-path draws. ``tp``: a ``TPGroup`` (the
    blocks hold its shards)."""
    cfg = vit.cfg
    heads = cfg.num_heads if tp is None else cfg.num_heads // tp.size

    def stage_fn(blocks: nn.Module, act):
        del blocks  # the same modules as vit.blocks[l0:l1]
        tokens, prod = act[0], act[1]
        b, N, _ = tokens.shape
        probs = torch.empty((l1 - l0, b, heads, N, N), dtype=tokens.dtype,
                            device=tokens.device)
        draws = act[2].permute(1, 2, 0)[..., None, None] if drop_path else None
        tokens = vit.run_blocks(tokens, l0, l1, probs, use_kernels, draws, tp)
        if not is_recomputing():  # the recompute's product would go unused
            with torch.no_grad():
                for k in range(l1 - l0):
                    prod = torch.matmul(probs[k].float(), prod)
        return (tokens, prod, act[2]) if drop_path else (tokens, prod)

    return stage_fn


class PipelineBackbone:
    """The ``backbone`` of ``Editor.forward`` and ``build_train_step``:
    ``(model, cfg, mods, cam, view, training, generator) -> (toks, rolls)``
    per modality, the contract of ``Editor.forward``'s own backbone pass
    (``models.editor``), through the pipeline over ``mesh``."""

    def __init__(self, mesh, num_microbatches: int, remat: bool = True,
                 model_axis: str = "model"):
        self.mesh, self.num_microbatches, self.remat = mesh, num_microbatches, remat
        self.model_axis = model_axis
        self.S, self.stage = stage_size(mesh), stage_rank(mesh)

    def _tp(self):
        from editor_tpu_torch.models.vit import TPGroup
        names = getattr(self.mesh, "mesh_dim_names", None) or ()
        if self.model_axis not in names:
            return None
        pg, size = axis_group(self.mesh, self.model_axis)
        if size <= 1:
            return None
        return TPGroup(pg, size, self.mesh.get_local_rank(self.model_axis))

    def __call__(self, model, cfg, mods: List[torch.Tensor], cam: Optional[torch.Tensor],
                 view: Optional[torch.Tensor], training: bool,
                 generator: Optional[torch.Generator]
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        vit = model.BACKBONE.base
        vcfg = cfg.vit
        S, tp = self.S, self._tp()
        if vcfg.depth % S:
            raise ValueError(f"depth {vcfg.depth} not divisible by stage={S}")
        if tp is not None and vcfg.num_heads % tp.size:
            raise ValueError(f"num_heads {vcfg.num_heads} not divisible by "
                             f"{self.model_axis}={tp.size}")
        if training and (vcfg.drop_rate > 0 or vcfg.attn_drop_rate > 0):
            raise NotImplementedError(
                "pipeline backbone does not support dropout (drop_rate/attn_drop_rate > 0): "
                "set MODEL.DROP_OUT / MODEL.ATT_DROP_RATE to 0, or train without pipeline "
                "parallelism")
        heads = vcfg.num_heads if tp is None else vcfg.num_heads // tp.size
        if vit.blocks[0].attn.qkv.weight.shape[0] != 3 * heads * vcfg.head_dim:
            raise ValueError("the backbone's qkv does not match the mesh's model axis: cut "
                             "a full model with parallel.tp.shard_editor")
        per = vcfg.depth // S
        l0 = self.stage * per
        n_mod, B = len(mods), mods[0].shape[0]
        tokens = vit.embed(torch.cat(mods), None if cam is None else cam.repeat(n_mod),
                           None if view is None else view.repeat(n_mod))
        B3, N, _ = tokens.shape
        eye = torch.eye(N, dtype=torch.float32, device=tokens.device).expand(B3, heads, N, N)
        act: tuple = (tokens, eye)
        use_dp = False
        if training:  # the scan backbone's draws, at its point in the stream
            draws = torch.rand((vcfg.depth, 2, B3, 1, 1), generator=generator,
                               device=tokens.device, dtype=torch.float32)
            use_dp = vcfg.drop_path_rate > 0
            if use_dp:
                act = act + (draws.permute(2, 0, 1, 3, 4).reshape(B3, vcfg.depth, 2),)
        blocks = vit.blocks[l0:l0 + per]
        out = pipeline_apply(make_stage_fn(vit, l0, l0 + per, cfg.use_pallas, use_dp, tp),
                             blocks, act, self.mesh, self.num_microbatches, remat=self.remat)
        tokens = vit.norm(out[0])
        roll = out[1][:, :, 0, 1:]
        if tp is not None:  # heads are independent in the chain: gather them
            with torch.no_grad():
                g = C._all_gather0(roll.contiguous(), tp.group)  # [tp, B3, H/tp, P]
            roll = g.permute(1, 0, 2, 3).reshape(B3, vcfg.num_heads, -1)
        return list(tokens.split(B)), list(roll.split(B))

    @torch.no_grad()
    def reduce_grads(self, model: nn.Module) -> None:
        """After the backward: every gradient made whole over the stage group
        in one flat sum all-reduce a dtype. A stage's blocks, and stage 0's
        embedding, carry their gradient on their own rank only (exact zeros
        elsewhere); the replicated tail's, the same on every stage, is
        taken from the last stage alone."""
        if self.S == 1:
            return
        pg, _ = axis_group(self.mesh, "stage")
        params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        by_dtype: dict = {}
        for name, p in params:
            if p.grad is None or (self.stage != self.S - 1
                                  and not name.startswith(_PIPELINE_SIDE)):
                p.grad = torch.zeros_like(p)
            by_dtype.setdefault(p.grad.dtype, []).append(p)
        for ps in by_dtype.values():
            flat = C._all_reduce_(torch.cat([p.grad.reshape(-1) for p in ps]), pg)
            off = 0
            for p in ps:
                p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
                off += p.numel()


def make_pipeline_backbone(mesh, num_microbatches: int, remat: bool = True,
                           model_axis: str = "model") -> PipelineBackbone:
    """A :class:`PipelineBackbone` over ``mesh`` (``parallel.mesh.make_mesh(
    data, model, stage=S)``): pass it as ``Editor.forward(backbone=)`` or
    ``engine.train.build_train_step(backbone=)``. ``remat`` recomputes each
    microbatch's stage forward in the backward. With a ``model_axis`` above
    1 the model must be cut by ``parallel.tp.shard_editor``; with a 'data'
    axis each data row pipelines its own rows (dp x pp)."""
    return PipelineBackbone(mesh, num_microbatches, remat, model_axis)
