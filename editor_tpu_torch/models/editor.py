"""EDITOR model assembly (the tri-modal eval and training forward).

Counterpart of ``editor_tpu/models/editor.py``: one shared ViT pass over the
modality-major 3B batch, the frequency mask, SFTS token selection, the
compact tail (cls + at most ``_tail_keep_count`` selected patches per
modality), the HMA fusion block, a masked mean pool and the three reduce
heads, giving ``cls4t`` [B, 3C]. In training the forward also returns the
reference's output tuple (:class:`EditorTrainOutput`): the fused BN-neck
score, the per-modality (or AL) BN-neck heads, and the BCC + OCFR aux loss;
the BN running stats and the OCFR centers advance in their buffers.

The ``nn.Module`` tree carries exactly the reference's state_dict keys
(``BACKBONE.base.*``, ``FUSE_block.*``, ``*_REDUCE``, ``*_HEAD``, ``*_BN``,
``FREQ_INDEX.*``), so weights exported by
``editor_tpu.utils.torch_convert.export_editor_to_torch`` or converted by
:func:`editor_tpu_torch.utils.jax_weights.state_dict_from_jax` load with
``load_state_dict(strict=True)``. Weights for a run without JAX come from
:func:`editor_tpu_torch.models.init.editor_init`. With ``moe_experts`` > 0 the
fusion block's joint MLP is a mixture of experts (``FUSE_block.moe_mlp.*``,
names of the port's own: the reference has no MoE) and its load-balance loss,
weighted by ``moe_aux_weight``, joins the aux loss.

Model parallelism (the JAX ``editor_apply`` options): ``tp_mesh`` (tensor
parallelism of the backbone over a ('data', 'model') mesh, on a model cut
by ``parallel.tp.shard_editor``; the fusion block, SFTS, the BN heads and
OCFR run replicated on every model rank), ``seq_mesh`` (the fusion block's
masked attentions sequence-sharded, ``parallel.ring``), ``moe_mesh`` /
``moe_shards`` (the MoE's experts sharded, ``parallel.moe``) and
``backbone`` (the backbone pipelined over a 'stage' mesh,
``parallel.pipeline_vit``).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from editor_tpu_torch.models.frequency import frequency_token_select
from editor_tpu_torch.models.fusion import BlockMask
from editor_tpu_torch.models.layers import BatchNorm1d, Linear
from editor_tpu_torch.models.sfts import bcc_loss, sfts_select
from editor_tpu_torch.models.vit import (ViTConfig, VisionTransformer, deit_small_config,
                                         tp_group, vit_base_config, vit_small_config)
from editor_tpu_torch.parallel.collectives import all_gather, all_reduce

if TYPE_CHECKING:
    from editor_tpu_torch.config import Config

MODALITIES = ("RGB", "NI", "TI")
FUSION_HEADS = 12  # editor_apply passes num_heads=12 to the fusion block


def default_device(device=None) -> torch.device:
    """The device an entry point builds on: ``device`` when given, else the
    current CUDA device; without a CUDA device the caller must ask for the
    CPU explicitly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def vit_tiny_test_config(**kw) -> ViTConfig:
    """Tiny backbone for CPU tests (not in the reference zoo)."""
    return ViTConfig(embed_dim=96, depth=2, num_heads=4, mlp_ratio=2.0,
                     qkv_bias=True, **kw)


VIT_FACTORY = {
    # reference factory __factory_T_type (make_model.py:363-368)
    "vit_base_patch16_224": vit_base_config,
    "deit_base_patch16_224": vit_base_config,
    "vit_small_patch16_224": vit_small_config,
    "deit_small_patch16_224": deit_small_config,
    "vit_tiny_test": vit_tiny_test_config,
}


@dataclasses.dataclass(frozen=True)
class EditorConfig:
    num_classes: int
    vit: ViTConfig
    head_keep: int = 2          # MODEL.HEAD_KEEP
    frequency_keep: int = 10    # MODEL.FREQUENCY_KEEP
    al: bool = False            # MODEL.AL supervision setting
    ocfr_momentum: float = 0.8
    num_modalities: int = 3
    # True routes attention through the hand-written CUDA kernels (K1-K3) for
    # CUDA tensors, and their plain versions for CPU tensors; False runs the
    # plain versions on any device. Named as in the JAX config so configs
    # transfer.
    use_pallas: bool = True
    compact_tail: bool = True   # TPU.COMPACT_TAIL (exact; see _compact_selected)
    moe_experts: int = 0        # MODEL.MOE_EXPERTS (> 0: the MoE joint MLP)
    moe_aux_weight: float = 0.01

    @property
    def dim(self) -> int:
        return self.vit.embed_dim

    @property
    def num_patches(self) -> int:
        return self.vit.num_patches


def editor_config_from(cfg: "Config", num_classes: int, camera_num: int) -> EditorConfig:
    """The EditorConfig of a framework :class:`~editor_tpu_torch.config.Config`
    (the same mapping as the JAX ``editor_config_from``; reference:
    modeling/make_model.py:34-98,371-374): MODEL.TRANSFORMER_TYPE picks the
    backbone factory, SIE_CAMERA, SIE_COE, DROP_PATH, DROP_OUT, ATT_DROP_RATE,
    HEAD_KEEP, FREQUENCY_KEEP, AL, MOE_* and TPU.REMAT*, TPU.COMPACT_TAIL set
    the rest."""
    camera = camera_num if cfg.MODEL.SIE_CAMERA else 0
    factory = VIT_FACTORY[cfg.MODEL.TRANSFORMER_TYPE]
    vit_cfg = factory(
        img_size=tuple(cfg.INPUT.SIZE_TRAIN),
        stride_size=tuple(cfg.MODEL.STRIDE_SIZE),
        camera=camera,
        view=0,
        sie_xishu=cfg.MODEL.SIE_COE,
        drop_path_rate=cfg.MODEL.DROP_PATH,
        drop_rate=cfg.MODEL.DROP_OUT,
        attn_drop_rate=cfg.MODEL.ATT_DROP_RATE,
        remat=bool(cfg.TPU.REMAT),
        remat_policy=str(cfg.TPU.REMAT_POLICY),
        remat_skip_last=int(cfg.TPU.REMAT_SKIP_LAST),
    )
    return EditorConfig(
        num_classes=num_classes,
        vit=vit_cfg,
        head_keep=int(cfg.MODEL.HEAD_KEEP),
        frequency_keep=int(cfg.MODEL.FREQUENCY_KEEP),
        al=bool(cfg.MODEL.AL),
        compact_tail=bool(cfg.TPU.COMPACT_TAIL),
        moe_experts=int(cfg.MODEL.MOE_EXPERTS),
        moe_aux_weight=float(cfg.MODEL.MOE_AUX_WEIGHT),
    )


def flagship_config(num_classes: int = 171, camera: int = 6) -> EditorConfig:
    """ViT-B/16 at 256x128, RGB+NIR+TIR, HEAD_KEEP 2, FREQUENCY_KEEP 10,
    COMPACT_TAIL on: ``__graft_entry__._flagship_cfg()`` (RGBNT201), equal to
    ``editor_config_from(load_config(None, RGBNT201_PRESET), 171, 6)``."""
    vit = ViTConfig(img_size=(256, 128), patch_size=16, stride_size=(16, 16),
                    embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0,
                    qkv_bias=True, camera=camera, sie_xishu=3.0,
                    drop_path_rate=0.1)
    return EditorConfig(num_classes=num_classes, vit=vit, head_keep=2,
                        frequency_keep=10)


@dataclasses.dataclass
class EditorTrainOutput:
    """Training outputs in the reference's tuple protocol (``EditorTrainOutput``
    of the JAX package)."""
    score: torch.Tensor                 # fused classifier logits
    cls4t: torch.Tensor                 # fused [B, M*dim] embedding
    pairs: List[Tuple[torch.Tensor, torch.Tensor]]  # (score_i, feat_i), fused first
    aux_loss: torch.Tensor              # BCC + OCFR, fp32


def _tail_keep_count(cfg: EditorConfig, num_mods: int) -> int:
    """Static bound on SFTS-selected patches per sample: heads x HEAD_KEEP per
    modality plus FREQUENCY_KEEP, padded so 1 + keep is a multiple of 8
    (87 on the flagship)."""
    P = cfg.num_patches
    bound = min(P, cfg.frequency_keep + num_mods * cfg.vit.num_heads * cfg.head_keep)
    return min(P, ((bound + 8) // 8) * 8 - 1)


def _compact_selected(feats: List[torch.Tensor], index: torch.Tensor, keep: int
                      ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Gather each modality down to [B, 1+keep, C]: cls + the selected patches
    first (ascending), then unselected ones whose mask stays 0. Exact: the
    dropped rows are zero and carry zero attention weight and pool weight."""
    sel = torch.sort(index[:, :, 0], dim=1, descending=True, stable=True).indices[:, :keep]
    cindex = torch.gather(index, 1, sel[:, :, None])
    out = []
    for f in feats:
        g = torch.gather(f[:, 1:], 1, sel[:, :, None].expand(-1, -1, f.shape[-1]))
        out.append(torch.cat([f[:, :1], g], dim=1))
    return out, cindex


def _masked_mean_pool(fused: torch.Tensor, index: torch.Tensor, seg_len: int,
                      num_mods: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per modality: (cls, sum of patch tokens / number of selected patches)."""
    num = index.sum(dim=1)  # [B, 1]
    outs = []
    for i in range(num_mods):
        seg = fused[:, i * seg_len:(i + 1) * seg_len]
        outs.append((seg[:, 0], seg[:, 1:].sum(dim=1) / num.to(seg.dtype)))
    return outs


class Backbone(nn.Module):
    """Holds the ViT under ``BACKBONE.base`` (the reference's build_transformer)."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.base = VisionTransformer(cfg, device=device)


class _HaarFilters(nn.Module):
    """The reference's constant Haar filter buffers (``FREQ_INDEX.*``), kept
    so checkpoints load strictly; the Haar shortcut never reads them."""

    def __init__(self, names: Tuple[str, str], device=None):
        super().__init__()
        s = 1.0 / 2.0 ** 0.5
        lo = torch.tensor([s, s], device=device)
        hi = torch.tensor([s, -s], device=device)
        for name, taps in zip(names, (lo, hi)):
            self.register_buffer(f"{name}_col", taps.reshape(1, 1, 2, 1).clone())
            self.register_buffer(f"{name}_row", taps.reshape(1, 1, 1, 2).clone())


class Editor(nn.Module):
    """The EDITOR model on ``device`` (by default the current CUDA device;
    without one, pass ``device='cpu'``)."""

    def __init__(self, cfg: EditorConfig, device=None):
        super().__init__()
        device = default_device(device)
        self.cfg = cfg
        d, M = cfg.dim, cfg.num_modalities
        self.BACKBONE = Backbone(cfg.vit, device=device)
        self.FUSE_block = BlockMask(d, cfg.num_classes, mlp_ratio=4.0,
                                    num_heads=FUSION_HEADS, num_experts=cfg.moe_experts,
                                    device=device)
        self.RGB_REDUCE = Linear(2 * d, d, device=device)
        self.NIR_REDUCE = Linear(2 * d, d, device=device)
        self.TIR_REDUCE = Linear(2 * d, d, device=device)
        self.FUSE_HEAD = Linear(M * d, cfg.num_classes, bias=False, device=device)
        self.BACKBONE_HEAD = Linear(d, cfg.num_classes, bias=False, device=device)
        self.FUSE_BN = BatchNorm1d(M * d, device=device)
        self.BACKBONE_BN = BatchNorm1d(d, device=device)
        if cfg.al:
            self.AL_HEAD = Linear(M * d, cfg.num_classes, bias=False, device=device)
            self.AL_BN = BatchNorm1d(M * d, device=device)
        self.FREQ_INDEX = nn.Module()
        self.FREQ_INDEX.DWT = _HaarFilters(("h0", "h1"), device=device)
        self.FREQ_INDEX.IDWT = _HaarFilters(("g0", "g1"), device=device)

    def forward(self, images: Dict[str, torch.Tensor],
                cam_ids: Optional[torch.Tensor] = None,
                view_ids: Optional[torch.Tensor] = None,
                training: bool = False, tp_mesh=None, seq_mesh=None,
                backbone=None, labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, batch_group=None,
                moe_mesh=None, moe_shards: int = 1, valid_rows: Optional[int] = None
                ) -> Union[torch.Tensor, EditorTrainOutput]:
        """images: {'RGB', 'NI', 'TI'} NHWC float tensors ('TI' optional).
        Eval: returns cls4t [B, M*dim] in the images' dtype. Training
        (``labels`` [B] required, drop path and dropout drawn from
        ``generator``): returns an :class:`EditorTrainOutput` and advances
        the BN running stats and OCFR centers in place.

        ``batch_group`` (a ``DeviceMesh`` or process group): the images are
        this rank's rows of a global batch, and ``labels`` (training) are
        the global batch's [W*B]. Every site that couples the rows of a
        batch sees all W*B of them, as the JAX step on a mesh does: in
        training the BN heads (batch stats, the n of the running variance),
        the OCFR class means, the BCC mean and, through the returned pairs,
        the losses and accuracy; in training and in eval the MoE joint
        MLP's routing (slots in global order, the capacity from the global
        token count), with or without ``moe_mesh`` or ``moe_shards``. The
        training inputs are all-gathered with autograd (the BCC loss is
        all-reduced), so the training output is the global batch's, the
        same on every rank, and a rank's backward gives W times its rows'
        share of the gradient; the step's mean all-reduce of the gradients
        cancels the W. The eval forward returns this rank's rows (its BN
        heads use their running statistics, so nothing else couples rows).
        ``valid_rows`` (eval): the (global) batch's rows past it are padding,
        last in order, which the MoE's capacity does not count (the eval
        step's padding; ``models.fusion.moe_masked_mlp``); a dense model
        ignores it.

        ``tp_mesh``: a ('data', 'model') ``DeviceMesh`` whose model axis is
        above 1 (the model cut by ``parallel.tp.shard_editor``; every rank
        of a model group passes the same rows). ``seq_mesh``: a mesh with a
        'seq' dimension (or a process group) over which the fusion block's
        masked attentions run as the masked ring. ``moe_mesh`` (an 'expert'
        dimension: the data group's own ranks, or the second axis of a 2-D
        ('data', 'expert') mesh) / ``moe_shards``: the MoE joint MLP's
        experts sharded / the S-shard routing on one device. The parallel
        paths' gradients follow ``parallel.collectives`` (the module docstrings of
        ``parallel.ring`` and ``parallel.moe``). ``backbone``: a replacement
        of the shared backbone pass, ``(model, cfg, mods, cam_ids, view_ids,
        training, generator) -> (toks, rolls)`` per modality, e.g. the
        pipelined backbone (``parallel.pipeline_vit.make_pipeline_backbone``,
        which takes tensor parallelism from its own mesh); everything after
        it sees the full batch."""
        if training and labels is None:
            raise ValueError("the training forward needs labels")
        if (moe_mesh is not None or moe_shards != 1) and self.cfg.moe_experts == 0:
            raise ValueError("moe_mesh= and moe_shards= need a MoE model (moe_experts > 0)")
        tp = tp_group(tp_mesh)
        cfg = self.cfg
        use_kernels = cfg.use_pallas
        mods = [images["RGB"], images["NI"]]
        if images.get("TI") is not None:
            mods.append(images["TI"])
        M = len(mods)
        B = mods[0].shape[0]

        mask_fre = frequency_token_select(mods, keep=cfg.frequency_keep,
                                          stride=cfg.vit.stride_size[0],
                                          window=cfg.vit.patch_size)
        if backbone is not None:
            toks, rolls = backbone(self, cfg, mods, cam_ids, view_ids, training, generator)
        else:
            cams = cam_ids.repeat(M) if cam_ids is not None else None
            views = view_ids.repeat(M) if view_ids is not None else None
            tokens, rollout = self.BACKBONE.base(torch.cat(mods), cams, views, use_kernels,
                                                 training, generator, tp)
            toks, rolls = list(tokens.split(B)), list(rollout.split(B))

        head_pairs = []
        if training:
            cls4tri = [t[:, 0] for t in toks]
            if batch_group is not None:
                cls4tri = list(all_gather(torch.stack(cls4tri, dim=1), batch_group).unbind(1))
            if cfg.al:  # AL supervision on the joint raw cls tokens
                ori = torch.cat(cls4tri, dim=-1)
                head_pairs.append((self.AL_HEAD(self.AL_BN(ori, True)), ori))
            else:  # the shared BN head, per modality in order: the running
                # stats move three times, RGB, NI, TI
                for cls in cls4tri:
                    head_pairs.append((self.BACKBONE_HEAD(self.BACKBONE_BN(cls, True)), cls))

        feats, index = sfts_select(toks, rolls, mask_fre, cfg.head_keep)
        bcc = bcc_loss(toks, index) if training else None
        if training and batch_group is not None:  # the mean over equal shards
            bcc = all_reduce(bcc, batch_group, "mean")
        seg_len = cfg.num_patches + 1
        if cfg.compact_tail:
            keep = _tail_keep_count(cfg, M)
            if keep < cfg.num_patches:
                feats, index = _compact_selected(feats, index, keep)
                seg_len = keep + 1

        fused, ocfr_loss, moe_aux = self.FUSE_block(
            feats, index, use_kernels, labels=labels if training else None,
            ocfr_momentum=cfg.ocfr_momentum, batch_group=batch_group, seq_mesh=seq_mesh,
            moe_mesh=moe_mesh, moe_shards=moe_shards, valid_rows=valid_rows)
        pooled = _masked_mean_pool(fused, index, seg_len, M)
        heads = (self.RGB_REDUCE, self.NIR_REDUCE, self.TIR_REDUCE)[:M]
        cls4t = torch.cat([head(torch.cat([cls, pool], dim=-1))
                           for head, (cls, pool) in zip(heads, pooled)], dim=-1)
        if not training:
            return cls4t
        if batch_group is not None:
            cls4t = all_gather(cls4t, batch_group)
        score = self.FUSE_HEAD(self.FUSE_BN(cls4t, True))
        aux = bcc + ocfr_loss
        if moe_aux is not None:
            aux = aux + cfg.moe_aux_weight * moe_aux
        # the JAX function holds the aux loss in fp32 (so an fp64 run rounds here)
        return EditorTrainOutput(score=score, cls4t=cls4t,
                                 pairs=[(score, cls4t)] + head_pairs,
                                 aux_loss=aux.to(torch.float32))
