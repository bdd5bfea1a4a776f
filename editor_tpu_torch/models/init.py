"""Seeded random initialisation of the EDITOR port, without JAX.

Same distributions as ``editor_init`` (editor_tpu/models/editor.py,
vit.py ``vit_init``, layers.py ``linear_init``):

* patch embed: normal(0, sqrt(2 / (patch^2 * C))), bias 0;
* cls token, pos embed, SIE embed and every backbone / fusion Linear weight:
  truncated normal, std 0.02, cut at +-2;
* reduce heads: Kaiming normal over fan_out (std sqrt(2 / d_out)), bias 0;
* classifier heads: normal(0, 0.001);
* LayerNorm and BN: weight 1, bias 0; BN running mean 0, var 1;
* OCFR class centers: 0;
* the MoE joint MLP (``moe_experts`` > 0): ``moe_init``'s, router normal *
  0.02, w1 normal * sqrt(2 / dim), w2 normal * sqrt(2 / hidden), biases 0.

The draws come from one CPU ``torch.Generator`` seeded with ``seed``, in a
fixed order, so the weights are the same on every machine and device. They
are not the JAX package's numbers for the same seed (the two generators
differ); tests that compare the packages load JAX weights through
:func:`editor_tpu_torch.utils.jax_weights.state_dict_from_jax` instead.
"""

from __future__ import annotations

import torch
from torch import nn

from editor_tpu_torch.models.editor import Editor, EditorConfig
from editor_tpu_torch.models.layers import BatchNorm1d, LayerNorm, Linear


def _fill(param: torch.Tensor, draw) -> None:
    cpu = torch.empty(param.shape, dtype=torch.float32)
    draw(cpu)
    param.copy_(cpu)


@torch.no_grad()
def editor_init(cfg: EditorConfig, seed: int = 0, device=None) -> Editor:
    """A new :class:`Editor` with seeded random weights, on ``device``: by
    default the current CUDA device; without one, pass ``device='cpu'``."""
    model = Editor(cfg, device=device)
    gen = torch.Generator().manual_seed(seed)

    def trunc(p):
        _fill(p, lambda t: nn.init.trunc_normal_(t, std=0.02, a=-2.0, b=2.0,
                                                 generator=gen))

    def normal(p, std):
        _fill(p, lambda t: nn.init.normal_(t, std=std, generator=gen))

    vit = model.BACKBONE.base
    C, patch = cfg.vit.embed_dim, cfg.vit.patch_size
    normal(vit.patch_embed.proj.weight, (2.0 / (patch * patch * C)) ** 0.5)
    vit.patch_embed.proj.bias.zero_()
    trunc(vit.cls_token)
    trunc(vit.pos_embed)
    if vit.sie_embed is not None:
        trunc(vit.sie_embed)

    reduce_heads = {model.RGB_REDUCE, model.NIR_REDUCE, model.TIR_REDUCE}
    class_heads = {model.FUSE_HEAD, model.BACKBONE_HEAD, getattr(model, "AL_HEAD", None)}
    for module in model.modules():
        if isinstance(module, Linear):
            if module in reduce_heads:
                normal(module.weight, (2.0 / module.weight.shape[0]) ** 0.5)
            elif module in class_heads:
                normal(module.weight, 0.001)
            else:
                trunc(module.weight)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (LayerNorm, BatchNorm1d)):
            module.weight.fill_(1.0)
            module.bias.zero_()
            if isinstance(module, BatchNorm1d):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
    if cfg.moe_experts:
        from editor_tpu_torch.parallel.moe import moe_init
        moe = model.FUSE_block.moe_mlp
        drawn = moe_init(moe.w1.shape[1], moe.w1.shape[2], cfg.moe_experts, gen)
        for name, value in drawn._asdict().items():
            getattr(moe, name).copy_(value)
    return model
