"""The weight bridge (JAX params -> the port's state_dict) and the port's own
seeded init, against ``export_editor_to_torch`` and ``editor_init``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from editor_tpu.models.editor import EditorConfig as JaxEditorConfig
from editor_tpu.models.vit import ViTConfig as JaxViTConfig
from editor_tpu.utils.torch_convert import export_editor_to_torch
from editor_tpu_torch.models.editor import Editor
from editor_tpu_torch.models.init import editor_init
from editor_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.torch_parity import jax_editor, to_numpy_tree, torch_editor_config


def _tiny(al=False, depth=2):
    vit = JaxViTConfig(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                       embed_dim=96, depth=depth, num_heads=4, mlp_ratio=2.0, camera=4)
    return JaxEditorConfig(num_classes=10, vit=vit, head_keep=2, frequency_keep=3,
                           al=al, use_pallas=False)


def editor_init_jax(jcfg):
    from editor_tpu.models.editor import editor_init as jax_editor_init
    return jax_editor_init(jax.random.PRNGKey(0), jcfg)


@pytest.mark.parametrize("al", [False, True])
def test_bridge_equals_export_key_for_key(al):
    jcfg = _tiny(al=al)
    params, state = jax_editor(jcfg, dtype=None)
    ref = export_editor_to_torch(params, state, jcfg)
    got = state_dict_from_jax(params, state, jcfg)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            # torch's scalar buffer; the exporter emits it as shape [1]
            v = v.reshape(())
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("al", [False, True])
def test_bridge_loads_strictly_and_round_trips(al):
    jcfg = _tiny(al=al)
    params, state = jax_editor(jcfg, dtype=None)
    sd = state_dict_from_jax(params, state, jcfg)
    model = Editor(torch_editor_config(jcfg), device="cpu")
    model.load_state_dict(sd, strict=True)
    model.load_state_dict(export_editor_to_torch(params, state, jcfg), strict=True)
    back = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_port_init_has_the_jax_layout():
    """editor_init (port) builds exactly the keys, shapes and dtypes the JAX
    init exports, at the flagship widths (depth cut to 2)."""
    from __graft_entry__ import _flagship_cfg
    jcfg = _flagship_cfg(depth=2, use_pallas=False)
    params, state = jax.eval_shape(lambda: editor_init_jax(jcfg))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), (params, state))
    ref = export_editor_to_torch(*zeros, jcfg)
    got = editor_init(torch_editor_config(jcfg), seed=0, device="cpu").state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        shape = () if k.endswith("num_batches_tracked") else v.shape
        assert got[k].shape == shape and got[k].dtype == v.dtype, k


def test_port_init_distributions():
    """Same distributions as the JAX init (editor.py:108-138, vit.py:120-160,
    layers.py:60-76), checked by their statistics on a depth-2 flagship-width
    model; tolerances are a few standard errors of the sample std."""
    from editor_tpu_torch.models.editor import flagship_config
    cfg = flagship_config()
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, depth=2))
    sd = editor_init(cfg, seed=3, device="cpu").state_dict()
    C = cfg.dim

    def std(k):
        return float(sd[k].double().std())

    # trunc_normal(0.02) cut at +-2 = +-100 sigma: plain N(0, 0.02)
    for k in ("BACKBONE.base.blocks.0.attn.qkv.weight", "BACKBONE.base.pos_embed",
              "FUSE_block.mlp.fc1.weight", "BACKBONE.base.sie_embed"):
        assert abs(std(k) / 0.02 - 1) < 0.05, k
    assert abs(std("BACKBONE.base.patch_embed.proj.weight")
               / (2.0 / (16 * 16 * C)) ** 0.5 - 1) < 0.01
    assert abs(std("RGB_REDUCE.weight") / (2.0 / C) ** 0.5 - 1) < 0.01
    assert abs(std("FUSE_HEAD.weight") / 0.001 - 1) < 0.02
    for k in ("RGB_REDUCE.bias", "BACKBONE.base.blocks.1.mlp.fc2.bias",
              "FUSE_BN.running_mean", "FUSE_block.memory_cls.RGB_centers"):
        assert torch.count_nonzero(sd[k]) == 0, k
    for k in ("BACKBONE.base.norm.weight", "FUSE_BN.running_var", "FUSE_block.normR.weight"):
        assert torch.all(sd[k] == 1), k
    # the same seed gives the same weights; another seed others
    again = editor_init(cfg, seed=3, device="cpu").state_dict()
    other = editor_init(cfg, seed=4, device="cpu").state_dict()
    k = "BACKBONE.base.blocks.0.attn.qkv.weight"
    assert torch.equal(sd[k], again[k]) and not torch.equal(sd[k], other[k])


def test_unported_options_raise():
    """The pipeline (``backbone=``) is ported (tests/test_torch_pipeline_vit.py,
    test_torch_pipeline_step.py): here the hook is called once with the
    model, its config, the modalities, the ids, the mode and the generator,
    and a hook that runs the model's own backbone gives the model's own
    features. The model-parallel options are ported (tests/test_torch_tp.py,
    test_torch_moe.py, test_torch_ring.py): here they refuse what is not a
    mesh, one expert (JAX's ``blockmask_moe_init`` check) and MoE options on
    a dense model; a JAX MoE tree maps into a MoE model's state dict."""
    jcfg = _tiny()
    cfg = torch_editor_config(jcfg)
    with pytest.raises(ValueError, match="MOE_EXPERTS must be >= 2"):
        Editor(dataclasses.replace(cfg, moe_experts=1), device="cpu")
    params, state = jax_editor(jcfg, dtype=None)
    model = Editor(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, state, jcfg))
    imgs = {m: torch.zeros(1, 64, 32, 3) for m in ("RGB", "NI", "TI")}
    cam = torch.zeros(1, dtype=torch.long)
    calls = []

    def backbone(m, c, mods, cam_ids, view_ids, training, generator):
        calls.append((m, c, len(mods), cam_ids, view_ids, training, generator))
        tokens, rollout = m.BACKBONE.base(torch.cat(mods), cam_ids.repeat(len(mods)), None,
                                          c.use_pallas, training, generator)
        return list(tokens.split(len(cam_ids))), list(rollout.split(len(cam_ids)))

    with torch.no_grad():
        assert torch.equal(model(imgs, cam, backbone=backbone), model(imgs, cam))
    assert calls == [(model, model.cfg, 3, cam, None, False, None)]
    for kw in (dict(tp_mesh=object()), dict(seq_mesh=object())):
        with pytest.raises(TypeError, match="mesh"):
            model(imgs, cam, **kw)
    for kw in (dict(moe_shards=2), dict(moe_mesh=object())):
        with pytest.raises(ValueError, match="MoE model"):
            model(imgs, cam, **kw)
    with pytest.raises(ValueError, match="labels"):  # training is ported; it needs labels
        model(imgs, cam, training=True)
    leaves = {k: np.ones((2,)) for k in ("router", "w1", "b1", "w2", "b2")}
    moe = dict(params, FUSE_block=dict(
        {k: v for k, v in params["FUSE_block"].items() if k != "mlp"}, moe_mlp=leaves))
    sd = state_dict_from_jax(to_numpy_tree(moe), state, jcfg)
    assert not any(k.startswith("FUSE_block.mlp.") for k in sd)
    assert all(torch.equal(sd[f"FUSE_block.moe_mlp.{k}"], torch.ones(2, dtype=torch.float64))
               for k in leaves)


def test_configs_mirror_jax():
    """The port's config dataclasses have the JAX fields and defaults, and
    flagship_config() is __graft_entry__._flagship_cfg()."""
    from __graft_entry__ import _flagship_cfg
    from editor_tpu_torch.models.editor import EditorConfig, flagship_config
    from editor_tpu_torch.models.vit import ViTConfig

    for port, ref in ((ViTConfig, JaxViTConfig), (EditorConfig, JaxEditorConfig)):
        fields = {f.name: (f.default, f.default_factory) for f in dataclasses.fields(port)}
        assert fields == {f.name: (f.default, f.default_factory)
                          for f in dataclasses.fields(ref)}, port.__name__
    assert flagship_config() == torch_editor_config(_flagship_cfg())
