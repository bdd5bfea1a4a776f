"""The uncompacted fusion tail (TPU.COMPACT_TAIL off) and the Config -> model
bridge, against the JAX package.

* ``editor_config_from`` equals the JAX function over every ``configs/*.yaml``
  preset with and without overrides (compact tail, backbone type, drop path,
  SIE camera, remat); ``flagship_config()`` is the bridged RGBNT201 preset.
* The eval forward and two ``build_train_step`` steps at f64, flagship widths
  (ViT-B, 256x128: 129 tokens per modality) cut to depth 2, with three and two
  modalities: the port runs its kernel wrappers on CPU tensors, so the fusion
  block's attention goes through the dispatch to K6/K7's plain versions; the
  JAX side runs its XLA path (``use_pallas=False``), as its CPU tests do.
  Tolerances: rtol 1e-9 for the eval features; the train step's as in
  tests/test_torch_train_step.py, where the JAX f64 path rounds through fp32
  (loss rtol 1e-7, each parameter's change within 1e-7 of that tensor's
  largest change).
* In the port, the compact and the uncompacted tail give the same features
  and training outputs (the JAX claim of tests/test_train_step.py:155), at
  rtol 1e-9 in f64.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.config import Config as JaxConfig
from editor_tpu.config import load_config as jax_load_config
from editor_tpu.engine import build_train_step as jax_build_train_step
from editor_tpu.engine import make_train_state
from editor_tpu.losses import make_loss as jax_make_loss
from editor_tpu.models.editor import EditorConfig as JaxEditorConfig
from editor_tpu.models.editor import editor_apply
from editor_tpu.models.editor import editor_config_from as jax_editor_config_from
from editor_tpu.models.editor import editor_init as jax_editor_init
from editor_tpu.solver import make_optimizer as jax_make_optimizer
from editor_tpu.solver import make_scheduler as jax_make_scheduler
from editor_tpu_torch import ops
from editor_tpu_torch.config import RGBNT201_PRESET, Config, load_config
from editor_tpu_torch.engine.train import build_train_step
from editor_tpu_torch.losses import make_loss
from editor_tpu_torch.models.editor import (VIT_FACTORY, EditorConfig, editor_config_from,
                                            flagship_config, vit_tiny_test_config)
from editor_tpu_torch.models.init import editor_init
from editor_tpu_torch.ops import masked_attention as port_ma
from editor_tpu_torch.solver import make_optimizer, make_scheduler
from editor_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.torch_parity import (assert_close, jax_editor, port_editor, to_numpy_tree,  # noqa: F401
                                torch_editor_config, x64)

REPO = Path(__file__).resolve().parent.parent
PRESETS = sorted(p.name for p in (REPO / "configs").glob("*.yaml"))
OVERRIDES = {
    "preset": [],
    "uncompacted": ["TPU.COMPACT_TAIL", "False"],
    "vit_small": ["MODEL.TRANSFORMER_TYPE", "vit_small_patch16_224", "MODEL.DROP_PATH", "0.3",
                  "MODEL.DROP_OUT", "0.1", "MODEL.ATT_DROP_RATE", "0.05"],
    "deit_small_no_sie_remat": ["MODEL.TRANSFORMER_TYPE", "deit_small_patch16_224",
                                "MODEL.SIE_CAMERA", "False", "MODEL.SIE_COE", "1.5",
                                "TPU.REMAT", "True", "TPU.REMAT_SKIP_LAST", "2",
                                "MODEL.AL", "1", "MODEL.HEAD_KEEP", "3"],
}
MODS = ("RGB", "NI", "TI")


@pytest.mark.parametrize("override", sorted(OVERRIDES))
@pytest.mark.parametrize("preset", PRESETS)
def test_editor_config_from_matches_jax(preset, override):
    path = str(REPO / "configs" / preset)
    opts = OVERRIDES[override]
    cfg, jcfg = load_config(path, opts), jax_load_config(path, opts)
    assert cfg.to_dict() == jcfg.to_dict()
    got = editor_config_from(cfg, num_classes=50, camera_num=8)
    ref = jax_editor_config_from(jcfg, num_classes=50, camera_num=8)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got == torch_editor_config(ref)
    assert got.compact_tail == (override != "uncompacted")


def test_vit_factories_match_jax():
    from editor_tpu.models.editor import VIT_FACTORY as JAX_FACTORY

    assert set(VIT_FACTORY) == set(JAX_FACTORY)
    for name, factory in VIT_FACTORY.items():
        kw = dict(img_size=(128, 64), camera=3, drop_path_rate=0.2)
        assert dataclasses.asdict(factory(**kw)) == dataclasses.asdict(JAX_FACTORY[name](**kw))
    small = VIT_FACTORY["vit_small_patch16_224"]()
    assert small.scale == 768 ** -0.5 and small.head_dim == 96


def test_flagship_config_is_the_bridged_preset():
    cfg = load_config(None, RGBNT201_PRESET)
    assert editor_config_from(cfg, 171, 6) == flagship_config()
    off = load_config(None, RGBNT201_PRESET + ["TPU.COMPACT_TAIL", "False"])
    assert editor_config_from(off, 171, 6) == dataclasses.replace(flagship_config(),
                                                                   compact_tail=False)
    # and the JAX bridge over the same overrides gives the same model config
    assert torch_editor_config(jax_editor_config_from(
        jax_load_config(None, RGBNT201_PRESET), 171, 6)) == flagship_config()


# ---------------------------------------------------------------------------
# the uncompacted path at flagship widths, depth 2
# ---------------------------------------------------------------------------

def _uncompacted_cfg(num_mods: int) -> JaxEditorConfig:
    from __graft_entry__ import _flagship_cfg

    jcfg = _flagship_cfg(depth=2, use_pallas=False)
    vit = dataclasses.replace(jcfg.vit, drop_path_rate=0.0)
    return dataclasses.replace(jcfg, vit=vit, compact_tail=False, num_modalities=num_mods,
                               num_classes=8)


@pytest.mark.parametrize("mods", [MODS, MODS[:2]], ids=["three", "two"])
def test_uncompacted_eval_forward_matches_jax(x64, monkeypatch, mods):
    """129 tokens per modality, 387 (or 258) joint: the port's fusion block
    routes both attentions to K6 (plain version on the CPU)."""
    jcfg = _uncompacted_cfg(len(mods))
    params, state = jax_editor(jcfg)
    model = port_editor(jcfg, params, state, use_pallas=True)
    rng = np.random.RandomState(len(mods))
    B = 2
    imgs = {m: rng.randn(B, 256, 128, 3) for m in mods}
    cam = (np.arange(B) % 6).astype(np.int32)
    ref, _ = editor_apply(params, state, jcfg, {m: jnp.asarray(v) for m, v in imgs.items()},
                          cam_ids=jnp.asarray(cam), training=False)
    calls = []

    def spy(qkv, *args, _real=ops.masked_attention_tiled_plain):
        calls.append(tuple(qkv.shape[:2]))
        return _real(qkv, *args)
    monkeypatch.setattr(port_ma, "masked_attention_tiled_plain", spy)
    got = model({m: torch.from_numpy(v) for m, v in imgs.items()}, torch.from_numpy(cam))
    assert calls == [(len(mods) * B, 129), (B, 129 * len(mods))]
    assert got.shape == (B, len(mods) * 768)
    assert_close(got, ref)


def _train_setup(num_mods: int):
    jcfg = _uncompacted_cfg(num_mods)
    cfg = JaxConfig()
    params, _ = jax_editor_init(jax.random.PRNGKey(0), jcfg)
    opt = jax_make_optimizer(cfg, params)
    state = make_train_state(jax.random.PRNGKey(0), jcfg, opt)
    state = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, state)
    step = jax_build_train_step(jcfg, opt, jax_make_loss(cfg, jcfg.num_classes),
                                jax_make_scheduler(cfg), cfg.SOLVER.BASE_LR,
                                compute_dtype=jnp.float64, donate=False)
    rng = np.random.RandomState(7)
    B = 4  # 2 ids x 2
    batch = {m: rng.randn(B, 256, 128, 3) for m in MODS[:num_mods]}
    batch["pid"] = np.array([0, 0, 5, 5])
    batch["camid"] = np.arange(B) % 6
    return jcfg, state, step, batch


@pytest.mark.parametrize("num_mods", [3, 2], ids=["three", "two"])
def test_uncompacted_train_steps_match_jax(x64, num_mods):
    jcfg, state, step, batch = _train_setup(num_mods)
    params0, mstate0 = to_numpy_tree(state.params), to_numpy_tree(state.model_state)
    model = port_editor(jcfg, params0, mstate0, use_pallas=True)
    tcfg = Config()
    tstep = build_train_step(model, make_optimizer(tcfg, model),
                             make_loss(tcfg, jcfg.num_classes), make_scheduler(tcfg),
                             tcfg.SOLVER.BASE_LR, compute_dtype=torch.float64)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for epoch in (1, 2):
        state, ref = step(state, jbatch, jnp.asarray(epoch))
        got = tstep(tbatch, epoch)
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=1e-7)
        assert float(got["acc"]) == float(ref["acc"])
    ref_sd = state_dict_from_jax(to_numpy_tree(state.params),
                                 to_numpy_tree(state.model_state), jcfg)
    sd0 = state_dict_from_jax(params0, mstate0, jcfg)
    got_sd = model.state_dict()
    moved = 0
    for name, _ in model.named_parameters():
        start = sd0[name].numpy()
        d_got, d_ref = got_sd[name].numpy() - start, ref_sd[name].numpy() - start
        np.testing.assert_allclose(d_got, d_ref, rtol=0,
                                   atol=max(1e-7 * np.abs(d_ref).max(), 1e-15), err_msg=name)
        moved += name.startswith("FUSE_block.attn1.") and np.abs(d_ref).max() > 0
    assert moved == 2  # the joint attention's qkv and proj learned (through K7's plain VJP)


def _compaction_cfg(compact: bool) -> EditorConfig:
    """32 patches with bound 2 + 3 x 4 x 1 = 14: the compact tail keeps 15."""
    vit = vit_tiny_test_config(img_size=(128, 64), patch_size=16, stride_size=(16, 16),
                               camera=4, drop_path_rate=0.0)
    return EditorConfig(num_classes=4, vit=vit, head_keep=1, frequency_keep=2,
                        compact_tail=compact)


def test_compact_and_uncompacted_tails_agree_in_the_port():
    from editor_tpu_torch.models.editor import _tail_keep_count

    assert _tail_keep_count(_compaction_cfg(True), 3) < 32
    full = editor_init(_compaction_cfg(False), seed=0, device="cpu").double()
    comp = editor_init(_compaction_cfg(True), seed=0, device="cpu").double()
    comp.load_state_dict(full.state_dict(), strict=True)
    rng = np.random.RandomState(1)
    imgs = {m: torch.from_numpy(rng.randn(8, 128, 64, 3)) for m in MODS}
    cam, labels = torch.zeros(8, dtype=torch.long), torch.arange(8) // 2
    with torch.no_grad():
        assert_close(full(imgs, cam), comp(imgs, cam).numpy())
    o_full = full(imgs, cam, training=True, labels=labels,
                  generator=torch.Generator().manual_seed(2))
    o_comp = comp(imgs, cam, training=True, labels=labels,
                  generator=torch.Generator().manual_seed(2))
    assert_close(o_full.score, o_comp.score.detach().numpy())
    assert_close(o_full.aux_loss, o_comp.aux_loss.detach().numpy(), rtol=1e-6, atol=1e-7)
    for name in ("FUSE_BN.running_mean", "FUSE_BN.running_var",
                 "FUSE_block.memory_cls.RGB_centers"):
        assert_close(full.state_dict()[name], comp.state_dict()[name].numpy(), rtol=1e-6,
                     atol=1e-7)
