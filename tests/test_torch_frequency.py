"""Overlapping patches (``MODEL.STRIDE_SIZE`` below the patch) and image
sides that 2^J does not divide, against the JAX package at float64.

* ``window_positive_counts`` for VALID windows at any stride: the counts
  equal JAX's ``reduce_window`` counts exactly (int32 both).
* ``frequency_token_select`` at stride 12 / window 16 (the Haar shortcut),
  at sides not divisible by 16 (the general ``wavedec2`` -> band average ->
  ``waverec2`` branch) and with non-Haar waves passed directly: the window
  counts each package computes (read by wrapping its own
  ``window_positive_counts``) are equal exactly and the masks are equal.
  Both sides transform in fp32 in their own summation order; the counts
  read only the sign of each pixel, which such rounding does not move on
  these inputs.
* The tiny EDITOR (depth 2, width 96) at stride 12 and at a side 16 does not
  divide: the eval forward's ``cls4t`` (rtol 1e-9, tests/torch_parity.py)
  and one ``build_train_step`` step (loss rtol 1e-7, each parameter's
  change within 1e-7 of that tensor's largest: the JAX step's fp32 rounding
  points, as tests/test_torch_train_step.py).
* The stride-12 flagship: ``editor_config_from`` gives 210 patches (21 x
  10) and a tail of 87 as JAX's; ``state_dict_from_jax`` of a stride-12 JAX
  model at the flagship width (position embedding [1, 211, 768], depth cut
  to 1) loads strictly and carries every tensor bit for bit; an ImageNet
  ``.pth`` loads into a stride-12 model as JAX's ``load_imagenet_vit``
  loads it (the position grid resized to 5 x 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.config import Config as JaxConfig
from editor_tpu.engine import build_train_step as jax_build_train_step
from editor_tpu.engine import make_train_state
from editor_tpu.losses import make_loss as jax_make_loss
from editor_tpu.models import frequency as jax_frequency
from editor_tpu.models.editor import EditorConfig as JaxEditorConfig
from editor_tpu.models.editor import _tail_keep_count as jax_tail_keep_count
from editor_tpu.models.editor import editor_apply
from editor_tpu.models.vit import ViTConfig as JaxViTConfig
from editor_tpu.solver import make_optimizer as jax_make_optimizer
from editor_tpu.solver import make_scheduler as jax_make_scheduler
from editor_tpu_torch.config import Config
from editor_tpu_torch.engine.train import build_train_step
from editor_tpu_torch.losses import make_loss
from editor_tpu_torch.models import frequency
from editor_tpu_torch.models.editor import _tail_keep_count
from editor_tpu_torch.solver import make_optimizer, make_scheduler
from editor_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.torch_parity import assert_close, port_editor, to_numpy_tree, x64  # noqa: F401

MODS = ("RGB", "NI", "TI")


@pytest.mark.parametrize("hw,window,stride", [((64, 32), 16, 12), ((72, 40), 16, 16),
                                              ((71, 37), 16, 12), ((64, 32), 16, 16),
                                              ((30, 22), 8, 3)])
def test_window_positive_counts_match_jax(x64, hw, window, stride):
    img = np.random.RandomState(sum(hw)).randn(3, *hw).astype(np.float32)
    got = frequency.window_positive_counts(torch.from_numpy(img), window, stride)
    ref = np.asarray(jax_frequency.window_positive_counts(jnp.asarray(img), window, stride))
    assert got.dtype == torch.int32
    assert got.shape == ((3, (hw[0] - window) // stride + 1, (hw[1] - window) // stride + 1))
    np.testing.assert_array_equal(got.numpy(), ref)


def _recorded_counts(module, monkeypatch) -> list:
    """Wrap ``module.window_positive_counts`` to keep what it returns."""
    seen, inner = [], module.window_positive_counts

    def record(*args):
        seen.append(inner(*args))
        return seen[-1]

    monkeypatch.setattr(module, "window_positive_counts", record)
    return seen


# (image side, stride, wave, modalities): the Haar shortcut at stride 12;
# the general branch at sides 16 does not divide (even at every level but
# the last, and odd); non-Haar waves on sides that 16 divides
FREQ_CASES = {
    "stride12": ((64, 32), 12, "haar", 3),
    "side72x40": ((72, 40), 16, "haar", 3),
    "side72x40_stride12": ((72, 40), 12, "haar", 2),
    "side71x37": ((71, 37), 12, "haar", 3),
    "db2": ((64, 32), 12, "db2", 3),
    "bior2.2": ((64, 32), 16, "bior2.2", 3),
    "sym4_side72x40": ((72, 40), 12, "sym4", 2),
}


@pytest.mark.parametrize("case", list(FREQ_CASES))
def test_frequency_token_select_matches_jax(x64, monkeypatch, case):
    hw, stride, wave, n_mods = FREQ_CASES[case]
    rng = np.random.RandomState(len(case))
    mods = [rng.randn(4, *hw, 3) for _ in range(n_mods)]
    got_counts = _recorded_counts(frequency, monkeypatch)
    ref_counts = _recorded_counts(jax_frequency, monkeypatch)
    got = frequency.frequency_token_select([torch.from_numpy(m) for m in mods], keep=5,
                                           stride=stride, window=16, wave=wave)

    def jax_select(*ms):  # one program; the counts traced inside it come out too
        mask = jax_frequency.frequency_token_select(list(ms), keep=5, stride=stride,
                                                    window=16, wave=wave)
        return mask, ref_counts[-1]

    ref, rc = jax.jit(jax_select)(*map(jnp.asarray, mods))
    (gc,) = got_counts
    gc, rc = gc.numpy(), np.asarray(rc)
    grid = ((hw[0] - 16) // stride + 1, (hw[1] - 16) // stride + 1)
    assert gc.shape == rc.shape == (4, *grid)
    np.testing.assert_array_equal(gc, rc)
    assert got.shape == (4, grid[0] * grid[1]) and int(got.sum()) == 4 * 5
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _jax_init(jcfg, dtype=np.float64):
    """JAX ``editor_init`` as one compiled program (tests/torch_parity.py's
    ``jax_editor`` runs it op by op), as numpy trees of ``dtype``."""
    from editor_tpu.models.editor import editor_init as jax_editor_init
    params, state = jax.jit(lambda k: jax_editor_init(k, jcfg))(jax.random.PRNGKey(0))
    return to_numpy_tree(params, dtype), to_numpy_tree(state, dtype)


def _jax_cfg(hw, stride, drop_path=0.1):
    vit = JaxViTConfig(img_size=hw, patch_size=16, stride_size=(stride, stride),
                       embed_dim=96, depth=2, num_heads=4, mlp_ratio=2.0, camera=4,
                       drop_path_rate=drop_path)
    return JaxEditorConfig(num_classes=4, vit=vit, head_keep=2, frequency_keep=3,
                           use_pallas=False)


@pytest.mark.parametrize("hw,stride", [((64, 32), 12), ((72, 40), 12)],
                         ids=["stride12", "stride12_side72x40"])
def test_editor_eval_forward_matches_jax(x64, hw, stride):
    jcfg = _jax_cfg(hw, stride)
    params, state = _jax_init(jcfg)
    model = port_editor(jcfg, params, state)
    grid = ((hw[0] - 16) // stride + 1) * ((hw[1] - 16) // stride + 1)
    assert model.cfg.num_patches == jcfg.num_patches == grid
    assert model.BACKBONE.base.pos_embed.shape == (1, grid + 1, 96)
    rng = np.random.RandomState(5)
    imgs = {m: rng.randn(4, *hw, 3) for m in MODS}
    cam = np.arange(4, dtype=np.int32)
    ref, _ = jax.jit(lambda p, s, i, c: editor_apply(p, s, jcfg, i, cam_ids=c, training=False))(
        params, state, {m: jnp.asarray(v) for m, v in imgs.items()}, jnp.asarray(cam))
    got = model({m: torch.from_numpy(v) for m, v in imgs.items()}, torch.from_numpy(cam))
    assert got.shape == (4, 3 * 96)
    assert_close(got, ref)


def test_train_step_stride12_matches_jax(x64):
    jcfg = _jax_cfg((64, 32), 12, drop_path=0.0)
    cfg = JaxConfig()
    from editor_tpu.models.editor import editor_init as jax_editor_init
    params, _ = jax_editor_init(jax.random.PRNGKey(0), jcfg)
    opt = jax_make_optimizer(cfg, params)
    state = make_train_state(jax.random.PRNGKey(0), jcfg, opt)
    state = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, state)
    step = jax_build_train_step(jcfg, opt, jax_make_loss(cfg, 4), jax_make_scheduler(cfg),
                                cfg.SOLVER.BASE_LR, compute_dtype=jnp.float64, donate=False)
    rng = np.random.RandomState(1)
    batch = {m: rng.randn(8, 64, 32, 3) for m in MODS}
    batch["pid"] = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    batch["camid"] = np.arange(8) % 4
    params0, mstate0 = to_numpy_tree(state.params), to_numpy_tree(state.model_state)
    model = port_editor(jcfg, params0, mstate0)
    tcfg = Config()
    tstep = build_train_step(model, make_optimizer(tcfg, model), make_loss(tcfg, 4),
                             make_scheduler(tcfg), tcfg.SOLVER.BASE_LR,
                             compute_dtype=torch.float64)
    state, ref = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(1))
    got = tstep({k: torch.from_numpy(v) for k, v in batch.items()}, 1)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=1e-7)
    ref_sd = state_dict_from_jax(to_numpy_tree(state.params),
                                 to_numpy_tree(state.model_state), jcfg)
    sd0 = state_dict_from_jax(params0, mstate0, jcfg)
    got_sd = model.state_dict()
    for name, _ in model.named_parameters():
        d_got = got_sd[name].numpy() - sd0[name].numpy()
        d_ref = ref_sd[name].numpy() - sd0[name].numpy()
        np.testing.assert_allclose(d_got, d_ref, rtol=0,
                                   atol=max(1e-7 * np.abs(d_ref).max(), 1e-15), err_msg=name)


def test_flagship_stride12_config_matches_jax():
    from editor_tpu.config import load_config as jax_load_config
    from editor_tpu.models.editor import editor_config_from as jax_config_from
    from editor_tpu_torch.config import load_config
    from editor_tpu_torch.models.editor import editor_config_from
    from editor_tpu_torch.config import RGBNT201_PRESET

    opts = RGBNT201_PRESET + ["MODEL.STRIDE_SIZE", "[12, 12]"]
    ecfg = editor_config_from(load_config(None, opts), 171, 6)
    jcfg = jax_config_from(jax_load_config(None, opts), 171, 6)
    assert ecfg.vit.stride_size == jcfg.vit.stride_size == (12, 12)
    assert (ecfg.vit.num_y, ecfg.vit.num_x) == (21, 10)
    assert ecfg.num_patches == jcfg.num_patches == 210
    assert _tail_keep_count(ecfg, 3) == jax_tail_keep_count(jcfg, 3) == 87


def test_state_dict_from_jax_stride12_flagship_width(x64):
    vit = JaxViTConfig(img_size=(256, 128), patch_size=16, stride_size=(12, 12),
                       embed_dim=768, depth=1, num_heads=12, mlp_ratio=4.0, camera=6)
    jcfg = JaxEditorConfig(num_classes=171, vit=vit, head_keep=2, frequency_keep=10,
                           use_pallas=False)
    params, state = _jax_init(jcfg, dtype=np.float32)
    assert params["BACKBONE"]["pos_embed"].shape == (1, 211, 768)
    sd = state_dict_from_jax(params, state, jcfg)
    model = port_editor(jcfg, params, state, dtype=torch.float32)
    assert model.BACKBONE.base.pos_embed.shape == (1, 211, 768)
    got = model.state_dict()
    assert got.keys() == sd.keys()
    for name, t in sd.items():
        assert torch.equal(got[name], t), name
    np.testing.assert_array_equal(got["BACKBONE.base.pos_embed"].numpy(),
                                  params["BACKBONE"]["pos_embed"])


def test_load_imagenet_vit_resizes_to_the_stride12_grid(x64, tmp_path):
    """An ImageNet ``.pth`` (a 14 x 14 position grid) into the tiny model at
    stride 12 (a 5 x 2 grid): the port's ``load_imagenet_vit`` gives JAX's
    parameters exactly, through ``state_dict_from_jax``."""
    from editor_tpu.utils import torch_convert as jax_convert
    from editor_tpu_torch.utils import torch_convert
    from tests.test_torch_cli import _imagenet_file

    path = str(tmp_path / "vit.pth")
    _imagenet_file(path)
    jcfg = _jax_cfg((64, 32), 12)
    params, state = _jax_init(jcfg, dtype=np.float32)
    model = port_editor(jcfg, params, state, dtype=torch.float32)
    jparams = dict(params, BACKBONE=to_numpy_tree(jax_convert.load_imagenet_vit(
        path, jcfg.vit, params["BACKBONE"])))
    ref = state_dict_from_jax(jparams, state, jcfg)
    torch_convert.load_imagenet_vit(path, model)
    got = model.state_dict()
    assert got["BACKBONE.base.pos_embed"].shape == (1, 11, 96)
    for k, v in got.items():
        assert torch.equal(v, ref[k].to(v.dtype)), k
