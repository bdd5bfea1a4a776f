"""The port's eval-forward modules against the JAX package at float64.

The JAX side runs as its CPU tests run it (XLA paths, ``use_pallas=False``);
the port runs its kernel wrappers on CPU tensors, which take the plain
versions. Both get the same weights (``state_dict_from_jax``) and the same
numpy inputs. Tolerance rtol 1e-9 (tests/torch_parity.py): at f64 the two
differ only in summation order, and the top-k selections must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.models.editor import EditorConfig as JaxEditorConfig
from editor_tpu.models.editor import _tail_keep_count as jax_tail_keep_count
from editor_tpu.models.editor import editor_apply
from editor_tpu.models.frequency import frequency_token_select as jax_freq_select
from editor_tpu.models.frequency import topk_bool_mask as jax_topk_bool_mask
from editor_tpu.models.fusion import blockmask_apply
from editor_tpu.models.sfts import sfts_select as jax_sfts_select
from editor_tpu.models.vit import ViTConfig as JaxViTConfig
from editor_tpu.models.vit import vit_apply
from editor_tpu_torch.models.editor import _tail_keep_count
from editor_tpu_torch.models.frequency import frequency_token_select, topk_bool_mask
from editor_tpu_torch.models.sfts import sfts_select
from tests.torch_parity import assert_close, jax_editor, port_editor, x64  # noqa: F401

MODS = ("RGB", "NI", "TI")


def _tiny_cfg():
    vit = JaxViTConfig(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                       embed_dim=96, depth=2, num_heads=4, mlp_ratio=2.0, camera=4)
    return JaxEditorConfig(num_classes=10, vit=vit, head_keep=2, frequency_keep=3,
                           use_pallas=False)


def _flagship_depth2_cfg():
    from __graft_entry__ import _flagship_cfg
    return _flagship_cfg(depth=2, use_pallas=False)


@pytest.fixture(scope="module")
def tiny(x64):
    jcfg = _tiny_cfg()
    params, state = jax_editor(jcfg)
    return jcfg, params, state, port_editor(jcfg, params, state)


def _images(B, hw, seed):
    rng = np.random.RandomState(seed)
    return {m: rng.randn(B, *hw, 3) for m in MODS}


def test_vit_tokens_and_rollout(tiny):
    jcfg, params, _, model = tiny
    x = np.random.RandomState(0).randn(6, 64, 32, 3)
    cam = np.arange(6) % 4
    ref_tok, ref_roll = vit_apply(params["BACKBONE"], jnp.asarray(x), jcfg.vit,
                                  camera_id=jnp.asarray(cam, jnp.int32))
    tok, roll = model.BACKBONE.base(torch.from_numpy(x), torch.from_numpy(cam))
    assert tok.dtype == roll.dtype == torch.float64
    assert_close(tok, ref_tok)
    assert_close(roll, ref_roll)


def test_topk_bool_mask_breaks_ties_by_lowest_index(x64):
    scores = np.random.RandomState(1).randint(0, 4, size=(64, 32)).astype(np.float32)
    for k in (1, 5, 17):
        got = topk_bool_mask(torch.from_numpy(scores), k)
        ref = np.asarray(jax_topk_bool_mask(jnp.asarray(scores), k))
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("ties", [False, True])
def test_frequency_token_select(x64, ties):
    rng = np.random.RandomState(2)
    if ties:
        # signs constant over 8x8 blocks: every window count is a multiple of
        # 64 in [0, 256], so most of the ranking is ties
        signs = np.sign(rng.randn(4, 3, 32, 16, 1)).repeat(8, 2).repeat(8, 3)
        mods = [s * (0.5 + np.abs(rng.randn(4, 256, 128, 3))) for s in signs.transpose(1, 0, 2, 3, 4)]
    else:
        mods = [rng.randn(4, 256, 128, 3) for _ in range(3)]
    got = frequency_token_select([torch.from_numpy(m) for m in mods], keep=10)
    ref = np.asarray(jax_freq_select([jnp.asarray(m) for m in mods], keep=10))
    assert got.shape == (4, 128) and int(got.sum()) == 40
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sfts_select(x64):
    rng = np.random.RandomState(3)
    B, H, P, C = 3, 4, 8, 6
    feats = [rng.randn(B, 1 + P, C) for _ in range(3)]
    rolls = [rng.rand(B, H, P) for _ in range(3)]
    rolls[1][0, 0] = 0.5  # a row of ties
    mask_fre = rng.rand(B, P) < 0.2
    ref_f, ref_idx, _ = jax_sfts_select([jnp.asarray(f) for f in feats],
                                        [jnp.asarray(r) for r in rolls],
                                        jnp.asarray(mask_fre), 1, training=False)
    got_f, got_idx = sfts_select([torch.from_numpy(f) for f in feats],
                                 [torch.from_numpy(r) for r in rolls],
                                 torch.from_numpy(mask_fre), 1)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(ref_idx))
    for g, r in zip(got_f, ref_f):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_blockmask_eval(tiny):
    jcfg, params, state, model = tiny
    rng = np.random.RandomState(4)
    B, n, C = 3, 8, jcfg.dim
    feats = [rng.randn(B, n, C) for _ in range(3)]
    mask = (rng.rand(B, n - 1, 1) < 0.5).astype(np.float64)
    mask[:, 0] = 1.0
    ref, _, _, _ = blockmask_apply(params["FUSE_block"], [jnp.asarray(f) for f in feats],
                                   jnp.asarray(mask), state["ocfr"], None, num_heads=12,
                                   training=False, use_pallas=False)
    got, ocfr, aux = model.FUSE_block([torch.from_numpy(f) for f in feats],
                                      torch.from_numpy(mask))
    assert ocfr is None and aux is None
    assert got.shape == (B, 3 * n, C)
    assert_close(got, ref)


def _cls4t_pair(jcfg, params, state, model, B, seed):
    imgs = _images(B, jcfg.vit.img_size, seed)
    cam = (np.arange(B) % max(jcfg.vit.camera, 1)).astype(np.int32)
    ref, _ = editor_apply(params, state, jcfg, {m: jnp.asarray(v) for m, v in imgs.items()},
                          cam_ids=jnp.asarray(cam), training=False)
    got = model({m: torch.from_numpy(v) for m, v in imgs.items()}, torch.from_numpy(cam))
    return got, np.asarray(ref)


def test_editor_cls4t_tiny(tiny):
    jcfg, params, state, model = tiny
    got, ref = _cls4t_pair(jcfg, params, state, model, B=4, seed=5)
    assert got.shape == (4, 3 * jcfg.dim)
    assert_close(got, ref)


def test_editor_cls4t_flagship_shape_depth2(x64):
    """ViT-B widths (768, 12 heads), 256x128, depth cut to 2, B=2: the
    compact tail runs with keep = 87 (88 tokens per modality, 264 joint)."""
    jcfg = _flagship_depth2_cfg()
    assert jcfg.compact_tail
    assert _tail_keep_count(jcfg, 3) == jax_tail_keep_count(jcfg, 3) == 87
    params, state = jax_editor(jcfg)
    model = port_editor(jcfg, params, state)
    got, ref = _cls4t_pair(jcfg, params, state, model, B=2, seed=6)
    assert got.shape == (2, 3 * 768)
    assert_close(got, ref)


def test_editor_two_modalities(tiny):
    """RGB+NIR only: the JAX block runs the modalities one by one, the port
    batches the two present ones."""
    jcfg, params, state, model = tiny
    imgs = _images(2, jcfg.vit.img_size, 7)
    del imgs["TI"]
    cam = np.array([1, 3], np.int32)
    ref, _ = editor_apply(params, state, jcfg, {m: jnp.asarray(v) for m, v in imgs.items()},
                          cam_ids=jnp.asarray(cam), training=False)
    got = model({m: torch.from_numpy(v) for m, v in imgs.items()}, torch.from_numpy(cam))
    assert got.shape == (2, 2 * jcfg.dim)
    assert_close(got, ref)
