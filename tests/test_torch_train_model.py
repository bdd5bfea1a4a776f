"""The port's modules in training mode against the JAX package at float64:
the training BatchNorm (three calls threaded in order), OCFR, the BCC loss,
the fusion block's training branch and the whole ``editor_apply(training=
True)`` on the tiny config with ``drop_path_rate=0`` (AL on and off, two and
three modalities).

Tolerance rtol 1e-9 at f64 (tests/torch_parity.py), except where the JAX
function itself computes in fp32 whatever its inputs' dtype: the OCFR
features and centers (ocfr.py:54-74), the BCC loss (sfts.py:68-73) and the
aux loss (editor.py:366). Both packages round to fp32 at the same points but
sum in different orders, so those values agree to fp32 rounding: rtol 1e-6
and, for entries of order 0.1-1, atol 1e-7 (a few fp32 ulps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.models.editor import EditorConfig as JaxEditorConfig
from editor_tpu.models.editor import editor_apply
from editor_tpu.models.fusion import blockmask_apply
from editor_tpu.models.layers import batchnorm1d
from editor_tpu.models.ocfr import ocfr_update_and_loss as jax_ocfr
from editor_tpu.models.sfts import sfts_select as jax_sfts_select
from editor_tpu.models.vit import ViTConfig as JaxViTConfig
from editor_tpu_torch.models.editor import EditorTrainOutput
from editor_tpu_torch.models.layers import BatchNorm1d
from editor_tpu_torch.models.ocfr import ocfr_update_and_loss
from editor_tpu_torch.models.sfts import bcc_loss
from tests.torch_parity import assert_close, jax_editor, port_editor, x64  # noqa: F401

MODS = ("RGB", "NI", "TI")
FP32 = dict(rtol=1e-6, atol=1e-7)


def _tiny_cfg(al=False):
    vit = JaxViTConfig(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                       embed_dim=96, depth=2, num_heads=4, mlp_ratio=2.0, camera=4,
                       drop_path_rate=0.0)
    return JaxEditorConfig(num_classes=6, vit=vit, head_keep=2, frequency_keep=3,
                           al=al, use_pallas=False)


def test_batchnorm_training_three_calls(x64):
    rng = np.random.RandomState(0)
    dim = 16
    w, b = rng.rand(dim) + 0.5, rng.randn(dim)
    state = {"mean": rng.randn(dim), "var": rng.rand(dim) + 0.5}
    bn = BatchNorm1d(dim, device="cpu").double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
        bn.running_mean.copy_(torch.from_numpy(state["mean"]))
        bn.running_var.copy_(torch.from_numpy(state["var"]))
    p = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    st = {k: jnp.asarray(v) for k, v in state.items()}
    for i in range(3):  # RGB, NI, TI through one shared BN, in order
        x = rng.randn(8, dim) * (i + 1) + i
        ref, st = batchnorm1d(p, st, jnp.asarray(x), training=True)
        got = bn(torch.from_numpy(x), training=True)
        assert_close(got, ref)
    assert_close(bn.running_mean, st["mean"])
    assert_close(bn.running_var, st["var"])
    assert int(bn.num_batches_tracked) == 3
    x = rng.randn(4, dim)
    ref, _ = batchnorm1d(p, st, jnp.asarray(x), training=False)
    assert_close(bn(torch.from_numpy(x), training=False), ref)


@pytest.mark.parametrize("n_mods", [2, 3])
def test_ocfr_update_and_loss(x64, n_mods):
    rng = np.random.RandomState(1)
    K, dim, B = 6, 12, 8
    centers = {m: rng.randn(K, dim) * 0.1 for m in ("rgb", "nir", "tir")}
    feats = [rng.randn(B, dim) for _ in range(n_mods)]
    labels = np.array([0, 0, 2, 2, 3, 3, 5, 5])  # classes 1 and 4 absent: kept
    ref_loss, ref_c = jax_ocfr({k: jnp.asarray(v) for k, v in centers.items()},
                               [jnp.asarray(f) for f in feats] + [None] * (3 - n_mods),
                               jnp.asarray(labels), momentum=0.8)
    tc = [torch.from_numpy(centers[m].copy()) for m in ("rgb", "nir", "tir")]
    loss = ocfr_update_and_loss(tc, [torch.from_numpy(f) for f in feats], torch.from_numpy(labels),
                                momentum=0.8)
    assert_close(loss, ref_loss, **FP32)
    for got, m in zip(tc, ("rgb", "nir", "tir")):
        assert_close(got, ref_c[m], **FP32)
    assert_close(tc[0][1], centers["rgb"][1])  # an absent class keeps its center
    assert n_mods == 3 or np.array_equal(tc[2].numpy(), centers["tir"])


def test_bcc_loss(x64):
    rng = np.random.RandomState(2)
    B, P, C = 3, 8, 6
    feats = [rng.randn(B, 1 + P, C) for _ in range(3)]
    rolls = [rng.rand(B, 4, P) for _ in range(3)]
    mask_fre = rng.rand(B, P) < 0.2
    _, index, ref = jax_sfts_select([jnp.asarray(f) for f in feats],
                                    [jnp.asarray(r) for r in rolls], jnp.asarray(mask_fre),
                                    1, training=True)
    got = bcc_loss([torch.from_numpy(f) for f in feats], torch.from_numpy(np.asarray(index)))
    assert got.dtype == torch.float32
    assert_close(got, ref, **FP32)


@pytest.fixture(scope="module")
def tiny(x64):
    jcfg = _tiny_cfg()
    params, state = jax_editor(jcfg)
    rng = np.random.RandomState(3)
    state = jax.tree_util.tree_map(lambda a: a + 0.05 * rng.randn(*a.shape), state)
    return jcfg, params, state


def test_blockmask_training(tiny):
    jcfg, params, state = tiny
    model = port_editor(jcfg, params, state)
    rng = np.random.RandomState(4)
    B, n, C = 4, 8, jcfg.dim
    feats = [rng.randn(B, n, C) for _ in range(3)]
    mask = (rng.rand(B, n - 1, 1) < 0.5).astype(np.float64)
    labels = np.array([1, 1, 4, 4])
    ref, ref_loss, ref_c, _ = blockmask_apply(
        params["FUSE_block"], [jnp.asarray(f) for f in feats], jnp.asarray(mask),
        {k: jnp.asarray(v) for k, v in state["ocfr"].items()}, jnp.asarray(labels),
        num_heads=12, training=True, use_pallas=False)
    got, loss, aux = model.FUSE_block([torch.from_numpy(f) for f in feats],
                                      torch.from_numpy(mask), labels=torch.from_numpy(labels))
    assert aux is None
    assert_close(got, ref)
    assert_close(loss, ref_loss, **FP32)
    mem = model.FUSE_block.memory_cls
    for got_c, m in zip((mem.RGB_centers, mem.NIR_centers, mem.TIR_centers),
                        ("rgb", "nir", "tir")):
        assert_close(got_c, ref_c[m], **FP32)


def _train_pair(jcfg, params, state, mods, seed):
    rng = np.random.RandomState(seed)
    B = 4
    imgs = {m: rng.randn(B, *jcfg.vit.img_size, 3) for m in mods}
    cam = np.arange(B) % 4
    labels = np.array([0, 0, 3, 3])
    ref, new_state = editor_apply(params, state, jcfg, {m: jnp.asarray(v) for m, v in imgs.items()},
                                  labels=jnp.asarray(labels), cam_ids=jnp.asarray(cam),
                                  training=True, rng=jax.random.PRNGKey(seed))
    model = port_editor(jcfg, params, state)
    out = model({m: torch.from_numpy(v) for m, v in imgs.items()}, torch.from_numpy(cam),
                training=True, labels=torch.from_numpy(labels),
                generator=torch.Generator().manual_seed(seed))
    return model, out, ref, new_state


@pytest.mark.parametrize("al,mods", [(False, MODS), (True, MODS), (False, MODS[:2])],
                         ids=["bnneck", "al", "two_modalities"])
def test_editor_training_forward(x64, al, mods):
    jcfg = _tiny_cfg(al)
    if len(mods) == 2:
        jcfg = dataclasses.replace(jcfg, num_modalities=2)
    params, state = jax_editor(jcfg)
    model, out, ref, new_state = _train_pair(jcfg, params, state, mods, seed=5)
    assert isinstance(out, EditorTrainOutput)
    assert len(out.pairs) == len(ref.pairs) == (2 if al else 1 + len(mods))
    for (s, f), (rs, rf) in zip(out.pairs, ref.pairs):
        assert_close(s, rs)
        assert_close(f, rf)
    assert_close(out.score, ref.score)
    assert_close(out.cls4t, ref.cls4t)
    assert out.aux_loss.dtype == torch.float32
    assert_close(out.aux_loss, ref.aux_loss, **FP32)
    for name, st in new_state["bn"].items():
        bn = getattr(model, name)
        assert_close(bn.running_mean, st["mean"])
        assert_close(bn.running_var, st["var"])
    mem = model.FUSE_block.memory_cls
    for got_c, m in zip((mem.RGB_centers, mem.NIR_centers, mem.TIR_centers),
                        ("rgb", "nir", "tir")):
        assert_close(got_c, new_state["ocfr"][m], **FP32)
    # the whole output is differentiable back to the backbone
    total = sum(s.sum() + f.sum() for s, f in out.pairs) + out.aux_loss
    total.backward()
    assert model.BACKBONE.base.blocks[0].attn.qkv.weight.grad is not None


def test_remat_block_recomputes_the_same_gradients():
    """``remat`` (torch.utils.checkpoint around each block, the JAX "block"
    policy) with drop path 0.1: the recompute sees the same drop-path draws,
    so loss and gradients equal those without remat."""
    from editor_tpu_torch.models.editor import EditorConfig, vit_tiny_test_config
    from editor_tpu_torch.models.init import editor_init

    rng = np.random.RandomState(6)
    imgs = {m: torch.from_numpy(rng.randn(4, 64, 32, 3)) for m in MODS}
    labels, cam = torch.tensor([0, 0, 1, 1]), torch.tensor([0, 1, 2, 3])
    grads = []
    for remat in (False, True):
        vit = vit_tiny_test_config(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                                   camera=4, drop_path_rate=0.1, remat=remat)
        model = editor_init(EditorConfig(num_classes=6, vit=vit, head_keep=2,
                                         frequency_keep=3), seed=0, device="cpu").double()
        out = model(imgs, cam, training=True, labels=labels,
                    generator=torch.Generator().manual_seed(7))
        (out.score.square().sum() + out.cls4t.sum() + out.aux_loss).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for n, g in grads[0].items():
        assert_close(grads[1][n], g.numpy())


@pytest.mark.parametrize("change", [dict(attn_drop_rate=0.1), dict(remat=True, remat_policy="dots"),
                                    dict(remat=True, drop_rate=0.1)],
                         ids=["attn_drop", "remat_policy", "remat_dropout"])
def test_unported_training_options_raise(change):
    from editor_tpu_torch.models.editor import EditorConfig, vit_tiny_test_config
    from editor_tpu_torch.models.init import editor_init

    vit = vit_tiny_test_config(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                               camera=4, **change)
    model = editor_init(EditorConfig(num_classes=6, vit=vit), seed=0, device="cpu")
    imgs = {m: torch.zeros(2, 64, 32, 3) for m in MODS}
    with pytest.raises(NotImplementedError):
        model(imgs, torch.tensor([0, 1]), training=True, labels=torch.tensor([0, 1]),
              generator=torch.Generator())
