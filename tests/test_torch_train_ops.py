"""The train path's ops against the JAX package at float64: the K4/K5 plain
VJPs and their autograd Functions, the losses, the optimizer, the LR
schedule, the config loader, and (by their statistics) the augmentation and
drop path.

K4 and K5 are held at the flagship widths (H = 12, D = 64) and token counts
(N = 129; N = 88 and 264), B = 2, against ``jax.vjp`` of the XLA oracles
``_xla_attention_qkv`` and ``_xla_masked_from_qkv``. Tolerance rtol 1e-9 at
f64 (tests/torch_parity.py) unless a test says otherwise: both sides compute
the same formula and differ only in summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.config import Config as JaxConfig
from editor_tpu.config import load_config as jax_load_config
from editor_tpu.losses import batch_hard_triplet as jax_triplet
from editor_tpu.losses import cross_entropy_label_smooth as jax_ce_smooth
from editor_tpu.losses import make_loss as jax_make_loss
from editor_tpu.models.editor import EditorConfig as JaxEditorConfig
from editor_tpu.models.vit import ViTConfig as JaxViTConfig
from editor_tpu.ops.fused_attention import _xla_attention_qkv
from editor_tpu.ops.masked_attention import _xla_masked_from_qkv
from editor_tpu.solver import make_optimizer as jax_make_optimizer
from editor_tpu.solver import make_scheduler as jax_make_scheduler
from editor_tpu_torch import ops
from editor_tpu_torch.config import Config, load_config
from editor_tpu_torch.data.transforms import make_train_augment
from editor_tpu_torch.losses import (batch_hard_triplet, cross_entropy_label_smooth,
                                     make_loss)
from editor_tpu_torch.models.layers import drop_path
from editor_tpu_torch.solver import make_optimizer, make_scheduler
from editor_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.torch_parity import assert_close, jax_editor, port_editor, x64  # noqa: F401

H, D = 12, 64
C = H * D
SCALE = D ** -0.5
FILL = -65504.0


def _arrays(B, N, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(B, N, 3 * C), rng.randn(B, N, C)


def _mask(B, N, seed):
    m = (np.random.RandomState(seed).rand(B, N) < 0.5).astype(np.float64)
    m[:, 0] = 1.0  # the cls token is always kept
    m[1, N // 2:] = 0.0  # whole masked query rows and key columns
    return m


def _jax_vjp(fn, qkv, g):
    _, vjp = jax.vjp(fn, jnp.asarray(qkv))
    return np.asarray(vjp(jnp.asarray(g))[0])


# ---------------------------------------------------------------- K4 / K5

def test_attention_qkv_bwd_plain_matches_jax_vjp(x64):
    qkv, g = _arrays(2, 129, 0)
    ref = _jax_vjp(lambda t: _xla_attention_qkv(t, H, SCALE, False), qkv, g)
    got = ops.attention_qkv_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(g), H, SCALE)
    assert got.shape == qkv.shape and got.dtype == torch.float64
    assert_close(got, ref)


@pytest.mark.parametrize("N", [88, 264])
def test_masked_attention_bwd_plain_matches_jax_vjp(x64, N):
    qkv, g = _arrays(2, N, N)
    m = _mask(2, N, N + 1)
    ref = _jax_vjp(lambda t: _xla_masked_from_qkv(t, jnp.asarray(m), H, SCALE, FILL), qkv, g)
    got = ops.masked_attention_qkv_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(m),
                                             torch.from_numpy(g), H, SCALE, FILL)
    assert_close(got, ref)


def test_attention_bwd_plain_matches_autograd_of_forward():
    qkv, g = (torch.from_numpy(a) for a in _arrays(2, 129, 2))
    t = qkv.clone().requires_grad_()
    (ref,) = torch.autograd.grad(ops.attention_qkv_plain(t, H, SCALE, False), t, g)
    assert_close(ops.attention_qkv_bwd_plain(qkv, g, H, SCALE), ref.numpy())


@pytest.mark.parametrize("N", [88, 264])
def test_masked_bwd_plain_matches_autograd_of_forward(N):
    qkv, g = (torch.from_numpy(a) for a in _arrays(2, N, N + 2))
    m = torch.from_numpy(_mask(2, N, N + 3))
    t = qkv.clone().requires_grad_()
    (ref,) = torch.autograd.grad(ops.masked_attention_qkv_plain(t, m, H, SCALE, FILL), t, g)
    assert_close(ops.masked_attention_qkv_bwd_plain(qkv, m, g, H, SCALE, FILL), ref.numpy())


def test_attention_fn_on_cpu_runs_the_plain_vjp_and_drops_probs_grad():
    qkv, g = (torch.from_numpy(a) for a in _arrays(2, 129, 4))
    t = qkv.clone().requires_grad_()
    probs = torch.empty(2, H, 129, 129, dtype=torch.float64)
    out, p = ops.attention_qkv_fn(t, H, SCALE, probs)
    assert p is probs and not p.requires_grad and p.grad_fn is None
    assert_close(out, ops.attention_qkv_plain(qkv, H, SCALE, False).numpy())
    assert_close(p, ops.attention_qkv_plain(qkv, H, SCALE, True)[1].numpy())
    (dq,) = torch.autograd.grad(out, t, g)
    assert_close(dq, ops.attention_qkv_bwd_plain(qkv, g, H, SCALE).numpy())
    out2, none = ops.attention_qkv_fn(t, H, SCALE)  # no probs buffer: out only
    assert none is None and out2.requires_grad
    # a non-contiguous cotangent is made contiguous before the VJP
    (dq2,) = torch.autograd.grad(out2, t, g.transpose(0, 1).contiguous().transpose(0, 1))
    assert_close(dq2, dq.numpy())
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [0] * len(ops.KERNEL_WRAPPERS)


@pytest.mark.parametrize("N", [88, 264])
def test_masked_fn_on_cpu_zero_grad_for_masked_rows(N):
    qkv, g = (torch.from_numpy(a) for a in _arrays(2, N, N + 5))
    m = torch.from_numpy(_mask(2, N, N + 6))
    t = qkv.clone().requires_grad_()
    mt = m.clone().requires_grad_()
    out = ops.masked_attention_qkv_fn(t, mt, H, SCALE, FILL)
    (dq,) = torch.autograd.grad(out, t, g)
    assert_close(dq, ops.masked_attention_qkv_bwd_plain(qkv, m, g, H, SCALE, FILL).numpy())
    assert out.grad_fn is not None and mt.grad is None
    masked_q = dq[:, :, :C][m == 0]
    assert masked_q.numel() > 0 and torch.count_nonzero(masked_q) == 0
    # masked keys of a valid row get exactly zero dk and dv as well
    dkv = dq[:, :, C:][m == 0]
    assert torch.count_nonzero(dkv) == 0


def test_backward_wrappers_listed_and_check_shapes():
    assert ops.attention_qkv_bwd in ops.KERNEL_WRAPPERS
    assert ops.masked_attention_qkv_bwd in ops.KERNEL_WRAPPERS
    qkv, g = (torch.from_numpy(a) for a in _arrays(1, 9, 7))
    with pytest.raises(ValueError):
        ops.attention_qkv_bwd(qkv, g[:, :5], H, SCALE)
    with pytest.raises(ValueError):
        ops.masked_attention_qkv_bwd(qkv, torch.ones(1, 8), g, H, SCALE)


# ---------------------------------------------------------------- losses

def test_label_smoothed_cross_entropy(x64):
    rng = np.random.RandomState(10)
    logits, labels = rng.randn(8, 5) * 3, rng.randint(0, 5, 8)
    ref = jax_ce_smooth(jnp.asarray(logits), jnp.asarray(labels), 5)
    got = cross_entropy_label_smooth(torch.from_numpy(logits), torch.from_numpy(labels), 5)
    assert_close(got, ref)


@pytest.mark.parametrize("margin", [None, 0.3])
def test_batch_hard_triplet(x64, margin):
    rng = np.random.RandomState(11)
    feat, labels = rng.randn(8, 16), np.repeat(np.arange(4), 2)
    ref = jax_triplet(jnp.asarray(feat), jnp.asarray(labels), margin=margin)
    got = batch_hard_triplet(torch.from_numpy(feat), torch.from_numpy(labels), margin=margin)
    assert_close(got, ref)


@pytest.mark.parametrize("no_margin", [True, False])
def test_make_loss_list_protocol(x64, no_margin):
    jcfg, tcfg = JaxConfig(), Config()
    jcfg.MODEL.NO_MARGIN = tcfg.MODEL.NO_MARGIN = no_margin
    rng = np.random.RandomState(12)
    labels = np.repeat(np.arange(4), 2)
    scores = [rng.randn(8, 6) for _ in range(3)]
    feats = [rng.randn(8, 10) for _ in range(3)]
    jf, tf = jax_make_loss(jcfg, 6), make_loss(tcfg, 6)
    for s, f in ((scores, feats), (scores[0], feats[0])):
        as_j = (lambda x: [jnp.asarray(a) for a in x]) if isinstance(s, list) else jnp.asarray
        as_t = (lambda x: [torch.from_numpy(a) for a in x]) if isinstance(s, list) \
            else torch.from_numpy
        assert_close(tf(as_t(s), as_t(f), torch.from_numpy(labels)),
                     jf(as_j(s), as_j(f), jnp.asarray(labels)))
    # scores and features stacking two batches: the targets are tiled
    s2, f2 = rng.randn(16, 6), rng.randn(16, 10)
    assert_close(tf(torch.from_numpy(s2), torch.from_numpy(f2), torch.from_numpy(labels)),
                 jf(jnp.asarray(s2), jnp.asarray(f2), jnp.asarray(labels)))


# ---------------------------------------------------------------- solver

def _tiny_jcfg():
    vit = JaxViTConfig(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                       embed_dim=96, depth=2, num_heads=4, mlp_ratio=2.0, camera=4)
    return JaxEditorConfig(num_classes=10, vit=vit, head_keep=2, frequency_keep=3,
                           use_pallas=False)


@pytest.mark.parametrize("name,large_fc", [("SGD", False), ("SGD", True), ("AdamW", False)])
def test_optimizer_update_matches_jax(x64, name, large_fc):
    """One update from the same params and gradients: SGD (momentum, coupled
    decay; bias lr x2 with its own decay; the fc group at 2 x lr with
    LARGE_FC_LR) and AdamW; BACKBONE.base.fc stays frozen."""
    jcfg = _tiny_jcfg()
    params, state = jax_editor(jcfg)
    cfg, tcfg = JaxConfig(), Config()
    for c in (cfg, tcfg):
        c.SOLVER.OPTIMIZER_NAME, c.SOLVER.LARGE_FC_LR = name, large_fc
        c.SOLVER.WEIGHT_DECAY_BIAS = 0.003  # tell the bias decay from the default
    rng = np.random.RandomState(13)
    grads = jax.tree_util.tree_map(lambda p: rng.randn(*np.shape(p)), params)
    opt = jax_make_optimizer(cfg, params)
    lr = 0.01
    new_params, _ = opt.update(grads, opt.init(params), params, lr)

    model = port_editor(jcfg, params, state)
    gsd = state_dict_from_jax(grads, state, jcfg)
    topt = make_optimizer(tcfg, model)
    for n, p in model.named_parameters():
        p.grad = gsd[n].clone() if p.requires_grad else None
    assert not model.BACKBONE.base.fc.weight.requires_grad
    topt.step(lr)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, new_params), state, jcfg)
    got = model.state_dict()
    for n, _ in model.named_parameters():
        assert_close(got[n], ref[n].numpy())
    assert_close(got["BACKBONE.base.fc.weight"],
                 state_dict_from_jax(params, state, jcfg)["BACKBONE.base.fc.weight"].numpy())


def test_scheduler_matches_jax_epochs_1_to_80(x64):
    """JAX computes the schedule in fp32 and the port in Python floats, so
    they agree to fp32 rounding of lr-sized numbers: rtol 1e-6 with an atol
    of 1e-7 x base (the cosine's tail, where the fp32 cos cancels)."""
    jf, tf = jax_make_scheduler(JaxConfig()), make_scheduler(Config())
    for base in (0.001, 0.002):
        got = [tf(e, base) for e in range(1, 81)]  # past MAX_EPOCHS (70) too
        ref = [float(jf(jnp.asarray(e), base)) for e in range(1, 81)]
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7 * base)


# ---------------------------------------------------------------- config

def test_load_config_matches_jax():
    preset = "configs/RGBNT201.yaml"
    overrides = ["SOLVER.BASE_LR", "0.01", "TPU.GRAD_ACCUM", "2", "INPUT.PADDING", "4"]
    got = load_config(preset, overrides)
    ref = jax_load_config(preset, overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.MODEL.HEAD_KEEP == 2 and got.SOLVER.BASE_LR == 0.01
    with pytest.raises(KeyError):
        load_config(None, ["SOLVER.NO_SUCH_KEY", "1"])


# ---------------------------------------------------------------- by statistics

def test_train_augment_statistics():
    cfg = Config().INPUT
    cfg.PADDING, cfg.PROB, cfg.RE_PROB = 3, 0.5, 0.5
    augment = make_train_augment(cfg)
    B, H_, W_ = 512, 32, 16
    rng = np.random.RandomState(14)
    # each image's pixel value encodes its (row, col), so the crop offset and
    # the flip can be read back from the output
    rows = np.arange(H_)[:, None].repeat(W_, 1)
    cols = np.arange(W_)[None, :].repeat(H_, 0)
    img = np.stack([rows * 7 + 1, cols * 13 + 1, np.full_like(rows, 200)], -1)
    imgs = torch.from_numpy(np.repeat(img[None], B, 0).astype(np.uint8))
    out = augment(imgs, torch.Generator().manual_seed(int(rng.randint(1 << 30))))
    assert out.shape == (B, H_, W_, 3) and out.dtype == torch.float32
    blue = (out[..., 2] - (200 / 255.0 - 0.5) / 0.5).abs() < 1e-6  # unerased, unpadded
    erased = ~blue & (out[..., 2] != -1.0)  # noise: neither the image nor padding
    er_share = float((erased.flatten(1).any(1)).float().mean())
    assert abs(er_share - cfg.RE_PROB) < 0.08
    flips, offsets = [], []
    for b in range(B):
        keep = blue[b]
        if keep.sum() < 4:
            continue
        r = ((out[b, ..., 0] * 0.5 + 0.5) * 255.0 - 1) / 7
        c = ((out[b, ..., 1] * 0.5 + 0.5) * 255.0 - 1) / 13
        ys, xs = torch.nonzero(keep, as_tuple=True)
        dy = torch.round(r[ys, xs] - ys.double()).unique()
        dxs = torch.round(c[ys, xs] - xs.double())
        flipped = bool((dxs.unique().numel() > 1))
        flips.append(flipped)
        offsets.append(int(dy[0]))
        assert dy.numel() == 1 and abs(int(dy[0])) <= cfg.PADDING
    assert abs(np.mean(flips) - cfg.PROB) < 0.08
    assert set(offsets) == set(range(-cfg.PADDING, cfg.PADDING + 1))
    # normalised: a mid-grey pixel maps to ~0, the padding to -1
    assert float(out.min()) < -1.5 and float(out[blue].abs().max()) <= 1.0


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_drop_path_statistics(rate):
    gen = torch.Generator().manual_seed(15)
    B = 20000
    x = torch.ones(B, 3, 2)
    u = torch.rand((B, 1, 1), generator=gen)
    y = drop_path(x, rate, u)
    kept = y[:, 0, 0] != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.02
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1.0 / (1 - rate)))
    assert torch.count_nonzero(y[~kept]) == 0
    assert drop_path(x, rate, None) is x  # eval: identity
