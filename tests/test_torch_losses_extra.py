"""The port's auxiliary losses, the schedule's restarts and noise and the
data pieces off the main path, against the JAX package.

* Losses (``losses/{center,extra,triplet,softmax}.py``): each value and its
  gradient with respect to every feature input against ``jax.value_and_grad``
  on the same inputs, at float64 (rtol 1e-9, atol 1e-12) where JAX computes
  at f64; ``center_loss`` computes in fp32 in both packages, so it is held
  at fp32's (rtol 1e-5, atol 1e-6 of the gradient's largest magnitude).
* ``cosine_lr_schedule`` with restarts (``t_mul``), ``decay_rate``,
  ``cycle_limit`` (0 and finite) and ``warmup_prefix`` on every integer
  epoch of four cycles and some fractional ones: JAX computes in fp32, the
  port in Python floats (rtol 1e-5, atol 1e-9). ``add_lr_noise``: equal bit
  for bit (both draw from a torch generator seeded ``noise_seed + t``).
* ``IdentitySampler``'s indices equal JAX's exactly (the same numpy
  ``RandomState``); ``CyclingIterator``'s sequence equals JAX's.
* ``random_grayscale_patch``: on the box JAX drew the port's grey equals
  JAX's image exactly (f64); its draws by their statistics (the share of
  samples with a box within 4 sigma of the JAX draws', every box's area and
  aspect within the limits, grey pixels grey in all three channels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.data import sampler as JS
from editor_tpu.data import transforms as JT
from editor_tpu.losses import center as JC
from editor_tpu.losses import extra as JE
from editor_tpu.losses import softmax as JSM
from editor_tpu.losses import triplet as JTR
from editor_tpu.solver import schedule as JSCH
from editor_tpu_torch.data import sampler as S
from editor_tpu_torch.data import transforms as T
from editor_tpu_torch.losses import center, extra, softmax, triplet
from editor_tpu_torch.solver import schedule as SCH
from tests.torch_parity import x64  # noqa: F401

P, K, DIM = 4, 3, 6


def _feats(seed, n=P * K, d=DIM, scale=1.0):
    return np.random.RandomState(seed).randn(n, d) * scale


def _grad_check(port_fn, jax_fn, arrays, rtol=1e-9, atol=1e-12, rel_atol=False):
    """The value and the gradient with respect to each of ``arrays``: the
    port through autograd, JAX through ``jax.value_and_grad``."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    val = port_fn(*ts)
    val.backward()
    # one compile for the value and the gradients, not one per op
    ref, grads = jax.jit(jax.value_and_grad(jax_fn, argnums=tuple(range(len(arrays)))))(
        *[jnp.asarray(a) for a in arrays])
    np.testing.assert_allclose(float(val.detach()), float(ref), rtol=rtol, atol=atol)
    for t, g in zip(ts, grads):
        g = np.asarray(g)
        scale = max(np.abs(g).max(), 1e-30) if rel_atol else 1.0
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=rtol, atol=atol * scale)


LABELS = np.repeat(np.arange(P), K)


@pytest.mark.parametrize("margin", [10.0, 0.5])
def test_cluster_loss_equals_jax(x64, margin):
    """Value and gradient of the loss (f64, 1e-9); its intra and inter terms."""
    f = _feats(0, scale=2.0)
    _grad_check(lambda x: extra.cluster_loss(x, None, P, K, margin)[0],
                lambda x: JE.cluster_loss(x, LABELS, P, K, margin)[0], [f])
    got = extra.cluster_loss(torch.from_numpy(f), None, P, K, margin)
    ref = JE.cluster_loss(jnp.asarray(f), LABELS, P, K, margin)
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("k,margin", [(2, 0.1), (3, 5.0)])
def test_range_loss_equals_jax(x64, k, margin):
    """Value and gradient (f64, 1e-9), with the inter term active (margin 5)
    and not (0.1)."""
    f = _feats(1)
    _grad_check(lambda x: extra.range_loss(x, None, P, K, k=k, margin=margin)[0],
                lambda x: JE.range_loss(x, LABELS, P, K, k=k, margin=margin)[0], [f])


@pytest.mark.parametrize("dist_type", ["l2", "l1", "cos"])
def test_hetero_center_loss_equals_jax(x64, dist_type):
    """Value and both gradients (f64, 1e-9)."""
    f1, f2 = _feats(2), _feats(3)
    _grad_check(lambda a, b: extra.hetero_center_loss(a, b, P, K, dist_type=dist_type),
                lambda a, b: JE.hetero_center_loss(a, b, P, K, dist_type=dist_type), [f1, f2])
    with pytest.raises(ValueError):
        extra.hetero_center_loss(torch.from_numpy(f1), torch.from_numpy(f2), P, K,
                                 dist_type="l3")


def test_multi_modal_margin_loss_equals_jax(x64):
    """Value and the three gradients (f64, 1e-9)."""
    fs = [_feats(4), _feats(5), _feats(6)]
    _grad_check(lambda a, b, c: extra.multi_modal_margin_loss(a, b, c, None, P, K, margin=3.0),
                lambda a, b, c: JE.multi_modal_margin_loss(a, b, c, LABELS, P, K, margin=3.0),
                fs)


def test_center_loss_equals_jax_in_fp32(x64):
    """Both packages compute in fp32 whatever the inputs: value and the
    gradients of the features and the centers at fp32's tolerance (rtol
    1e-5, atol 1e-6 of the largest gradient element)."""
    f, c = _feats(7), np.random.RandomState(8).randn(P + 2, DIM)
    _grad_check(lambda x, cc: center.center_loss({"centers": cc}, x, torch.from_numpy(LABELS)),
                lambda x, cc: JC.center_loss({"centers": cc}, x, jnp.asarray(LABELS)),
                [f, c], rtol=1e-5, atol=1e-6, rel_atol=True)
    got = center.center_loss({"centers": torch.from_numpy(c)}, torch.from_numpy(f),
                             torch.from_numpy(LABELS))
    assert got.dtype == torch.float32
    init = center.center_loss_init(torch.Generator().manual_seed(0), 5, 7)["centers"]
    assert init.shape == (5, 7) and init.dtype == torch.float32
    assert torch.equal(init, center.center_loss_init(torch.Generator().manual_seed(0), 5,
                                                     7)["centers"])


@pytest.mark.parametrize("normalize_feature", [False, True])
def test_weighted_regularized_triplet_equals_jax(x64, normalize_feature):
    """Value and gradient (f64, 1e-9); the labels in no P x K order."""
    f = _feats(9, n=10)
    labels = np.array([0, 1, 0, 2, 1, 2, 3, 3, 0, 1])
    _grad_check(lambda x: triplet.weighted_regularized_triplet(
                    x, torch.from_numpy(labels), normalize_feature),
                lambda x: JTR.weighted_regularized_triplet(
                    x, jnp.asarray(labels), normalize_feature), [f])


def test_normalize_and_cosine_dist_equal_jax(x64):
    """Values at f64 (1e-12) and the gradient of a weighted sum of the
    cosine distances (1e-9)."""
    a, b = _feats(10, n=5), _feats(11, n=7)
    np.testing.assert_allclose(triplet.normalize(torch.from_numpy(a)).numpy(),
                               np.asarray(JTR.normalize(jnp.asarray(a))), rtol=0, atol=1e-12)
    w = np.random.RandomState(12).randn(5, 7)
    _grad_check(lambda x, y: (triplet.cosine_dist(x, y) * torch.from_numpy(w)).sum(),
                lambda x, y: (JTR.cosine_dist(x, y) * w).sum(), [a, b])


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.3])
def test_label_smoothing_ce_equals_jax(x64, smoothing):
    """Value and gradient of the logits (f64, 1e-9)."""
    logits = _feats(13, n=6, d=5, scale=3.0)
    t = np.array([0, 4, 2, 2, 1, 3])
    _grad_check(lambda x: softmax.label_smoothing_ce(x, torch.from_numpy(t), smoothing),
                lambda x: JSM.label_smoothing_ce(x, jnp.asarray(t), smoothing), [logits])


def test_losses_exported_as_jax_exports_them():
    import editor_tpu.losses as jl

    import editor_tpu_torch.losses as tl
    names = [n for n in dir(jl) if not n.startswith("_") and callable(getattr(jl, n))]
    assert set(names) <= set(tl.__all__), sorted(set(names) - set(tl.__all__))


# ---------------------------------------------------------------- the schedule

CONFIGS = [
    dict(base_lr=0.008, t_initial=60, lr_min=8e-6, decay_rate=0.1, warmup_t=10,
         warmup_lr_init=8e-5, cycle_limit=1),
    dict(base_lr=0.1, t_initial=10, lr_min=1e-4, decay_rate=0.5, warmup_t=3,
         warmup_lr_init=1e-3, cycle_limit=0, t_mul=2.0),
    dict(base_lr=0.02, t_initial=12, lr_min=1e-5, decay_rate=0.8, warmup_t=5,
         warmup_lr_init=2e-4, cycle_limit=3, t_mul=1.5, warmup_prefix=True),
    dict(base_lr=0.05, t_initial=7, lr_min=0.0, decay_rate=1.0, warmup_t=0,
         warmup_lr_init=0.0, cycle_limit=0),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=["factory", "restarts", "shrinking", "hard"])
def test_cosine_schedule_equals_jax(kw):
    """Every integer epoch of the warmup and four cycles, and quarter
    epochs of the first ones: rtol 1e-5, atol 1e-9 (JAX in fp32)."""
    horizon = 4 * kw["t_initial"] + kw["warmup_t"] + 2
    ts = list(range(horizon)) + [0.25, 1.5, kw["warmup_t"] + 0.75]
    got = [SCH.cosine_lr_schedule(t, **kw) for t in ts]
    ref = [float(JSCH.cosine_lr_schedule(t, **kw)) for t in ts]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9)


def test_cycle_length_lands_on_a_restart():
    """Epoch ``t_initial (t_mul^3 - 1) / (t_mul - 1)`` starts cycle 3 at
    phase 0 (decay 1, unlimited cycles): base_lr, as in JAX."""
    length = int(np.floor(-8 * (2.0 ** 3 - 1) / (1 - 2.0)))
    kw = dict(base_lr=0.1, t_initial=8, lr_min=1e-3, warmup_t=0, warmup_lr_init=0.0,
              decay_rate=1.0, cycle_limit=0, t_mul=2.0)
    assert SCH.cosine_lr_schedule(length, **kw) == pytest.approx(0.1, rel=1e-12)
    assert SCH.cosine_lr_schedule(length, **kw) == pytest.approx(
        float(JSCH.cosine_lr_schedule(length, **kw)), rel=1e-6)


@pytest.mark.parametrize("noise_range_t,noise_type", [(None, "normal"), (5, "normal"),
                                                      ([3, 9], "normal"), (0, "uniform"),
                                                      ([2, 6], "uniform")])
def test_add_lr_noise_equals_jax_bit_for_bit(noise_range_t, noise_type):
    for t in range(12):
        for seed in (42, 7):
            kw = dict(noise_range_t=noise_range_t, noise_pct=0.4, noise_seed=seed,
                      noise_type=noise_type)
            assert SCH.add_lr_noise(0.01, t, **kw) == JSCH.add_lr_noise(0.01, t, **kw), (t, seed)


# ---------------------------------------------------------------- data

def test_identity_sampler_indices_equal_jax():
    rng = np.random.RandomState(15)
    color = rng.randint(0, 6, 40)
    thermal = rng.randint(0, 6, 34)
    color_pos = {p: np.flatnonzero(color == p) for p in range(6)}
    thermal_pos = {p: np.flatnonzero(thermal == p) for p in range(6)}
    for seed in (0, 3):
        got = S.IdentitySampler(color, thermal, color_pos, thermal_pos, 2, 3, seed=seed)
        ref = JS.IdentitySampler(color, thermal, color_pos, thermal_pos, 2, 3, seed=seed)
        assert np.array_equal(got.index1, ref.index1)
        assert np.array_equal(got.index2, ref.index2)
        assert len(got) == len(ref) == 40 and list(got) == list(ref)


@pytest.mark.parametrize("start_epoch", [0, 1])
def test_cycling_iterator_equals_jax(start_epoch):
    def gen(e):
        return iter(range(10 * e, 10 * e + 3 + e % 2))

    assert list(S.CyclingIterator(4, gen, start_epoch)) == list(
        JS.CyclingIterator(4, gen, start_epoch))
    assert list(S.CyclingIterator(1, gen)) == [0, 1, 2]


def test_grayscale_patch_equals_jax_on_the_same_box(x64):
    """JAX draws its boxes; on those pixels the port's grey is JAX's
    output exactly (f64), and off them the image is untouched."""
    x = np.random.RandomState(16).rand(8, 24, 12, 3)
    # op by op: under jit XLA may fuse the grey's multiply-adds (another rounding)
    ref = np.asarray(JT.random_grayscale_patch(jax.random.PRNGKey(3), jnp.asarray(x), 1.0))
    box = (ref != x).any(-1, keepdims=True)
    assert box.any(axis=(1, 2, 3)).sum() >= 6  # JAX drew boxes in most samples
    got = T._gray_box(torch.from_numpy(x), torch.from_numpy(box))
    assert np.array_equal(got.numpy(), ref)


def test_grayscale_patch_statistics():
    """The share of samples with a box within 4 sigma of the JAX draws'
    share (prob 0.5); every box a rectangle whose area is within the limits
    (rounding of its sides included) and aspect within [0.3, 1/0.3]; its
    pixels grey."""
    B, H_, W_ = 400, 32, 16
    x = torch.rand(B, H_, W_, 3, generator=torch.Generator().manual_seed(17))
    out = T.random_grayscale_patch(x, 0.5, torch.Generator().manual_seed(18))
    ref = np.asarray(jax.jit(JT.random_grayscale_patch)(jax.random.PRNGKey(5),
                                                        jnp.asarray(x.numpy()), 0.5))
    changed = (out != x).any(-1)
    share = float(changed.flatten(1).any(1).float().mean())
    ref_share = float((ref != x.numpy()).any(-1).reshape(B, -1).any(1).mean())
    assert abs(share - ref_share) <= 4 * np.sqrt(2 * 0.25 / B)
    for b in torch.nonzero(changed.flatten(1).any(1)).flatten().tolist():
        ys, xs = torch.nonzero(changed[b], as_tuple=True)
        h, w = int(ys.max() - ys.min() + 1), int(xs.max() - xs.min() + 1)
        assert len(ys) == h * w  # a full rectangle
        assert 0.02 * H_ * W_ - h - w <= h * w <= 0.4 * H_ * W_ + h + w + 1
        # the sides are rounded: h / w is the drawn aspect within half a pixel a side
        assert (h + 0.5) / (w - 0.5) >= 0.3 and (h - 0.5) / (w + 0.5) <= 1 / 0.3
        px = out[b][changed[b]]
        assert torch.allclose(px[:, 0], px[:, 1]) and torch.allclose(px[:, 1], px[:, 2])
