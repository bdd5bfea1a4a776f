"""The port's wavelet transforms (``editor_tpu_torch/ops/wavelets.py``)
against the JAX package's (``editor_tpu/ops/wavelets.py``) at float64.

Every wave of the tables (the orthogonal ``_REC_LO`` and biorthogonal
``_BIOR`` families) in each of the four pad modes, on an image with an even
side (28) and an odd one (25): one analysis level (``afb2d``) and its
synthesis (``sfb2d``), two levels of ``wavedec2`` / ``waverec2``,
``wavedec1`` / ``waverec1`` along both sides, and two levels of ``swt2`` /
``iswt2`` (whose pad mode 'periodic' stands in for 'periodization'). The
sides are large enough for periodization's two levels at 12 taps (each
level's input at least as long as the filter, which the JAX slices
need). Both sides correlate in fp64 in their own summation order, so each
output is held within 1e-12 of its largest magnitude. The Haar fast path equals the general convolution (1e-12
at f64), and the gradient of ``iswt2 . swt2`` equals ``jax.vjp``'s (1e-12
of its largest magnitude). The TF32 switch of the convolutions holds when
two threads' blocks overlap and leave in the order they entered.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.ops import wavelets as JW
from editor_tpu_torch.ops import wavelets as W
from tests.torch_parity import x64  # noqa: F401

WAVES = sorted(W._REC_LO) + sorted(W._BIOR)
MODES = ["zero", "symmetric", "reflect", "periodization"]
SHAPE = (2, 28, 25, 2)  # H even, W odd
TOL = 1e-12


def _close(got, ref, what: str) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * max(np.abs(ref).max(), 1.0),
                               err_msg=what)


def _pair(shape, seed):
    x = np.random.RandomState(seed).randn(*shape)
    return torch.from_numpy(x), jnp.asarray(x)


def test_tables_equal_the_jax_package():
    assert W._REC_LO == JW._REC_LO and W._BIOR == JW._BIOR
    for wave in WAVES + ["db6", "db11"]:
        for got, ref in zip(W.wavelet_filters(wave), JW.wavelet_filters(wave)):
            np.testing.assert_array_equal(got, ref)
    for n, L in ((19, 8), (20, 2), (7, 12)):
        for mode in MODES:
            assert W.dwt_coeff_len(n, L, mode) == JW.dwt_coeff_len(n, L, mode)


def _dwt_all(mod, x, wave, mode):
    """Every transform of the DWT test on ``x`` through ``mod`` (either
    package's wavelets module): a flat list of outputs."""
    ll, bands = mod.afb2d(x, wave, mode)
    low, highs = mod.wavedec2(x, wave, J=2, mode=mode)
    out = [ll, bands, mod.sfb2d(ll, bands, wave, mode), low, *highs,
           mod.waverec2(low, highs, wave, mode)]
    for x1 in (x[:, :, 0, :], x[:, 0, :, :]):  # [B, N, C] with N even, odd
        lo, his = mod.wavedec1(x1, wave, J=2, mode=mode)
        out += [lo, *his, mod.waverec1(lo, his, wave, mode)]
    return out


DWT_NAMES = ["afb2d ll", "afb2d bands", "sfb2d", "wavedec2 low", "wavedec2 level 1",
             "wavedec2 level 2", "waverec2"] + [
    f"{side} {what}" for side in ("even", "odd")
    for what in ("wavedec1 low", "wavedec1 level 1", "wavedec1 level 2", "waverec1")]


def _swt_all(mod, x, wave, mode):
    coeffs = mod.swt2(x, wave, J=2, mode=mode)
    return [t for level in coeffs for t in level] + [mod.iswt2(coeffs, wave, mode)]


SWT_NAMES = ["swt2 level 1 ll", "swt2 level 1 bands", "swt2 level 2 ll",
             "swt2 level 2 bands", "iswt2"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wave", WAVES)
def test_dwt_matches_jax(x64, wave, mode):
    tx, jx = _pair(SHAPE, seed=len(wave) + len(mode))
    # the JAX side as one program: one compile instead of one per op
    ref = jax.jit(lambda v: _dwt_all(JW, v, wave, mode))(jx)
    got = _dwt_all(W, tx, wave, mode)
    assert len(got) == len(ref) == len(DWT_NAMES)
    for g, r, name in zip(got, ref, DWT_NAMES):
        _close(g, r, name)


@pytest.mark.parametrize("mode", ["periodic", "zero", "symmetric", "reflect"])
@pytest.mark.parametrize("wave", WAVES)
def test_swt2_matches_jax(x64, wave, mode):
    tx, jx = _pair(SHAPE, seed=3)
    ref = jax.jit(lambda v: _swt_all(JW, v, wave, mode))(jx)
    got = _swt_all(W, tx, wave, mode)
    assert len(got) == len(ref) == len(SWT_NAMES)
    for g, r, name in zip(got, ref, SWT_NAMES):
        _close(g, r, name)


def test_haar_fast_path_equals_the_general_convolution():
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 32, 16, 3))
    ll_fast, bands_fast = W._haar_afb2d_fast(x)
    ll_gen, bands_gen = W.afb2d(x, "haar", "zero")
    _close(ll_fast, ll_gen.numpy(), "ll")
    _close(bands_fast, bands_gen.numpy(), "bands")
    _close(W._haar_sfb2d_fast(ll_fast, bands_fast),
           W.sfb2d(ll_gen, bands_gen, "haar", "zero").numpy(), "synthesis")
    _close(W._haar_sfb2d_fast(ll_fast, bands_fast), x.numpy(), "reconstruction")
    assert W._haar_fast_ok(x.shape, "haar", "zero")
    assert not W._haar_fast_ok((2, 31, 16, 3), "haar", "zero")
    assert not W._haar_fast_ok(x.shape, "db2", "zero")


def test_tf32_switch_holds_across_overlapping_threads():
    """Thread a enters, b enters, a leaves, b leaves: TF32 stays off while
    either is inside and is the caller's setting again after both."""
    prev = torch.backends.cudnn.allow_tf32
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def a():
        with W._ieee_fp32():
            a_in.set()
            b_in.wait(10)
        seen["after a"] = torch.backends.cudnn.allow_tf32
        a_out.set()

    def b():
        a_in.wait(10)
        with W._ieee_fp32():
            b_in.set()
            a_out.wait(10)
            seen["inside b"] = torch.backends.cudnn.allow_tf32

    torch.backends.cudnn.allow_tf32 = True
    try:
        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert seen == {"after a": False, "inside b": False}
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("wave", ["haar", "db2", "bior2.2"])
def test_iswt2_gradient_matches_jax_vjp(x64, wave):
    rng = np.random.RandomState(9)
    x, g = rng.randn(1, 16, 12, 2), rng.randn(1, 16, 12, 2)

    def jf(v):
        return JW.iswt2(JW.swt2(v, wave, J=2, mode="periodic"), wave, mode="periodic") ** 2

    (jgrad,) = jax.jit(lambda v, c: jax.vjp(jf, v)[1](c))(jnp.asarray(x), jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = W.iswt2(W.swt2(tx, wave, J=2, mode="periodic"), wave, mode="periodic") ** 2
    (grad,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
    _close(grad, jgrad, "d iswt2(swt2(x))^2 / dx")
