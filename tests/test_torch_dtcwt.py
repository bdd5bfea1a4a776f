"""The port's DTCWT and scattering layers (``editor_tpu_torch/ops/dtcwt.py``)
against the JAX package's (``editor_tpu/ops/dtcwt.py``) at float64.

Every filter family, the ``*_derived`` ones included, against JAX at
float64 on a [2, 32, 16, 3] image, each output within 1e-12 of its largest
magnitude (both sides correlate in fp64 in their own summation order), the
round trip within 1e-9 of the image (the banks reconstruct exactly; fp64
rounding). Level 1 runs the biort pair alone and levels >= 2 the qshift
bank alone on level 1's lowpass, so the families are held one stage at a
time: every biort family at J = 1 (the level it runs) with qshift_a, every
qshift family at J = 2 (one level of its bank; level 3 runs the same code)
with near_sym_a in the 'zero' mode here and the 'symmetric' mode in
``tests/test_torch_dtcwt_symmetric.py``, and J = 3 with antonini and
qshift_c in both modes; every one of the 45 biort x qshift pairs then runs
through the port at J = 3 in both modes on a [1, 32, 16, 1] image, its
level 1 equal to its biort family's J = 1 transform and its round trip
within 1e-9. (JAX's eager transform of a pair costs ~0.2 s alone and ~14 s
beside five other test processes, so the 90 pair-modes are not each run
through JAX.) The
scattering layers (first order, and second order in its symmetric and zero
modes): their values and their gradients against ``jax.vjp`` on the same
cotangent, 1e-12 of the largest magnitude. Every convolution's backward runs
under the TF32 switch, as its forward does (on the card autograd would
otherwise run it under the caller's setting, TF32 by PyTorch's default).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.ops import dtcwt as JD
from editor_tpu_torch.ops import dtcwt as D
from editor_tpu_torch.ops import wavelets as W
from tests.torch_parity import x64  # noqa: F401

BIORTS = list(JD._BIORT)
QSHIFTS = list(JD._QSHIFT)
SHAPE = (2, 32, 16, 3)
TOL = 1e-12


def _close(got, ref, what: str, tol: float = TOL) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1.0),
                               err_msg=what)


def _pair(shape, seed):
    x = np.random.RandomState(seed).randn(*shape)
    return torch.from_numpy(x), jnp.asarray(x)


def test_filter_tables_equal_the_jax_package():
    """Every family's filters tap for tap (exact), the legacy aliases too."""
    assert list(D._BIORT) == BIORTS and list(D._QSHIFT) == QSHIFTS
    for b in BIORTS:
        for got, ref in zip(D.biort_filters(b), JD.biort_filters(b)):
            assert np.array_equal(got, ref), b
    for q in QSHIFTS:
        for got, ref in zip(D.qshift_filters(q), JD.qshift_filters(q)):
            assert np.array_equal(got, ref), q
    for name in ("H0A", "H1A", "H0B", "H1B", "G0A", "G0B", "G1A", "G1B"):
        assert np.array_equal(getattr(D, name), getattr(JD, name)), name
    explicit = (np.array([-0.05, 0.25, 0.6, 0.25, -0.05]), np.array([0.25, 0.5, 0.25]))
    for got, ref in zip(D.biort_filters(explicit), JD.biort_filters(explicit)):
        assert np.array_equal(got, ref)
    with pytest.raises(ValueError, match="unknown biort"):
        D.biort_filters("nope")
    with pytest.raises(ValueError, match="unknown qshift"):
        D.qshift_filters("nope")


def _forward_and_inverse(J: int, biort: str, qshift: str, modes=("zero", "symmetric")) -> None:
    xt, xj = _pair(SHAPE, 3)
    for mode in modes:
        kw = dict(mode=mode, biort=biort, qshift=qshift)
        lows, highs = D.dtcwt2(xt, J=J, **kw)
        jlows, jhighs = JD.dtcwt2(xj, J=J, **kw)
        assert len(lows) == 4 and len(highs) == J
        for i, (a, b) in enumerate(zip(lows, jlows)):
            _close(a, b, f"{mode} J={J} low {i}")
        for j, (a, b) in enumerate(zip(highs, jhighs)):
            _close(a, b, f"{mode} J={J} level {j + 1}")
        y = D.idtcwt2(lows, highs, **kw)
        _close(y, JD.idtcwt2(jlows, jhighs, **kw), f"{mode} J={J} inverse")
        _close(y, xt, f"{mode} J={J} round trip", tol=1e-9)


@pytest.mark.parametrize("biort", BIORTS)
def test_biort_family_equals_jax_at_one_level(x64, biort):
    _forward_and_inverse(1, biort, "qshift_a")


@pytest.mark.parametrize("qshift", QSHIFTS)
def test_qshift_family_equals_jax_at_two_levels(x64, qshift):
    _forward_and_inverse(2, "near_sym_a", qshift, ("zero",))


def test_three_levels_equal_jax(x64):
    _forward_and_inverse(3, "antonini", "qshift_c")


@pytest.fixture
def one_thread():
    """torch on one thread for the block (restored after): the image is tiny,
    and beside other busy test processes intra-op threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("qshift", QSHIFTS)
@pytest.mark.parametrize("biort", BIORTS)
def test_every_pair_reconstructs_from_its_families(x64, one_thread, biort, qshift):
    """At J = 3 in both modes: level 1 equals the biort family's J = 1
    transform exactly (levels >= 2 do not touch it), the round trip is
    within 1e-9 of the image."""
    xt, _ = _pair((1, 32, 16, 1), 3)
    one_lows, one_highs = D.dtcwt2(xt, J=1, biort=biort, qshift=qshift)
    for mode in ("zero", "symmetric"):
        kw = dict(mode=mode, biort=biort, qshift=qshift)
        lows, highs = D.dtcwt2(xt, J=3, **kw)
        assert torch.equal(highs[0], one_highs[0]), mode
        _close(D.idtcwt2(lows, highs, **kw), xt, f"{mode} round trip", tol=1e-9)


def test_symmetric_subbands_halve_and_zero_mode_grows(x64):
    xt, _ = _pair(SHAPE, 4)
    _, highs = D.dtcwt2(xt, J=3, mode="symmetric")
    assert [tuple(h.shape) for h in highs] == [(2, 32 >> j, 16 >> j, 3, 6, 2)
                                               for j in (1, 2, 3)]
    _, zhighs = D.dtcwt2(xt, J=2, mode="zero")
    assert tuple(zhighs[1].shape) == (2, 12, 8, 3, 6, 2)  # (16 + 10 - 1) // 2 rows
    with pytest.raises(ValueError, match="divisible by 4"):
        D.dtcwt2(torch.zeros(1, 12, 12, 1, dtype=torch.float64), J=3, mode="symmetric")


def test_magnitude_equals_jax(x64):
    xt, xj = _pair(SHAPE, 5)
    _close(D.dtcwt_magnitude(D.dtcwt2(xt, J=2)[1][1], eps=1e-3),
           JD.dtcwt_magnitude(JD.dtcwt2(xj, J=2)[1][1], eps=1e-3), "magnitude")


@pytest.mark.parametrize("layer,shape", [("scat_layer", (2, 16, 12, 2)),
                                         ("scat_layer_j2", (2, 16, 16, 2)),
                                         ("scat_layer_j2", (2, 20, 12, 2))],
                         ids=["first_order", "j2_symmetric", "j2_zero"])
def test_scattering_values_and_gradients_equal_jax(x64, layer, shape):
    """Values, then the gradient of sum(out * g) for one cotangent g, as
    ``jax.vjp`` gives it. [2, 20, 12, 2] takes the second-order layer's zero
    mode (20 is not a multiple of 8) and its centre crop."""
    xt, xj = _pair(shape, 6)
    xt.requires_grad_(True)
    out = getattr(D, layer)(xt)
    g = np.random.RandomState(7).randn(*out.shape)

    @jax.jit  # one compile for the value and its VJP, not one per op
    def value_and_vjp(x, ct):
        ref, vjp = jax.vjp(getattr(JD, layer), x)
        return ref, vjp(ct)[0]

    ref, ref_grad = value_and_vjp(xj, jnp.asarray(g))
    _close(out, ref, f"{layer} value")
    (out * torch.from_numpy(g)).sum().backward()
    _close(xt.grad, ref_grad, f"{layer} gradient")


@pytest.mark.parametrize("mode", ["zero", "symmetric"])
def test_every_backward_convolution_runs_with_tf32_off(monkeypatch, mode):
    """Each convolution of a round trip (every one feeds the output) has its
    backward under the switch too: it is entered as often in the backward as
    in the forward."""
    entered = []
    switch = W._ieee_fp32

    @contextlib.contextmanager
    def recorded():
        entered.append(1)
        with switch():
            yield

    monkeypatch.setattr(W, "_ieee_fp32", recorded)
    x = torch.randn(1, 16, 16, 2, dtype=torch.float64, requires_grad=True)
    y = D.idtcwt2(*D.dtcwt2(x, J=2, mode=mode), mode=mode)
    forward = len(entered)
    assert forward > 0
    y.sum().backward()
    assert len(entered) == 2 * forward and x.grad is not None
