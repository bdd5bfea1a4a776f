"""The port's DTCWT against the JAX package's at float64 in the level->=2
'symmetric' mode (the reference's default): every qshift family at J = 2
(one level of its double-rate bank) with near_sym_a on a [2, 32, 16, 3]
image, the lows, highs and inverse within 1e-12 of their largest magnitude
and the round trip within 1e-9 of the image (``tests/test_torch_dtcwt.py``
holds the 'zero' mode, the biort families, every pair's reconstruction and
the scattering layers; the two files run side by side, each under its own
JAX compiles)."""

import pytest

from tests.test_torch_dtcwt import QSHIFTS, _forward_and_inverse
from tests.torch_parity import x64  # noqa: F401


@pytest.mark.parametrize("qshift", QSHIFTS)
def test_qshift_family_equals_jax_at_two_levels_symmetric(x64, qshift):
    _forward_and_inverse(2, "near_sym_a", qshift, ("symmetric",))
