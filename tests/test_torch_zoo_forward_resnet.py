"""Forward parity of the port's CNN zoo with the JAX package's at float64:
the ResNet, SENet and DenseNet families (plain, ResNeXt, fc512 with
last stride 1, IBN-a, IBN-b's pre-ReLU InstanceNorm, PCB's part pooling,
resnet50mid's fusion, both SE bottlenecks and the ceil_mode stem, the dense
concatenations).

For each entry, one per code path: numpy weights drawn from a seed onto the
JAX ``init``'s shapes (every BatchNorm tensor at random), JAX's ``apply``
under ``jax.jit`` and the port's module (the weights through
``state_dict_from_jax_zoo``, one torch thread) on the same images, at the
sizes of ``tests/test_zoo_golden.py:28-35`` (else 64x32), B = 2 but
the heaviest four (``tests/torch_zoo.ONE_IMAGE``). The
largest difference over the largest JAX logit must be at most 1e-12 (the
reference goldens saw <= 5e-15).
"""

import pytest

from tests.torch_parity import x64  # noqa: F401
from tests.torch_zoo import FORWARD_NAMES, TOL, TOL_BY_NAME, forward_parity, ordered_structure

NAMES = FORWARD_NAMES["resnet"]


@pytest.mark.parametrize("name", NAMES)
def test_forward_equals_jax_at_f64(x64, name):
    assert forward_parity(name) <= TOL_BY_NAME.get(name, TOL)


@pytest.mark.parametrize("name", NAMES)
def test_ordered_structure_matches_jax(name):
    """The slot stream equals JAX's ordered leaves (the other entries' in
    ``tests/test_torch_zoo_structure.py``), on this file's JAX trace."""
    got, want = ordered_structure(name, 7)
    assert got == want
