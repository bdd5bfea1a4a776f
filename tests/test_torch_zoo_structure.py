"""The port's CNN zoo (``editor_tpu_torch/models/zoo``) against the JAX
package's, without forwards.

* The factory's 50 names equal JAX's (the reference's ``nasnsetmobile``
  typo included); an unknown name raises JAX's ``KeyError`` text.
* For every entry: the trainable count equals ``TORCH_COUNTS`` (the torch
  oracle at 100 classes, ``tests/test_cnn_zoo.py``), and the port's
  canonical stream of slots (``utils/zoo_import.module_slots``: leaf name and
  shape in the torch layout) equals the ordered leaves of JAX's ``init``
  under ``jax.eval_shape`` after the layout transforms, name for name: here
  for the 24 entries without a forward test, in the forward files for the
  other 26 (on the JAX trace their forward uses). This is what a
  registration order gone wrong breaks, for all 50.
* The facade's four ImageNet counts (``tests/test_zoo_profiling.py:7-15``).
* ``cli.params --cnn``: JAX's lines for one entry; with ``all`` 50 lines in
  sorted order and the sum returned (JAX returns the last entry's count).
* The seeded init holds JAX's distributions (by statistics: each large
  convolution's std within 5% of sqrt(2 / fan_in), linear weights uniform
  within +-1/sqrt(cin), norms 1 and 0, biases 0, MuDeep's fusion weights in
  [0, 1)); the same seed gives the same weights.
* The layers where the two conventions could part: BatchNorm computes in
  fp32 under bf16 and casts back (exact); the ceil_mode max pool equals
  JAX's where ``(size - k) % stride != 0`` and where it is 0 (exact); the
  channel shuffle (exact); HACNN's stripe crop and align-corners resize
  against JAX's at f64 (1e-12, tx and ty out of range included).
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.models.zoo import MODEL_FACTORY as JAX_FACTORY
from editor_tpu.models.zoo import build_model as jax_build_model
from editor_tpu.models.zoo import common as JC
from editor_tpu.models.zoo import light as JL
from editor_tpu.models.zoo import reid_special as JR
from editor_tpu_torch.models import cnn_zoo
from editor_tpu_torch.models.zoo import (MODEL_FACTORY, build_empty, build_model,
                                         model_param_count)
from editor_tpu_torch.models.zoo import common, light, reid_special
from tests.test_cnn_zoo import TORCH_COUNTS
from tests.torch_parity import x64  # noqa: F401
from tests.torch_zoo import FORWARD_NAMES, ordered_structure


def test_factory_names_equal_jax():
    assert list(MODEL_FACTORY) == list(JAX_FACTORY)
    assert set(MODEL_FACTORY) == set(TORCH_COUNTS) and "nasnsetmobile" in MODEL_FACTORY


def test_unknown_name_raises_jax_s_key_error():
    with pytest.raises(KeyError) as want:
        jax_build_model("resnet5", 10)
    with pytest.raises(KeyError) as got:
        build_model("resnet5", 10, device="cpu")
    assert got.value.args == want.value.args


@pytest.mark.parametrize("name", sorted(TORCH_COUNTS))
def test_count_matches_torch(name):
    module = build_empty(name, 100)
    assert common.count_params(module) == model_param_count(name, 100) == TORCH_COUNTS[name]


@pytest.mark.parametrize("name", sorted(set(TORCH_COUNTS) - {
    n for names in FORWARD_NAMES.values() for n in names}))
def test_ordered_structure_matches_jax(name):
    got, want = ordered_structure(name, 100)
    assert got == want


@pytest.mark.parametrize("name,expected_m", [
    ("resnet50", 25.557), ("resnet50_ibn_a", 25.557), ("mobilenetv2", 3.505),
    ("shufflenetv2", 2.279)])
def test_facade_imagenet_counts(name, expected_m):
    assert abs(cnn_zoo.cnn_param_count(name, num_classes=1000) / 1e6 - expected_m) < 0.01
    assert cnn_zoo.CNN_FACTORY is MODEL_FACTORY


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    return ret, buf.getvalue().splitlines()


def test_cli_params_cnn_prints_jax_s_lines():
    from editor_tpu.cli import params as jax_params
    from editor_tpu_torch.cli import params

    argv = ["--cnn", "osnet_x0_25", "--num_classes", "100"]
    assert _run(params.main, argv) == _run(jax_params.main, argv)
    total, lines = _run(params.main, ["--cnn", "all", "--num_classes", "100"])
    assert lines == [f"{n}: {TORCH_COUNTS[n] / 1e6:.3f} M" for n in sorted(TORCH_COUNTS)]
    assert total == sum(TORCH_COUNTS.values())


def test_build_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("resnet18", 10)


def test_seeded_init_holds_jax_s_distributions():
    m = build_model("squeezenet1_0_fc512", 100, seed=3, device="cpu")
    assert not m.training
    convs = [c for c in m.modules() if isinstance(c, common.Conv2d)]
    assert all(c.bias is not None and torch.count_nonzero(c.bias) == 0 for c in convs)
    for c in convs:
        fan_in = c.weight[0].numel()
        if c.weight.numel() >= 20000:
            assert abs(float(c.weight.detach().std()) / (2.0 / fan_in) ** 0.5 - 1) < 0.05
    for lin in [x for x in m.modules() if isinstance(x, common.Linear)]:
        bound = lin.in_features ** -0.5
        w = lin.weight.detach()
        assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.99 * bound
        assert abs(float(w.std()) / (bound / 3 ** 0.5) - 1) < 0.05
        assert torch.count_nonzero(lin.bias) == 0
    bns = [x for x in m.modules() if isinstance(x, common.BatchNorm)]
    assert bns and all(torch.all(b.weight == 1) and torch.all(b.bias == 0)
                       and torch.all(b.running_mean == 0) and torch.all(b.running_var == 1)
                       for b in bns)
    again = build_model("squeezenet1_0_fc512", 100, seed=3, device="cpu").state_dict()
    other = build_model("squeezenet1_0_fc512", 100, seed=4, device="cpu").state_dict()
    assert all(torch.equal(v, again[k]) for k, v in m.state_dict().items())
    assert not torch.equal(m.state_dict()["head.0.weight"], other["head.0.weight"])
    fusion = reid_special.Fusion()
    common.init_weights(fusion, 0)
    a = torch.cat([t.detach().flatten() for t in fusion.weights()])
    assert float(a.min()) >= 0 and float(a.max()) < 1 and abs(float(a.mean()) - 0.5) < 0.05


def test_frozen_bn_biases_are_zero_and_out_of_the_count():
    bn = common.BatchNorm(8, bias=False)
    common.init_weights(bn)
    assert not bn.bias.requires_grad and torch.count_nonzero(bn.bias) == 0
    assert common.count_params(bn) == 8


def test_batchnorm_runs_in_fp32_under_bf16_and_casts_back():
    gen = torch.Generator().manual_seed(0)
    bn = common.BatchNorm(6, eps=1e-3)
    with torch.no_grad():
        bn.running_mean.normal_(0, 0.5, generator=gen)
        bn.running_var.uniform_(0.5, 2.0, generator=gen)
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.normal_(0, 0.2, generator=gen)
        x = torch.randn(3, 6, 5, 4, generator=gen).bfloat16()
        y = bn(x)
        fp32 = bn(x.float())
        formula = ((x.float() - bn.running_mean[:, None, None])
                   * torch.rsqrt(bn.running_var[:, None, None] + 1e-3)
                   * bn.weight[:, None, None] + bn.bias[:, None, None])
        lin = common.Linear(6, 4)
        common.init_weights(lin)
        z = lin(x.mean((2, 3)))
    assert y.dtype == torch.bfloat16 and torch.equal(y, fp32.bfloat16())
    torch.testing.assert_close(fp32, formula, rtol=1e-6, atol=1e-6)
    assert z.dtype == torch.bfloat16
    assert torch.equal(z, torch.nn.functional.linear(x.mean((2, 3)), lin.weight.bfloat16(),
                                                     lin.bias.bfloat16()))


@pytest.mark.parametrize("size", [10, 11, 9, 16])
def test_ceil_mode_maxpool_equals_jax_s(size):
    x = np.random.RandomState(size).randn(2, size, size + 3, 4).astype(np.float32)
    want = JC.maxpool(3, 2, 0, ceil_mode=True).apply({}, jnp.asarray(x))
    got = torch.nn.MaxPool2d(3, 2, 0, ceil_mode=True)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_channel_shuffle_equals_jax_s():
    x = np.random.RandomState(0).randn(2, 3, 5, 12).astype(np.float32)
    for g in (2, 3):
        want = np.asarray(JL._channel_shuffle(jnp.asarray(x), g))
        got = light.channel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), g)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_stripe_crop_and_resize_equal_jax_s(x64):
    rs = np.random.RandomState(0)
    x = rs.randn(4, 20, 8, 3)
    tx = np.array([0.0, 0.9, -0.99, 0.3])
    ty = np.array([0.1, -0.8, 0.99, -0.35])
    want = np.asarray(JR._grid_sample_stripe(jnp.asarray(x), jnp.asarray(ty), jnp.asarray(tx),
                                             sy=0.25))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = reid_special.stripe_crop(xt, torch.from_numpy(tx), torch.from_numpy(ty))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-12)
    want = np.asarray(JR._resize_bilinear_ac(jnp.asarray(x), (12, 14)))
    got = reid_special._resize_ac(xt, (12, 14))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-12)


def test_hacnn_refuses_other_sizes():
    m = build_empty("hacnn", 10)
    with pytest.raises(ValueError, match="160x64"):
        m(torch.empty(1, 3, 256, 128, device="meta"))
    assert tuple(m(torch.empty(1, 3, 160, 64, device="meta")).shape) == (1, 20)
