"""The port's ordered zoo importer (``editor_tpu_torch/utils/zoo_import.py``)
against the JAX package's (``editor_tpu/utils/zoo_import.py``).

* A checkpoint under other names (each module prefix renamed, leaf names
  kept): the port's seeded ``state_dict`` with random BatchNorm tensors, at
  f64. JAX's ``load_torch_zoo_state`` turns it into JAX params and the
  port's loads it into a fresh module: the two forwards agree (largest
  difference over the largest JAX logit at most 1e-12, CAL 1e-8, as the
  forward tests), and the fresh module's logits equal the seeded module's
  bit for bit. CAL (frozen BN biases through ``skip_keys``), MuDeep (bare
  fusion parameters) and IBN-a (InstanceNorm beside BatchNorm).
* A storage-aliased duplicate prefix (CAL's ``base`` / ``base_i``) is
  dropped, the later registration kept, by both importers; a copy in its
  place is a count mismatch in both.
* ``skip_keys`` drops what has no slot; without it CAL's frozen biases are a
  count mismatch in both.
* A wrong count or a wrong shape raises ``ValueError`` with JAX's messages.
* ``state_dict_from_jax_zoo`` loads strictly, given the module or its name
  (the class count inferred), and refuses a tree that does not fit.
"""

from collections import OrderedDict

import numpy as np
import pytest
import torch

from editor_tpu.utils import zoo_import as JZ
from editor_tpu_torch.models.zoo import build_empty, build_model
from editor_tpu_torch.models.zoo.common import BatchNorm
from editor_tpu_torch.utils import zoo_import as Z
from tests.torch_parity import x64  # noqa: F401
from tests.torch_zoo import (TOL, TOL_BY_NAME, draw_params, images, jax_forward, jax_template,
                             max_rel_err, port_forward)

NC = 7


def _randomized(name, seed=5):
    """The port's entry at f64 on the CPU, seeded, its BN tensors random."""
    m = build_model(name, NC, seed=seed, device="cpu").double()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in m.modules():
            if isinstance(bn, BatchNorm):
                c = bn.running_mean.shape[0]
                bn.running_mean.copy_(torch.randn(c, generator=gen, dtype=torch.float64) * 0.5)
                bn.running_var.copy_(torch.rand(c, generator=gen, dtype=torch.float64) * 1.5
                                     + 0.5)
                bn.weight.copy_(torch.rand(c, generator=gen, dtype=torch.float64) + 0.5)
                if not bn.frozen_bias:
                    bn.bias.copy_(torch.randn(c, generator=gen, dtype=torch.float64) * 0.2)
    return m


def _renamed(state):
    """Each module prefix becomes ``ckpt.m{i}``, leaf names kept."""
    out, prefixes = OrderedDict(), {}
    for key, value in state.items():
        prefix, _, leaf = key.rpartition(".")
        out[f"ckpt.m{prefixes.setdefault(prefix, len(prefixes))}.{leaf}"] = value
    return out


def _same_slots(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(Z.module_slots(a), Z.module_slots(b)))


def _fresh(name):
    return build_empty(name, NC).to_empty(device="cpu").double().eval()


@pytest.mark.parametrize("name", ["cal", "mudeep", "resnet50_ibn_a"])
def test_port_importer_agrees_with_jax_s(x64, name):
    seeded = _randomized(name)
    state = seeded.state_dict()
    renamed = _renamed(state)
    names = dict(zip(state, renamed))
    skip = [names[k] for k in Z.frozen_bias_keys(seeded)]
    assert bool(skip) == (name == "cal")
    mod, template = jax_template(name, NC)
    params = JZ.load_torch_zoo_state(draw_params(template), renamed, skip_keys=skip)
    fresh = Z.load_torch_zoo_state(_fresh(name), renamed, skip_keys=skip)
    x = images(name, 2)
    got = port_forward(fresh, x)
    assert max_rel_err(got, jax_forward(mod, params, x)) <= TOL_BY_NAME.get(name, TOL)
    np.testing.assert_array_equal(got, port_forward(seeded, x))


def test_aliased_duplicate_prefix_is_dropped_keeping_the_later():
    seeded = _randomized("resnet18")
    state = seeded.state_dict()
    aliased = OrderedDict((f"base.{k}", v) for k, v in list(state.items())[:6])
    aliased.update(state)
    module = Z.load_torch_zoo_state(_fresh("resnet18"), aliased)
    assert _same_slots(module, seeded)
    _, template = jax_template("resnet18", NC)
    JZ.load_torch_zoo_state(draw_params(template), aliased)
    copied = OrderedDict((k, v.clone()) for k, v in list(aliased.items())[:6])
    copied.update(state)
    for load in (lambda sd: Z.load_torch_zoo_state(_fresh("resnet18"), sd),
                 lambda sd: JZ.load_torch_zoo_state(draw_params(template), sd)):
        with pytest.raises(ValueError, match="leaf count mismatch"):
            load(copied)


def test_skip_keys_drop_what_has_no_slot():
    seeded = build_model("cal", NC, device="cpu")
    state = seeded.state_dict()
    frozen = sorted(Z.frozen_bias_keys(seeded))
    assert len(frozen) == 6 and all(torch.count_nonzero(state[k]) == 0 for k in frozen)
    _, template = jax_template("cal", NC)
    for load in (lambda sd, **kw: Z.load_torch_zoo_state(build_empty("cal", NC)
                                                         .to_empty(device="cpu"), sd, **kw),
                 lambda sd, **kw: JZ.load_torch_zoo_state(draw_params(template), sd, **kw)):
        with pytest.raises(ValueError, match="leaf count mismatch"):
            load(state)
        load(state, skip_keys=frozen)
    extra = OrderedDict(state)
    extra["extra.weight"] = torch.zeros(3)
    Z.load_torch_zoo_state(build_empty("cal", NC).to_empty(device="cpu"), extra,
                           skip_keys=frozen + ["extra.weight"])


def test_wrong_count_and_shape_raise_jax_s_messages():
    state = build_model("squeezenet1_1", NC, device="cpu").state_dict()
    _, template = jax_template("squeezenet1_1", NC)
    short = OrderedDict(list(state.items())[:-1])
    keys = list(state)
    swapped = OrderedDict(state)
    swapped[keys[0]], swapped[keys[2]] = state[keys[2]], state[keys[0]]
    n = len(Z.module_slots(build_empty("squeezenet1_1", NC)))
    for bad, pattern in ((short, rf"leaf count mismatch: .* {n} slots, state_dict provides "
                                 rf"{n - 1} tensors"),
                         (swapped, r"shape mismatch at .* build/registration order diverged")):
        with pytest.raises(ValueError, match=pattern):
            Z.load_torch_zoo_state(build_empty("squeezenet1_1", NC).to_empty(device="cpu"), bad)
        with pytest.raises(ValueError, match=pattern):
            JZ.load_torch_zoo_state(draw_params(template), bad)


def test_numpy_checkpoints_load():
    seeded = build_model("shufflenet_v2_x0_5", NC, device="cpu")
    state = {k: v.numpy() for k, v in seeded.state_dict().items()}
    module = Z.load_torch_zoo_state(build_empty("shufflenet_v2_x0_5", NC)
                                    .to_empty(device="cpu"), state)
    assert _same_slots(module, seeded)


def test_jax_params_carrier_loads_strictly_by_module_or_name():
    _, template = jax_template("hacnn", NC)
    params = draw_params(template, seed=2)
    by_name = Z.state_dict_from_jax_zoo("hacnn", params)
    by_module = Z.state_dict_from_jax_zoo(build_empty("hacnn", NC), params)
    assert list(by_name) == list(by_module) == list(build_empty("hacnn", NC).state_dict())
    assert all(torch.equal(v, by_module[k]) for k, v in by_name.items())
    assert all(by_name[k].dtype == torch.long and int(by_name[k]) == 0
               for k in by_name if k.endswith("num_batches_tracked"))
    m = build_empty("hacnn", NC).to_empty(device="cpu").double()
    m.load_state_dict(by_name, strict=True)
    for bad in (draw_params(jax_template("resnet18", NC)[1]),
                {k: v for k, v in params.items() if k != "cls_local"}):
        with pytest.raises(ValueError):
            Z.state_dict_from_jax_zoo(build_empty("hacnn", NC), bad)
