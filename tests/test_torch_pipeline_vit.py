"""The port's pipelined EDITOR backbone (``editor_tpu_torch/parallel/
pipeline_vit.py``) on the CPU at float64: its ranks are gloo processes
(``tests/torch_dp.py``, scenario ``pipeline_vit``), the weights JAX's
``editor_init`` of ``tests/torch_dp_jax.py``'s pipeline config (64 x 32,
width 96, depth 4, 4 heads), the images 3 x [4, 64, 32, 3] from a numpy
seed.

* Against JAX's ``make_pipeline_backbone`` in eval, on 4 stages (M = 4) and
  on 2 stages x 2 model ranks (pp x tp, M = 2; the qkv columns shard-major,
  the port's model cut by ``shard_editor``): the tokens within 1e-11
  (absolute; values of order 1), the rollout rows within 1e-6 (both carry
  the product in fp32, as JAX does, and sum it in their own order).
* Against the port's own scan backbone in training at drop path 0.5 with
  the same generator state (4 stages, M = 4): the tokens within 1e-12 (a
  single drop-path draw taken by another row would move them by O(1)), the
  rollout within 1e-6 (the fp32 product against the float64 chain), and
  every backbone gradient of sum(mean(t^2)) within 1e-12 of its tensor's
  largest value.
* The refusals of JAX's: a depth the stages do not divide, dropout in
  training, heads the model axis does not divide.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.parallel.pipeline_vit import make_pipeline_backbone
from editor_tpu.parallel.tp import permute_qkv_params
from tests.torch_dp import finish, start_ranks
from tests.torch_dp_jax import jax_state_dict, make_pp_batch, pp_jax_mesh, pp_jax_setup
from tests.torch_parity import torch_editor_config, x64  # noqa: F401

TOK_TOL, ROLL_TOL = 1e-11, 1e-6
LAYOUTS = {"stage4": (4, 1, 4), "stage2-model2": (2, 2, 2)}  # stage, model, M


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, x64):
    """``ranks(name)``: each rank's output for that layout; both launches
    start together."""
    jcfg, _, _, state = pp_jax_setup()
    batch = make_pp_batch()
    ecfg = torch_editor_config(jcfg)
    ecfg = dataclasses.replace(ecfg, vit=dataclasses.replace(ecfg.vit, drop_path_rate=0.5))
    launches = {}
    for name, (S, tp, M) in LAYOUTS.items():
        inp = {"ecfg": ecfg, "sd": jax_state_dict(jcfg, state), "tp": tp, "M": M,
               "mods": [batch[m] for m in ("RGB", "NI", "TI")], "cam": batch["camid"],
               "drop_path": tp == 1}
        launches[name] = start_ranks("pipeline_vit", S * tp, tmp_path_factory.mktemp(name), inp)
    done = {}

    def get(name):
        if name not in done:
            done[name] = finish(launches[name], timeout=120)
        return done[name]

    return get


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pipelined_backbone_matches_jax(x64, ranks, layout):
    S, tp, M = LAYOUTS[layout]
    jcfg, _, _, state = pp_jax_setup()
    batch = make_pp_batch()
    params = state.params
    if tp > 1:
        params = permute_qkv_params(params, jcfg.vit.num_heads, tp)
    bb = make_pipeline_backbone(pp_jax_mesh(1, S, tp), num_microbatches=M)
    mods = [jnp.asarray(batch[m]) for m in ("RGB", "NI", "TI")]
    toks, rolls = jax.jit(lambda p: bb(p, jcfg, mods, jnp.asarray(batch["camid"]), None,
                                       False, None))(params)
    toks, rolls = np.concatenate(toks), np.concatenate(rolls)
    assert rolls.dtype == np.float32  # JAX carries the product in fp32
    for out in ranks(layout):
        got = out["eval"]
        assert got["rolls"].dtype == torch.float32
        np.testing.assert_allclose(got["toks"].numpy(), toks, rtol=0, atol=TOK_TOL)
        np.testing.assert_allclose(got["rolls"].numpy(), rolls, rtol=0, atol=ROLL_TOL)


def test_pipelined_backbone_drops_what_the_scan_backbone_drops(ranks):
    for out in ranks("stage4"):
        got = out["drop_path"]
        np.testing.assert_allclose(got["toks"].numpy(), got["toks_ref"].numpy(), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(got["rolls"].numpy(), got["rolls_ref"].numpy(), rtol=0,
                                   atol=ROLL_TOL)
        assert set(got["grads"]) >= set(got["grads_ref"])
        for name, ref in got["grads_ref"].items():
            scale = max(float(ref.abs().max()), 1e-30)
            np.testing.assert_allclose(got["grads"][name].numpy(), ref.numpy(), rtol=0,
                                       atol=1e-12 * scale, err_msg=name)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pipelined_backbone_refusals(ranks, layout):
    for out in ranks(layout):
        ref = out["refusals"]
        assert ref["depth"].startswith("ValueError") and "not divisible" in ref["depth"]
        assert ref["dropout"].startswith("NotImplementedError")
        if LAYOUTS[layout][1] > 1:
            assert ref["heads"].startswith("ValueError") and "num_heads" in ref["heads"]
