"""The port's mixture of experts beside a data axis (``parallel/moe.py`` with
``group=``, ``Editor.forward(batch_group=, moe_mesh=|moe_shards=)``, the MoE
eval step on a data mesh) against the JAX package, on the CPU at float64
with JAX x64 on. The port's ranks are gloo processes (``tests/torch_dp.py``,
two launches: 4 ranks for (a) and (b), 2 for (c)); JAX jits each oracle
once over the same layout on the conftest's virtual CPU devices, the batch
sharded ``P('data')`` (under ``jit`` the data axis only places rows, so
each is the global batch's function). The MoE router is
``tests/torch_dp_jax.py::overflowing_router``'s, and the tests count the
(token, choice) pairs past an expert's capacity: the layouts differ only
where capacity binds.

Tolerances (``tests/test_torch_moe.py``'s: both packages run the experts in
fp32 whatever the model's type): outputs within 1e-5 of the largest, losses
rtol 1e-6, the mean of the ranks' gradients within 2e-5 of each tensor's
largest (every rank computes the same loss, so the mean is the loss's
gradient, ``parallel.collectives``), or 1e-15 absolute where a gradient is
zero but for rounding (``close_to_jax``'s floor: the output LayerNorm's
bias, which the BN heads cancel).

* (a) The fusion block in training on a global batch of 4, against
  ``blockmask_apply`` jitted over the same layout: the expert group is the
  data group (``moe_mesh`` = the data ranks, GShard's layout; JAX's
  ``Mesh(devs[:2], ('expert',))`` beside ``Mesh(devs[:2], ('data',))``), a
  2 x 2 ('data', 'expert') mesh, ``moe_shards`` = 2 under a data group of 2
  (each rank's rows a shard) and of 4 (a shard spans two ranks; held to the
  same JAX run as data 2, whose function the data placement does not
  change): the loss, the fused tokens, the aux loss, the gradients.
* (b) The EDITOR (``MODEL.MOE_EXPERTS`` 4, ``jax_setup``'s tiny config)
  with ``moe_mesh`` on the 2 x 2 mesh: the train step's loss and its
  gradients against ``editor_apply(moe_mesh=)`` plus the same loss.
* (c) The eval step (``build_eval_step(mesh=)``) of the EDITOR with 8
  experts on a data mesh of 2 against JAX's ``build_eval_step(jcfg,
  float64, mesh)``: the features of a batch of 8, and of a batch of 7 that
  the step pads against the one-device eval (the padding routes last, and
  the capacity counts the real rows). Routing each rank's rows alone, as
  the eval step did before it took the data group, moves the features of
  8 by 0.71 of a row's norm at most.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from editor_tpu.engine.evaluate import build_eval_step as jax_build_eval_step
from editor_tpu.parallel.mesh import make_mesh as jax_make_mesh
from editor_tpu_torch.models.fusion import moe_masked_mlp
from editor_tpu_torch.parallel import moe
from tests.torch_dp import finish, start_ranks
from tests.torch_dp_jax import (fusion_inputs, jax_fusion_data, jax_moe_editor_grads,
                                jax_setup, make_batch, moe_overflow_state, port_inputs)
from tests.torch_parity import x64  # noqa: F401

FORMS = ("gshard", "data_expert", "shards", "shards_gather")
N_PAD = 7  # a batch the 2 ranks do not divide


def _close(got, ref, rel, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=max(rel * np.abs(ref).max(), 1e-15),
                               err_msg=what)


@pytest.fixture(scope="module")
def runs(x64, tmp_path_factory):
    """Both launches started first, then the JAX oracles: (port outputs,
    JAX results) by case."""
    params, fusion = fusion_inputs(2, experts=8, seed=5, batch=4, overflow=True)
    jcfg4, _, _, state4 = jax_setup(moe_experts=4)
    batch = make_batch()
    editor = port_inputs(jcfg4, state4, batch)
    jcfg8, state8 = moe_overflow_state()
    evals = port_inputs(jcfg8, state8, batch, n_pad=N_PAD)
    launches = [start_ranks("moe_data", 4, tmp_path_factory.mktemp("moe_data"),
                            {"fusion": fusion, "editor": editor}),
                start_ranks("moe_eval", 2, tmp_path_factory.mktemp("moe_eval"), evals)]
    devs = np.asarray(jax.devices())
    pair = Mesh(devs[:2], ("data",))
    de = Mesh(devs[:4].reshape(2, 2), ("data", "expert"))
    shards = jax_fusion_data(params, fusion, pair, moe_shards=2)
    ref = {"gshard": jax_fusion_data(params, fusion, pair,
                                     moe_mesh=Mesh(devs[:2], ("expert",))),
           "data_expert": jax_fusion_data(params, fusion, de, moe_mesh=de),
           "shards": shards, "shards_gather": shards,
           "editor": jax_moe_editor_grads(jcfg4, state4, batch, de)}
    mesh = jax_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    ref["eval"] = np.asarray(jax_build_eval_step(jcfg8, jnp.float64, mesh)(
        state8.params, state8.model_state,
        {k: jnp.asarray(v) for k, v in batch.items() if k != "pid"}))
    got = finish(launches[0], timeout=150)
    got_eval = finish(launches[1], timeout=150)
    return got, got_eval, ref


@pytest.mark.parametrize("form", FORMS)
def test_fusion_block_beside_a_data_axis_matches_jax(runs, form):
    got, _, ref = runs
    r0 = ref[form]
    # expert 2 overflows: the layouts agree where capacity binds
    drops = [g[form]["drops"] for g in got]
    assert sum(drops) > 0, drops
    for g in got:
        np.testing.assert_allclose(g[form]["loss"], r0["loss"], rtol=1e-6)
        np.testing.assert_allclose(g[form]["aux"], r0["aux"], rtol=1e-6)
        _close(g[form]["fused"], r0["fused"], 1e-5, "fused")
    for k, v in got[0][form]["grads"].items():
        _close(sum(g[form]["grads"][k] for g in got) / len(got), r0["grads"][k], 2e-5, k)


def test_editor_with_moe_mesh_beside_a_data_axis_matches_jax(runs):
    got, _, ref = runs
    loss, grads = ref["editor"]
    for g in got:
        np.testing.assert_allclose(g["editor"]["loss"], loss, rtol=1e-6)
    for k in got[0]["editor"]["grads"]:
        _close(sum(g["editor"]["grads"][k] for g in got) / len(got), grads[k], 2e-5, k)


def test_moe_eval_step_on_a_data_mesh_routes_the_global_batch(runs):
    _, got, ref = runs
    assert sum(g["feats_drops"] for g in got) > 0
    for g in got:
        _close(g["feats"], ref["eval"], 1e-5, "features")


def test_moe_eval_step_padding_routes_last(runs):
    _, got, _ = runs
    assert sum(g["padded_drops"] for g in got) > 0
    for g in got:
        assert g["padded"].shape[0] == N_PAD
        _close(g["padded"], g["one_device"], 1e-5, "padded features")


def test_moe_refusals_and_one_device_padding():
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(8, 16, 8, gen)
    p = p._replace(b2=torch.randn(8, 8, generator=gen))  # a dropped zero token shows
    with pytest.raises(ValueError, match="not divisible by moe_shards=3"):
        moe.moe_ffn_shards(p, torch.randn(10, 8, generator=gen), 3)
    x = torch.randn(2, 5, 8, generator=gen)
    m = torch.zeros(2, 5, 1)
    m[:, 0] = 1.0  # masked tokens tie: experts 0 and 1 take 8 of 10 tokens, capacity 5
    with pytest.raises(ValueError, match="valid_rows"):
        moe_masked_mlp(p, x, m, moe_shards=2, valid_rows=1)
    # the rows past valid_rows take no real row's slot, nor count in the capacity
    ref = moe_masked_mlp(p, x, m)[0]
    xx, mm = torch.cat([x, x]), torch.cat([m, m])
    torch.testing.assert_close(moe_masked_mlp(p, xx, mm, valid_rows=2)[0][:2], ref,
                               rtol=0, atol=0)
    assert not torch.equal(moe_masked_mlp(p, xx, mm)[0][:2], ref)
