"""FSDP (``TPU.ZERO_STAGE`` 3) in the port against the JAX package's, on the
CPU at float64: the port's ranks are gloo processes (``tests/torch_dp.py``),
JAX runs on the first W of the conftest's 8 virtual CPU devices
(``tests/torch_dp_jax.py``: the tiny config, B = 8 as 4 ids x 2, two SGD
steps from JAX's weights).

* The layout: ``fsdp_shardings`` is JAX's ``_fsdp_leaf_spec`` leaf by leaf
  (by keystr) and ``param_memory_bytes`` JAX's, in all and per device, at
  W = 1, 2 and 4, on the tiny config and at the flagship's shapes (JAX
  through ``jax.eval_shape``, the port on the ``meta`` device): exact.
* The step at W = 2, with and without ``grad_accum=2``, against JAX's
  ``build_train_step(mesh=, state_shardings=fsdp_state_shardings(...),
  gather_params_compute=True)`` at ``test_torch_dp_step.py``'s tolerances
  (loss rtol 1e-7; each parameter's change within 1e-7 of that tensor's
  largest change or atol 1e-15; BN stats rtol 1e-7 / atol 1e-8; OCFR
  centers rtol 1e-6 / atol 1e-7); each rank's block of each sharded leaf
  against JAX's device-r block of it (its change within 1e-7 of the leaf's
  largest change, or 1e-15); against the port's global-batch step within
  1e-12 (the same sums; one more all-gather and one more reduce-scatter a
  step, the same all-reduces); ``shard_params`` of the gathered model = the
  blocks held. Between steps each rank's parameter storage is JAX's
  ``param_memory_bytes`` per device, and its slot bytes JAX's per-device
  momentum bytes less those of the frozen legacy head ``BACKBONE.fc``,
  which the port's optimizer gives no slot.
* Checkpoints: written at W = 2 (the single-device format), resumed at
  W = 2 with FSDP (bit for bit the uninterrupted run's second step), at
  W = 1 in a group of one with FSDP and at W = 1 in one process without a
  mesh (within 1e-12).
"""

import jax
import numpy as np
import pytest
import torch

from editor_tpu.config import Config as JaxConfig
from editor_tpu.models.editor import editor_config_from as jax_editor_config_from
from editor_tpu.models.editor import editor_init as jax_editor_init
from editor_tpu.parallel.fsdp import _fsdp_leaf_spec
from editor_tpu.parallel.fsdp import param_memory_bytes as jax_param_memory_bytes
from editor_tpu_torch.config import Config
from editor_tpu_torch.models.editor import Editor, editor_config_from
from editor_tpu_torch.parallel.fsdp import fsdp_shardings, param_memory_bytes
from tests.torch_dp import finish, run_ranks, start_ranks
from tests.torch_dp_jax import (close_to_jax, device_shards, jax_fsdp, jax_setup,
                                jax_state_dict, make_batch, port_inputs, tiny_jax_config)
from tests.torch_parity import torch_editor_config, x64  # noqa: F401


class _Mesh:  # what JAX's param_memory_bytes reads of a mesh
    def __init__(self, W):
        self.shape = {"data": W}


def _shapes(config):
    if config == "tiny":
        jcfg = tiny_jax_config()
        ecfg = torch_editor_config(jcfg)
    else:
        jcfg = jax_editor_config_from(JaxConfig(), 171, 15)
        ecfg = editor_config_from(Config(), 171, 15)
    params = jax.eval_shape(lambda k: jax_editor_init(k, jcfg)[0], jax.random.PRNGKey(0))
    return params, Editor(ecfg, device="meta")


@pytest.mark.parametrize("config", ["tiny", "flagship"])
@pytest.mark.parametrize("W", [1, 2, 4])
def test_fsdp_specs_and_memory_match_jax(config, W):
    params, model = _shapes(config)
    leaves = {jax.tree_util.keystr(p): l
              for p, l in jax.tree_util.tree_flatten_with_path(params)[0]}
    got = fsdp_shardings(model, W)
    assert set(got) == set(leaves)
    for key, leaf in leaves.items():
        assert got[key] == tuple(_fsdp_leaf_spec(leaf, W)), key
    assert any(got.values())
    for per_device in (True, False):
        assert param_memory_bytes(model, per_device, W) == jax_param_memory_bytes(
            params, per_device, _Mesh(W)), per_device


def _expected_bytes(state, W):
    params = jax_param_memory_bytes(state.params, True, _Mesh(W))
    slots = {k: v for k, v in state.opt_state.momentum.items()}
    slots["BACKBONE"] = {k: v for k, v in slots["BACKBONE"].items() if k != "fc"}
    return params, jax_param_memory_bytes(slots, True, _Mesh(W))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_fsdp_step_matches_jax_and_the_global_step(x64, grad_accum, tmp_path):
    jcfg, cfg, opt, state = jax_setup()
    batch = make_batch()
    inp = port_inputs(jcfg, state, batch, grad_accum=grad_accum)
    sd0 = inp["sd"]
    launch = start_ranks("train", 2, tmp_path, dict(inp, runs=[{"kind": "fsdp"},
                                                               {"kind": "global"}]))
    ref_losses, ref_state, mesh = jax_fsdp(state, batch, 2, grad_accum=grad_accum)
    got = finish(launch)
    fsdp, glob = got[0]
    assert close_to_jax(fsdp, ref_losses, jax_state_dict(jcfg, ref_state), sd0)
    for r in range(2):  # every rank holds the same model, the global step's
        assert all(torch.equal(got[r][0]["sd"][k], fsdp["sd"][k]) for k in sd0)
        np.testing.assert_allclose(got[r][0]["loss"], glob["loss"], rtol=1e-12)
        for k, v in glob["sd"].items():
            np.testing.assert_allclose(got[r][0]["sd"][k].numpy(), v.numpy(), rtol=1e-12,
                                       atol=1e-12, err_msg=k)
        for f, g in zip(got[r][0]["collectives"], got[r][1]["collectives"]):
            assert f == dict(g, all_gather=g["all_gather"] + 1,
                             reduce_scatter=g["reduce_scatter"] + 1), (f, g)
    # each rank's blocks are JAX's device-r blocks
    start = {jax.tree_util.keystr(p): np.asarray(l)
             for p, l in jax.tree_util.tree_flatten_with_path(state.params)[0]}
    final = {jax.tree_util.keystr(p): l
             for p, l in jax.tree_util.tree_flatten_with_path(ref_state.params)[0]}
    shards = [got[r][0]["shards"][-1] for r in range(2)]
    assert shards[0] and set(shards[0]) == set(shards[1])
    for key in shards[0]:
        ref_blocks = device_shards(final[key], mesh)
        moved = np.abs(np.asarray(final[key]) - start[key]).max()
        for r in range(2):
            assert shards[r][key].shape == ref_blocks[r].shape, key
            np.testing.assert_allclose(shards[r][key].numpy(), ref_blocks[r], rtol=0,
                                       atol=max(1e-7 * moved, 1e-15), err_msg=f"{key} rank {r}")
            assert torch.equal(got[r][0]["shard_params"][key], shards[r][key]), key
    params_b, slots_b = _expected_bytes(state, 2)
    for r in range(2):
        assert got[r][0]["param_bytes"] == [params_b] * 2
        assert got[r][0]["slot_bytes"] == [slots_b] * 2


def test_fsdp_checkpoint_resumes_at_any_world_size(x64, tmp_path):
    jcfg, _, _, state = jax_setup()
    inp = port_inputs(jcfg, state, make_batch())
    ckpt = str(tmp_path / "fsdp_step1.pt")
    run = run_ranks("train", 2, tmp_path / "w2", dict(inp, runs=[
        {"kind": "fsdp", "save_after": 1, "save_path": ckpt},
        {"kind": "fsdp", "steps": 1, "resume": ckpt}]))
    full, resumed2 = run[0]
    payload = torch.load(ckpt, weights_only=False)  # the single-device format
    model = Editor(inp["ecfg"], device="cpu")
    assert set(payload["model"]) == set(model.state_dict())
    from editor_tpu_torch.solver import make_optimizer
    one = make_optimizer(Config(), model).state_dict()
    assert [[t.shape for t in st["buf"]] for st in payload["optimizer"]["state"]] == [
        [t.shape for t in st["buf"]] for st in one["state"]]
    assert payload["epoch"] == 1 and len(payload["generators"]) == 2
    assert resumed2["loss"] == [full["loss"][1]]
    for k, v in full["sd"].items():
        assert torch.equal(resumed2["sd"][k], v), k
    launch = start_ranks("train", 1, tmp_path / "w1", dict(inp, runs=[
        {"kind": "fsdp", "steps": 1, "resume": ckpt},
        {"kind": "single", "steps": 1, "resume": ckpt}]))
    for resumed1 in finish(launch)[0]:
        np.testing.assert_allclose(resumed1["loss"], [full["loss"][1]], rtol=1e-12)
        for k, v in full["sd"].items():
            np.testing.assert_allclose(resumed1["sd"][k].numpy(), v.numpy(), rtol=1e-12,
                                       atol=1e-12, err_msg=k)


def test_gather_params_compute_needs_the_fsdp_layout():
    """``gather_params_compute`` without the FSDP layout raises, as does a
    ZeRO-1-style layout passed without a mesh (no group is made here)."""
    from editor_tpu_torch.engine.train import build_train_step
    from editor_tpu_torch.losses import make_loss
    from editor_tpu_torch.solver import make_optimizer, make_scheduler

    model = Editor(torch_editor_config(tiny_jax_config()), device="cpu")
    cfg = Config()
    args = (model, make_optimizer(cfg, model), make_loss(cfg, 4), make_scheduler(cfg),
            cfg.SOLVER.BASE_LR)
    with pytest.raises(ValueError, match="FSDP layout"):
        build_train_step(*args, gather_params_compute=True)
    with pytest.raises(ValueError, match="on a mesh"):
        build_train_step(*args, state_shardings=object())
