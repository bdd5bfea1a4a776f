"""The port's tensor parallelism (``parallel/tp.py``, ``TPU.MESH_MODEL`` > 1)
against the JAX package's, on the CPU at float64: the port's ranks are gloo
processes (``tests/torch_dp.py``), JAX runs on the conftest's 8 virtual CPU
devices (``tests/torch_dp_jax.py``: the tiny config and batch; B = 8 as 4 ids
x 2, drop path 0, two SGD steps from JAX's weights). The eval step, the
checkpoints and ``cli.train`` under TP are in ``tests/test_torch_tp_loop.py``.

* The qkv permutation, its inverse and a rank's blocks equal JAX's
  (``qkv_tp_permutation``, ``permute_qkv_params``, the devices' blocks of
  ``editor_tp_shardings``); ``state_dict_from_jax(tp=)`` maps a tree in the
  TP layout to the canonical state dict.
* The TP train step at data 1 x model 2 and data 2 x model 2 against JAX's
  TP step (``build_train_step(mesh=, state_shardings=
  train_state_tp_shardings(...))``), on the uncompacted tail (the tiny
  config: its 8 patches all fit) and the compact one (128 x 64 images, 32
  patches cut to 15): losses and every parameter, BN statistic and OCFR
  center at ``test_torch_dp_step.py``'s tolerances (loss rtol 1e-7, each
  parameter's change within 1e-7 of its largest change), every rank holding
  the same canonical model.
* At bf16 a row-parallel layer on two ranks is JAX's GSPMD form, bit for
  bit: each rank's partial product rounded to bf16, the two summed by the
  all-reduce, then the bias; each rank's input, weight and bias gradients
  are the one-device linear's on its block.
"""

import jax
import numpy as np
import pytest
import torch

from editor_tpu.parallel import tp as jax_tp_mod
from editor_tpu.parallel.mesh import make_mesh as jax_make_mesh
from editor_tpu_torch.parallel import tp
from editor_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.torch_dp import finish, run_ranks, start_ranks
from tests.torch_dp_jax import (close_to_jax, jax_setup, jax_state_dict, jax_tp, make_batch,
                                port_inputs)
from tests.torch_parity import to_numpy_tree, x64  # noqa: F401


def test_qkv_permutation_and_blocks_match_jax(x64):
    for H, D, t in ((4, 24, 2), (12, 64, 2), (12, 64, 4), (8, 96, 4), (6, 64, 3)):
        np.testing.assert_array_equal(tp.qkv_tp_permutation(H, D, t),
                                      jax_tp_mod.qkv_tp_permutation(H, D, t))
    with pytest.raises(ValueError, match="not divisible"):
        tp.qkv_tp_permutation(12, 64, 5)
    jcfg, _, _, state = jax_setup()
    H = jcfg.vit.num_heads
    sd = jax_state_dict(jcfg, state)
    permuted = jax_tp_mod.permute_qkv_params(state.params, H, 2)
    sd_perm = state_dict_from_jax(to_numpy_tree(permuted), to_numpy_tree(state.model_state),
                                  jcfg)
    mine = tp.permute_qkv_params(sd, H, 2)
    assert all(torch.equal(mine[k], sd_perm[k]) for k in sd)
    back = tp.permute_qkv_params(mine, H, 2, inverse=True)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    canon = state_dict_from_jax(to_numpy_tree(permuted), to_numpy_tree(state.model_state),
                                jcfg, tp=2)
    assert all(torch.equal(canon[k], sd[k]) for k in sd)
    # rank r's blocks = JAX's blocks on model device r of a (1, 2) mesh
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    shardings = jax_tp_mod.editor_tp_shardings(permuted, mesh)
    placed = jax.tree_util.tree_map(jax.device_put, permuted, shardings)
    blocks = placed["BACKBONE"]["blocks"]
    for r in range(2):
        mine_r = tp.shard_state_dict(sd, H, 2, r)
        dev = mesh.devices.flat[r]
        for layer, name in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
            w = blocks[layer][name]["w"]
            block = next(np.asarray(s.data) for s in w.addressable_shards if s.device == dev)
            for i in range(jcfg.vit.depth):
                key = f"BACKBONE.base.blocks.{i}.{layer}.{name}.weight"
                np.testing.assert_array_equal(mine_r[key].numpy(), block[i].T, err_msg=key)
        assert tp.shard_dim("BACKBONE.base.blocks.0.attn.proj.bias") is None
        assert mine_r["BACKBONE.base.blocks.0.attn.proj.bias"] is sd[
            "BACKBONE.base.blocks.0.attn.proj.bias"]


@pytest.mark.parametrize("data,compact", [(1, False), (2, False), (1, True), (2, True)],
                         ids=["1x2-uncompacted", "2x2-uncompacted", "1x2-compact",
                              "2x2-compact"])
def test_tp_step_matches_jax(x64, data, compact, tmp_path):
    jcfg, _, _, state = jax_setup(compact)
    batch = make_batch(size=jcfg.vit.img_size)
    inp = port_inputs(jcfg, state, batch)
    W = 2 * data
    launch = start_ranks("train", W, tmp_path, dict(inp, runs=[{"kind": "global", "tp": 2}]))
    ref_losses, ref_state = jax_tp(state, batch, data, 2, compact)
    got = finish(launch, timeout=120)
    assert close_to_jax(got[0][0], ref_losses, jax_state_dict(jcfg, ref_state), inp["sd"])
    for r in range(1, W):  # every rank gathers the same canonical model
        assert all(torch.equal(got[r][0]["sd"][k], got[0][0]["sd"][k]) for k in inp["sd"])
        assert got[r][0]["loss"] == got[0][0]["loss"]


def test_row_parallel_rounds_each_partial_as_jax(tmp_path):
    from editor_tpu_torch.models.layers import linear
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 9, 32, generator=gen).to(torch.bfloat16)
    w, b = torch.randn(16, 32, generator=gen), torch.randn(16, generator=gen)
    g = torch.randn(4, 9, 16, generator=gen).to(torch.bfloat16)
    got = run_ranks("row_parallel", 2, tmp_path, {"x": x, "w": w, "b": b, "g": g})
    halves = [(x[..., s * 16:(s + 1) * 16], w[:, s * 16:(s + 1) * 16]) for s in range(2)]
    want = (linear(*halves[0]) + linear(*halves[1])) + b.to(torch.bfloat16)
    for s, out in enumerate(got):
        assert out["y"].dtype == torch.bfloat16 and torch.equal(out["y"], want)
        xs, ws = (t.clone().requires_grad_(True) for t in halves[s])
        bs = b.clone().requires_grad_(True)
        ((linear(xs, ws) + bs.to(torch.bfloat16)).float() * g.float()).sum().backward()
        assert torch.equal(out["dx"], xs.grad) and torch.equal(out["dw"], ws.grad)
        assert torch.equal(out["db"], bs.grad)
