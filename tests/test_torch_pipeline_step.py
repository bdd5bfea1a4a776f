"""The EDITOR train step through the pipelined backbone
(``build_train_step(backbone=make_pipeline_backbone(mesh, M))``) against the
JAX package's pipelined step, on the CPU at float64: the port's ranks are
gloo processes (``tests/torch_dp.py``), JAX runs on the conftest's virtual
CPU devices (``tests/torch_dp_jax.py``: the pipeline config, 64 x 32, width
96, depth 4, 4 heads; B = 4 as 2 ids x 2; drop path 0; two SGD steps from
JAX's weights).

* On 4 stages (M = 4), on data 2 x stage 2 (M = 2; each data row pipelines
  its rows, the tail gathers the global batch), on stage 2 x model 2
  (M = 2; the blocks Megatron-split inside each stage, the qkv columns
  shard-major, the model cut by ``shard_editor``) and on data 2 x stage 2 x
  model 2 (M = 2, 8 ranks, all three at once): the losses and every
  parameter, BN statistic and OCFR center at ``test_torch_train_step.py``'s
  tolerances (``tests/torch_dp_jax.py::close_to_jax``: loss rtol 1e-7, each
  parameter's change within 1e-7 of its tensor's largest change), and every
  rank holding the same canonical model after the step.
* At drop path 0.1 on 4 stages against the port's single-device step from
  the same weights and generator seed: the pipelined backbone draws what the
  scan backbone draws, so the losses agree within 1e-12 and every parameter
  within 1e-12 of its largest value.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_dp import finish, start_ranks
from tests.torch_dp_jax import (close_to_jax, jax_pp, jax_state_dict, make_pp_batch,
                                port_inputs, pp_jax_setup)
from tests.torch_parity import x64  # noqa: F401

LAYOUTS = {"stage4": (1, 4, 1, 4), "data2-stage2": (2, 2, 1, 2),
           "stage2-model2": (1, 2, 2, 2),
           "data2-stage2-model2": (2, 2, 2, 2)}  # data, stage, model, M


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pipelined_step_matches_jax(x64, layout, tmp_path):
    data, stage, model, M = LAYOUTS[layout]
    jcfg, _, _, state = pp_jax_setup()
    batch = make_pp_batch()
    inp = port_inputs(jcfg, state, batch)
    W = data * stage * model
    launch = start_ranks("train", W, tmp_path, dict(inp, runs=[{
        "kind": "global", "stage": stage, "tp": model, "microbatches": M}]))
    ref_losses, ref_state = jax_pp(batch, data, stage, model, M)
    got = finish(launch, timeout=150)
    assert close_to_jax(got[0][0], ref_losses, jax_state_dict(jcfg, ref_state), inp["sd"])
    for r in range(1, W):  # every rank takes the same step
        assert got[r][0]["loss"] == got[0][0]["loss"]
        assert all(torch.equal(got[r][0]["sd"][k], got[0][0]["sd"][k]) for k in inp["sd"])


def test_pipelined_step_with_drop_path_matches_single_device(x64, tmp_path):
    jcfg, _, _, state = pp_jax_setup()
    inp = port_inputs(jcfg, state, make_pp_batch())
    ecfg = inp["ecfg"]
    inp["ecfg"] = dataclasses.replace(ecfg, vit=dataclasses.replace(ecfg.vit,
                                                                    drop_path_rate=0.1))
    got = finish(start_ranks("train", 4, tmp_path, dict(inp, runs=[
        {"kind": "global", "stage": 4, "microbatches": 4}, {"kind": "single"}])), timeout=150)
    pipe, single = got[0]
    np.testing.assert_allclose(pipe["loss"], single["loss"], rtol=1e-12)
    for k, v in single["sd"].items():
        scale = max(float(v.abs().max()), 1e-30) if v.is_floating_point() else 0
        np.testing.assert_allclose(pipe["sd"][k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-12 * scale, err_msg=k)
