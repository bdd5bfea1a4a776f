"""The port's global-batch train step on a mesh (``build_train_step(mesh=)``)
against the JAX package's, on the CPU at float64: the port's ranks are gloo
processes (``tests/torch_dp.py``), JAX runs ``build_train_step(mesh=
make_mesh(W))`` on the first W of the conftest's 8 virtual CPU devices
(``tests/torch_dp_jax.py``: the tiny config, B = 8 as 4 ids x 2, two SGD
steps from JAX's weights).

* At W = 2 and 4 against JAX, with the tolerances of
  ``test_torch_train_step.py`` (loss rtol 1e-7; each parameter's change
  within 1e-7 of that tensor's largest change or atol 1e-15; BN running
  stats rtol 1e-7 / atol 1e-8; OCFR centers rtol 1e-6 / atol 1e-7), every
  rank holding the same model, and against the port's own single-process
  step on the same global batch (every tensor within 1e-12: the same sums,
  gathered in another order).
* With ``grad_accum=2`` at W = 2 against JAX's.
"""

import numpy as np
import pytest
import torch

from tests.torch_dp import finish, start_ranks
from tests.torch_dp_jax import (close_to_jax, jax_global, jax_setup, jax_state_dict,
                                make_batch, port_inputs)
from tests.torch_parity import x64  # noqa: F401


@pytest.mark.parametrize("W", [2, 4])
def test_global_batch_step_matches_jax_mesh_step(x64, W, tmp_path):
    jcfg, cfg, opt, state = jax_setup()
    batch = make_batch()
    inp = port_inputs(jcfg, state, batch)
    sd0 = inp["sd"]
    launches = [start_ranks("train", W, tmp_path / "dp", dict(inp, runs=[{"kind": "global"}])),
                start_ranks("train", 1, tmp_path / "single",
                            dict(inp, runs=[{"kind": "single"}]))]
    ref_losses, ref_state = jax_global(state, batch, W)
    got, single = (finish(launch) for launch in launches)
    assert close_to_jax(got[0][0], ref_losses, jax_state_dict(jcfg, ref_state), sd0)
    for r in range(1, W):  # every rank holds the same model
        assert all(torch.equal(got[r][0]["sd"][k], got[0][0]["sd"][k]) for k in sd0)
    np.testing.assert_allclose(got[0][0]["loss"], single[0][0]["loss"], rtol=1e-12)
    for k, v in single[0][0]["sd"].items():
        np.testing.assert_allclose(got[0][0]["sd"][k].numpy(), v.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=k)


def test_global_batch_step_grad_accum_matches_jax(x64, tmp_path):
    jcfg, cfg, opt, state = jax_setup()
    batch = make_batch()
    inp = port_inputs(jcfg, state, batch, grad_accum=2)
    launch = start_ranks("train", 2, tmp_path, dict(inp, runs=[{"kind": "global"}]))
    ref_losses, ref_state = jax_global(state, batch, 2, grad_accum=2)
    got = finish(launch)
    assert close_to_jax(got[0][0], ref_losses, jax_state_dict(jcfg, ref_state), inp["sd"])
    assert int(got[0][0]["sd"]["FUSE_BN.num_batches_tracked"]) == 4  # 2 steps x 2 microbatches
