"""ZeRO-1 and FSDP with the pipelined backbone
(``build_train_step(backbone=make_pipeline_backbone(mesh, 2),
state_shardings=...)``) on data 2 x stage 2 against the JAX package, on the
CPU at float64: the port's four ranks are one gloo launch
(``tests/torch_dp.py``), JAX runs on the conftest's virtual CPU devices
(``tests/torch_dp_jax.py``: the pipeline config, 64 x 32, width 96, depth
4, 4 heads; B = 4 as 2 ids x 2; drop path 0; M = 2; two SGD steps from
JAX's weights).

* Each against JAX's pipelined step on ``pp_jax_mesh(2, 2, 1)`` with
  ``zero1_state_shardings`` or ``fsdp_state_shardings`` (and
  ``gather_params_compute``): the losses and every parameter, BN statistic
  and OCFR center at ``test_torch_tp.py``'s tolerances (loss rtol 1e-7, each
  parameter's change within 1e-7 of its largest change), every rank holding
  the same canonical model.
* ZeRO-1 equals the port's plain pipelined step bit for bit, FSDP within
  1e-12 (the stage sum first, then the data reduce-scatter: the same sums);
  an FSDP rank's parameter storage between steps is ``param_memory_bytes``
  over the data axis, the same on both stages.
"""

import numpy as np
import pytest
import torch

from tests.torch_dp import finish, start_ranks
from tests.torch_dp_jax import (close_to_jax, jax_pp, jax_state_dict, make_pp_batch,
                                port_inputs, pp_jax_setup)
from tests.torch_parity import x64  # noqa: F401

W, M = 4, 2  # data 2 x stage 2
RUNS = {"pp": {"kind": "global"}, "zero1": {"kind": "zero1"}, "fsdp": {"kind": "fsdp"}}


@pytest.fixture(scope="module")
def launch(x64, tmp_path_factory):
    """The one launch of four ranks, started before the JAX oracles."""
    jcfg, _, _, state = pp_jax_setup()
    inp = port_inputs(jcfg, state, make_pp_batch())
    runs = [dict(run, stage=2, microbatches=M) for run in RUNS.values()]
    handle = {"launch": start_ranks("train", W, tmp_path_factory.mktemp("pp_zero"),
                                    dict(inp, runs=runs)), "inp": inp}
    yield handle
    for p in handle["launch"][1]:  # a test that failed before finishing
        if p.poll() is None:
            p.kill()
            p.wait()


def _ranks(launch):
    if "got" not in launch:
        launch["got"] = [dict(zip(RUNS, runs))
                         for runs in finish(launch["launch"], timeout=300)]
    return launch["got"]


@pytest.mark.parametrize("kind", ["zero1", "fsdp"])
def test_pipelined_zero_matches_jax_and_the_pipelined_step(launch, kind):
    jcfg, _, _, _ = pp_jax_setup()
    ref_losses, ref_state = jax_pp(make_pp_batch(), 2, 2, 1, M, layout=kind)
    got = _ranks(launch)
    sd0 = launch["inp"]["sd"]
    run, plain = got[0][kind], got[0]["pp"]
    assert close_to_jax(run, ref_losses, jax_state_dict(jcfg, ref_state), sd0)
    for r in range(1, W):  # every rank takes the same step
        assert got[r][kind]["loss"] == run["loss"]
        assert all(torch.equal(got[r][kind]["sd"][k], run["sd"][k]) for k in sd0)
    if kind == "zero1":
        assert run["loss"] == plain["loss"]
        assert all(torch.equal(run["sd"][k], v) for k, v in plain["sd"].items())
        return
    np.testing.assert_allclose(run["loss"], plain["loss"], rtol=1e-12)
    for k, v in plain["sd"].items():
        np.testing.assert_allclose(run["sd"][k].numpy(), v.numpy(), rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    from editor_tpu_torch.models.editor import Editor
    from editor_tpu_torch.parallel.fsdp import param_memory_bytes
    held = param_memory_bytes(Editor(launch["inp"]["ecfg"], device="meta").to(torch.float64),
                              True, 2)
    assert all(got[r]["fsdp"]["param_bytes"] == [held] * 2 for r in range(W))
