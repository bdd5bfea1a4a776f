"""The port's local-batch data-parallel step
(``parallel.ddp.build_ddp_train_step``) against the JAX package's
``build_ddp_train_step``, on the CPU at float64 (gloo ranks against JAX on
the first W of the conftest's virtual CPU devices; ``tests/torch_dp_jax.py``,
whose one DDP step compile switches between JAX's five reducers).

* At W = 2 with each reducer (PowerSGD from JAX's initial Q): the
  tolerances of ``test_torch_train_step.py``, but each parameter's change
  within 1e-5 of its largest with PowerSGD (its factors are fp32 products
  in both packages, summed in other orders); both ranks hold the same
  model; PowerSGD compresses the leaves JAX's does.
* On a batch whose hardest negatives for identity 0 are identity 2's, on the
  other rank: the global-batch step and the local-batch step each match
  their own JAX step and fail the other one's.
"""

import numpy as np
import torch

from tests.torch_dp import finish, start_ranks
from tests.torch_dp_jax import (REDUCERS, close_to_jax, jax_ddp, jax_ddp_step, jax_global,
                                jax_setup, jax_state_dict, make_batch, port_inputs)
from tests.torch_parity import to_numpy_tree, x64  # noqa: F401


# Each parameter's change after the second step, relative to its largest
# change: the first step leaves the two packages' OCFR centers one fp32
# rounding apart (both update them in fp32, summing in other orders), which
# moves the second step's gradients by ~1e-9 of their size; a quantising
# reducer then rounds a few elements the other way, one step of its grid:
# 2^-11 of the element with fp16, 2^-8 with bf16, 1/127 of the leaf's
# largest with int8 (measured: 1.3e-5 with fp16)
STEP2_TOL = {"allreduce": 1e-7, "fp16": 5e-4, "bf16": 4e-3, "int8": 8e-3, "powersgd": 1e-5}


def test_ddp_step_matches_jax_for_each_reducer(x64, tmp_path):
    jcfg, cfg, opt, state = jax_setup()
    batch = make_batch()
    comm0 = jax_ddp_step(2)[1].init(state.params)["ps"]  # PowerSGD's initial Q
    inp = port_inputs(jcfg, state, batch)
    runs = [{"kind": "ddp", "reducer": name} for name in REDUCERS]
    runs[-1]["q0"] = {k: np.asarray(v["q"]) for k, v in comm0.items()
                      if "['fc']" not in k}  # the frozen legacy head has no gradient
    launch = start_ranks("train", 2, tmp_path, dict(inp, runs=runs))
    refs = {name: jax_ddp(state, batch, 2, name) for name in REDUCERS}
    got = finish(launch)
    for i, name in enumerate(REDUCERS):
        losses, jstates, _ = refs[name]
        # step 1: every reducer on the same gradients (to ~1e-13) gives JAX's
        # update; PowerSGD's fp32 factors within 1e-5
        step1 = dict(got[0][i], loss=got[0][i]["loss"][:1])
        assert close_to_jax(step1, losses[:1], jax_state_dict(jcfg, jstates[0]), inp["sd"],
                            param_tol=1e-5 if name == "powersgd" else 1e-7, what=name,
                            sd=got[0][i]["sds"][0]), name
        assert close_to_jax(got[0][i], losses, jax_state_dict(jcfg, jstates[1]), inp["sd"],
                            param_tol=STEP2_TOL[name], what=name), name
        assert all(torch.equal(got[1][i]["sd"][k], got[0][i]["sd"][k]) for k in inp["sd"])
    # PowerSGD compressed the leaves JAX's did
    assert set(got[0][-1]["comm"]) == set(runs[-1]["q0"])


def test_cross_shard_negatives_split_the_two_steps(x64, tmp_path):
    """Identity 2 (rank 1) is a near copy of identity 0 (rank 0): the global
    step mines it as identity 0's hardest negative, the local step cannot.
    Each port step matches its own JAX step and fails the other's."""
    from editor_tpu_torch.losses.triplet import euclidean_dist
    from tests.torch_parity import port_editor

    jcfg, cfg, opt, state = jax_setup()
    batch = make_batch(cross_shard=True)
    model = port_editor(jcfg, to_numpy_tree(state.params), to_numpy_tree(state.model_state))
    with torch.no_grad():
        feat = model({m: torch.from_numpy(batch[m]) for m in ("RGB", "NI", "TI")},
                     cam_ids=torch.from_numpy(batch["camid"]))
    d = euclidean_dist(feat, feat)[:2]
    d[:, :2] = float("inf")
    assert set(d.argmin(dim=1).tolist()) <= {4, 5}  # on rank 1

    inp = port_inputs(jcfg, state, batch)
    launch = start_ranks("train", 2, tmp_path, dict(inp, runs=[
        {"kind": "global"}, {"kind": "ddp", "reducer": "allreduce"}]))
    g_losses, g_state = jax_global(state, batch, 2)
    l_losses, l_states, _ = jax_ddp(state, batch, 2, "allreduce")
    l_state = l_states[-1]
    got = finish(launch)
    g_sd, l_sd = jax_state_dict(jcfg, g_state), jax_state_dict(jcfg, l_state)
    assert close_to_jax(got[0][0], g_losses, g_sd, inp["sd"])
    assert close_to_jax(got[0][1], l_losses, l_sd, inp["sd"])
    assert not close_to_jax(got[0][0], l_losses, l_sd, inp["sd"])
    assert not close_to_jax(got[0][1], g_losses, g_sd, inp["sd"])
