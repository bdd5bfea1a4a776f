"""LocalSGD in the port (``parallel.localsgd``) against the JAX package's
``build_localsgd_train_step``, on the CPU: the port's ranks are gloo
processes (``tests/torch_dp.py``), each its own replica; JAX's replicas are
a stacked axis over the first W of the conftest's 8 virtual CPU devices
(``stack_replicas``).

* The toy update of JAX's ``test_localsgd_periodic_averaging`` (w <- w -
  0.5 (w - target), target rank r's row of ``arange(W)``) at W = 4, period
  2, float64: at step 0 the replicas diverge and ``averaged`` reads 0, at
  step 1 they are equal and it reads 1; each rank's w equals JAX's replica
  r within 1e-15 and the mean-reduced loss JAX's within 1e-6 relative (both
  reduce float32 metrics, as JAX does).
* The tiny EDITOR (``tests/torch_dp_jax.py``: depth 2, width 96, drop path
  0, no augmentation) at W = 2, period 2, float64: each rank's local update
  is the single-device ``build_train_step`` on its 4 rows, JAX's is its
  ``build_train_step`` inside the LocalSGD step. After step 0 (no
  averaging) and step 1 (averaged) each rank's whole state equals JAX's
  replica r at ``test_torch_train_step.py``'s tolerances (each parameter's
  change within 1e-7 of that tensor's largest change or atol 1e-15; BN
  stats rtol 1e-7 / atol 1e-8; OCFR centers rtol 1e-6 / atol 1e-7); the
  parameters differ between the ranks after step 0 and are equal after
  step 1, and the BN stats stay each rank's own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from editor_tpu.engine import build_train_step as jax_build_train_step
from editor_tpu.losses import make_loss as jax_make_loss
from editor_tpu.parallel.localsgd import (build_localsgd_train_step, stack_replicas,
                                          unstack_replica)
from editor_tpu.parallel.mesh import make_mesh as jax_make_mesh
from editor_tpu.parallel.mesh import shard_batch as jax_shard_batch
from editor_tpu.solver import make_scheduler as jax_make_scheduler
from tests.torch_dp import finish, start_ranks
from tests.torch_dp_jax import (close_to_jax, jax_setup, jax_state_dict, make_batch,
                                port_inputs)
from tests.torch_parity import x64  # noqa: F401


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class _S:
    params: jax.Array


def test_localsgd_toy_matches_jax(x64, tmp_path):
    W = 4
    launch = start_ranks("localsgd", W, tmp_path, {"toy": True, "steps": 2})
    mesh = jax_make_mesh(data=W, model=1, devices=jax.devices()[:W])

    def local_update(state, batch, epoch):
        target = jnp.mean(batch)
        w = state.params - 0.5 * (state.params - target)
        return _S(params=w), {"loss": jnp.mean((w - target) ** 2)}

    step = build_localsgd_train_step(local_update, mesh, period=2)
    state = stack_replicas(_S(params=jnp.zeros((), jnp.float64)), W)
    batch = jnp.arange(float(W), dtype=jnp.float64).reshape(W, 1)
    ref = []
    for i in range(2):
        state, m = step(state, batch, jnp.asarray(1), jnp.asarray(i))
        ref.append((np.asarray(state.params), float(m["loss"]), int(m["averaged"])))
    got = finish(launch)
    for i, (w_ref, loss_ref, averaged) in enumerate(ref):
        ws = [got[r][i]["w"] for r in range(W)]
        np.testing.assert_allclose(ws, w_ref, rtol=0, atol=1e-15)
        assert all(got[r][i]["averaged"] == averaged == i for r in range(W))
        np.testing.assert_allclose([got[r][i]["loss"] for r in range(W)], [loss_ref] * W,
                                   rtol=1e-6)
    assert len(set(got[r][0]["w"] for r in range(W))) == W  # diverged
    assert len(set(got[r][1]["w"] for r in range(W))) == 1  # averaged


def test_localsgd_editor_matches_jax(x64, tmp_path):
    W = 2
    jcfg, cfg, opt, state = jax_setup()
    batch = make_batch()
    inp = port_inputs(jcfg, state, batch)
    launch = start_ranks("localsgd", W, tmp_path, inp)
    mesh = jax_make_mesh(data=W, model=1, devices=jax.devices()[:W])
    local = jax_build_train_step(jcfg, opt, jax_make_loss(cfg, 4), jax_make_scheduler(cfg),
                                 cfg.SOLVER.BASE_LR, compute_dtype=jnp.float64, donate=False)
    step = build_localsgd_train_step(local, mesh, period=2)
    reps = stack_replicas(state, W)
    feed = jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = []
    for i in range(2):
        reps, m = step(reps, feed, jnp.asarray(i + 1), jnp.asarray(i))
        ref.append((float(m["loss"]), int(m["averaged"]),
                    [jax_state_dict(jcfg, unstack_replica(reps, r)) for r in range(W)]))
    got = finish(launch)
    sd0 = inp["sd"]
    for i, (loss_ref, averaged, sds) in enumerate(ref):
        for r in range(W):
            assert got[r][i]["averaged"] == averaged == i
            np.testing.assert_allclose(got[r][i]["loss"], loss_ref, rtol=1e-6)
            assert close_to_jax({"loss": [0.0], "sd": got[r][i]["sd"]}, [0.0], sds[r], sd0,
                                what=f"step {i} rank {r}")
    params = [k for k in sd0 if k.startswith("BACKBONE.base.blocks")
              and k.endswith(".weight")]
    same = [all(np.array_equal(got[0][i]["sd"][k].numpy(), got[1][i]["sd"][k].numpy())
                for k in params) for i in range(2)]
    assert same == [False, True]
    bn = "FUSE_BN.running_mean"
    assert not np.array_equal(got[0][1]["sd"][bn].numpy(), got[1][1]["sd"][bn].numpy())
