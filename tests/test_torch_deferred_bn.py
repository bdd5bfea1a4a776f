"""The port's DeferredBN (``editor_tpu_torch/parallel/deferred_bn.py``)
against the JAX package's, on the CPU at float64. Tolerance 1e-12
(absolute, on values of order 1).

* Chunk by chunk (channel-last [mb, H, W, C]): each microbatch's output,
  the gradients of sum(y * g) with respect to x, gamma and beta, and the
  committed running statistics, with the EMA (momentum 0.1) and the
  cumulative average (None); a chunk with ``valid`` False adds nothing.
* Inside a pipeline stage (two gloo stages, ``tests/torch_dp.py`` scenario
  ``pipeline_bn``; JAX's ``pipeline_apply`` with ``stage_state`` on two
  virtual devices): the output, each stage's accumulator and its commit.
* A commit of an empty accumulator: JAX writes NaN (it divides by the zero
  count); the port leaves the statistics and ``num_batches_tracked`` as
  they were.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from editor_tpu.parallel import deferred_bn as jbn
from editor_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from editor_tpu_torch.parallel import deferred_bn as bn
from tests.torch_dp import finish, start_ranks
from tests.torch_parity import x64  # noqa: F401

TOL = 1e-12
C_FEAT = 5


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL)


def _params(lib, dtype):
    p = lib.bn_params_init(C_FEAT, dtype)
    gamma, beta = np.array([1.0, 2.0, 0.5, 1.5, 3.0]), np.array([0.1, -0.2, 0.3, 0.0, -0.1])
    conv = torch.from_numpy if lib is bn else jnp.asarray
    return dict(p, gamma=conv(gamma), beta=conv(beta))


@pytest.mark.parametrize("momentum", [0.1, None])
def test_deferred_bn_matches_jax(x64, momentum):
    rng = np.random.RandomState(9)
    chunks = [rng.randn(3, 2, 3, C_FEAT) * 2 + 1 for _ in range(4)]
    gs = [rng.randn(3, 2, 3, C_FEAT) for _ in range(4)]
    valid = [True, True, False, True]
    jp, tp = _params(jbn, jnp.float64), _params(bn, torch.float64)
    jacc, tacc = jbn.bn_acc_init(C_FEAT, jnp.float64), bn.bn_acc_init(C_FEAT, torch.float64)
    for c, g, v in zip(chunks, gs, valid):
        def f(x, gamma, beta, acc):
            y, acc = jbn.deferred_bn_apply(dict(jp, gamma=gamma, beta=beta), x, acc, v)
            return jnp.sum(y * g), (y, acc)

        (_, (y, jacc)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(c), jp["gamma"], jp["beta"], jacc)
        leaves = [torch.from_numpy(c).requires_grad_(True),
                  tp["gamma"].clone().requires_grad_(True), tp["beta"].clone().requires_grad_(True)]
        ty, tacc = bn.deferred_bn_apply(dict(tp, gamma=leaves[1], beta=leaves[2]), leaves[0],
                                        tacc, v)
        (ty * torch.from_numpy(g)).sum().backward()
        _close(ty.detach(), y)
        for t, j in zip(leaves, grads):
            _close(t.grad, j)
        assert not any(a.requires_grad for a in tacc.values())
    for k in ("sum", "sum_squares", "count"):
        _close(tacc[k], jacc[k])
    assert float(tacc["count"]) == 3 * 18  # the invalid chunk is not counted
    jp = jbn.deferred_bn_commit(jp, jacc, momentum=momentum)
    tp = bn.deferred_bn_commit(tp, tacc, momentum=momentum)
    for k in ("running_mean", "running_var"):
        _close(tp[k], jp[k])
    assert int(tp["num_batches_tracked"]) == int(jp["num_batches_tracked"]) == 1


def test_deferred_bn_inside_pipeline_stage_matches_jax(x64, tmp_path):
    rng = np.random.RandomState(10)
    S, D, B, M = 2, 6, 12, 4
    w, x = rng.randn(S, D, D) * 0.4, rng.randn(B, D) * 3 + 2
    launch = start_ranks("pipeline_bn", S, tmp_path, {"w": w, "x": x, "M": M})
    p = jbn.bn_params_init(D, jnp.float64)
    stacked = jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (S,) + l.shape), p)
    acc0 = jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (S,) + l.shape),
                                  jbn.bn_acc_init(D, jnp.float64))

    def stage_fn(params, h, acc, valid):
        wl, bnp = params
        h, acc = jbn.deferred_bn_apply(bnp, h, acc, valid)
        return jnp.tanh(h @ wl), acc

    mesh = Mesh(np.asarray(jax.devices()[:S]), ("stage",))
    y, accs = jax.jit(lambda w, x: jax_pipeline_apply(stage_fn, (w, stacked), x, mesh, M,
                                                      stage_state=acc0))(jnp.asarray(w),
                                                                         jnp.asarray(x))
    got = finish(launch)
    for s, out in enumerate(got):
        _close(out["y"], y)
        acc = jax.tree_util.tree_map(lambda l: l[s], accs)
        for k in ("sum", "sum_squares", "count"):
            _close(out["acc"][k], acc[k])
        committed = jbn.deferred_bn_commit(p, acc)
        for k in ("running_mean", "running_var"):
            _close(out["committed"][k], committed[k])
    # stage 0's statistics are the whole mini-batch's moments of x
    _close(got[0]["committed"]["running_mean"], 0.1 * x.mean(axis=0))
    _close(got[0]["committed"]["running_var"], 0.9 + 0.1 * x.var(axis=0))


@pytest.mark.parametrize("momentum", [0.1, None])
def test_deferred_bn_commit_of_an_empty_accumulator(x64, momentum):
    jp = jbn.deferred_bn_commit(jbn.bn_params_init(C_FEAT, jnp.float64),
                                jbn.bn_acc_init(C_FEAT, jnp.float64), momentum=momentum)
    assert np.isnan(np.asarray(jp["running_mean"])).all()  # JAX divides by the zero count
    p = _params(bn, torch.float64)
    p["running_mean"] = torch.arange(C_FEAT, dtype=torch.float64)
    out = bn.deferred_bn_commit(p, bn.bn_acc_init(C_FEAT, torch.float64), momentum=momentum)
    for k, v in p.items():
        assert torch.equal(out[k], v), k
    x = torch.randn(4, C_FEAT, dtype=torch.float64)
    _, acc = bn.deferred_bn_apply(p, x, bn.bn_acc_init(C_FEAT, torch.float64), False)
    assert torch.equal(bn.deferred_bn_commit(p, acc, momentum)["running_var"],
                       p["running_var"])
