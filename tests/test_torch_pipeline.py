"""The port's GPipe schedule (``editor_tpu_torch/parallel/pipeline.py``)
against the JAX package's, on the CPU at float64: the port's stages are gloo
processes (``tests/torch_dp.py``, scenario ``pipeline_toy``), JAX runs
``pipeline_apply`` over a 'stage' mesh of the conftest's virtual CPU
devices. Tolerance 1e-12 (absolute, on values of order 1) for outputs and
gradients.

* ``pipeline_apply`` on the toy stage tanh(h @ w + b) at S = 2 and 4, with
  M = 4 and with M = 2 under remat: the output and the gradients of
  mean(out^2) with respect to each stage's w and b and to x; a stage runs
  M times, and under remat M more with ``is_recomputing()`` True.
* ``pipeline_train_step`` (remat, M = 4): the loss and each stage's
  gradients.
* The stateful form: the output equals JAX's, and each stage's state counts
  the M real microbatches as valid; the port's schedule runs no bubble, so
  it makes M calls where JAX's makes M + S - 1.
* Skips (S = 4): stage 0 stashes its output and stage 3 pops it and adds
  (``tests/test_pipeline_skip_bn.py``'s long residual): output and
  gradients; the slot errors as JAX's.
* ``balance_stages`` equal to JAX's; ``profile_layer_costs`` times each
  layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh

from editor_tpu.parallel import pipeline as jax_pp
from editor_tpu_torch.parallel import pipeline as pp
from tests.torch_dp import finish, start_ranks
from tests.torch_parity import x64  # noqa: F401

TOL = 1e-12
D, B = 6, 12
CASES = [{"M": 4, "remat": False}, {"M": 2, "remat": True}]


def _inputs(S):
    rng = np.random.RandomState(3 + S)
    return {"w": rng.randn(S, D, D) * 0.4, "b": rng.randn(S, D) * 0.1,
            "x": rng.randn(B, D), "cases": CASES}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(S)``: the ranks' outputs of the launch with S stages; both
    launches start together, and each test computes its JAX oracle before
    it waits for them."""
    launches = {S: start_ranks("pipeline_toy", S, tmp_path_factory.mktemp(f"pp{S}"),
                               _inputs(S)) for S in (2, 4)}
    done = {}

    def get(S):
        if S not in done:
            done[S] = finish(launches[S], timeout=120)
        return done[S]

    return get


def _mesh(S):
    return Mesh(np.asarray(jax.devices()[:S]), ("stage",))


def _jax_stage(params, h):
    w, b = params
    return jnp.tanh(h @ w + b)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("case", range(len(CASES)), ids=["M4", "M2-remat"])
def test_pipeline_apply_matches_jax(x64, ranks, S, case):
    inp = _inputs(S)
    w, b, x = (jnp.asarray(inp[k]) for k in ("w", "b", "x"))
    M, remat = CASES[case]["M"], CASES[case]["remat"]

    def loss(w, b, x):
        y = jax_pp.pipeline_apply(_jax_stage, (w, b), x, _mesh(S), M, remat=remat)
        return jnp.mean(y ** 2), y

    (_, y), (gw, gb, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                      has_aux=True))(w, b, x)
    for s, out in enumerate(ranks(S)):
        got = out["cases"][case]
        _close(got["y"], y)  # every stage holds the result
        _close(got["gw"], gw[s])
        _close(got["gb"], gb[s])
    _close(ranks(S)[0]["cases"][case]["gx"], gx)
    assert all(out["cases"][case]["gx"] is None for out in ranks(S)[1:])
    # M calls forward, and under remat M more in the backward, recomputing
    for out in ranks(S):
        assert out["cases"][case]["recomputing"] == [False] * M + [True] * (M if remat else 0)


@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_train_step_matches_jax(x64, ranks, S):
    inp = _inputs(S)
    step = jax_pp.pipeline_train_step(_jax_stage, lambda y: jnp.mean(y ** 2), _mesh(S), 4)
    loss, (gw, gb) = step((jnp.asarray(inp["w"]), jnp.asarray(inp["b"])),
                          jnp.asarray(inp["x"]))
    for s, out in enumerate(ranks(S)):
        np.testing.assert_allclose(out["train"]["loss"], float(loss), rtol=TOL)
        _close(out["train"]["gw"], gw[s])
        _close(out["train"]["gb"], gb[s])


@pytest.mark.parametrize("S", [2, 4])
def test_stage_state_counts_real_microbatches(x64, ranks, S):
    inp = _inputs(S)
    M = 3

    def counting(params, h, st, valid):
        return _jax_stage(params, h), {"ticks": st["ticks"] + 1,
                                       "valid": st["valid"] + jnp.asarray(valid, jnp.int32)}

    state = {"ticks": jnp.zeros((S,), jnp.int32), "valid": jnp.zeros((S,), jnp.int32)}
    y, st = jax.jit(lambda w, b, x: jax_pp.pipeline_apply(counting, (w, b), x, _mesh(S), M,
                                                          stage_state=state))(
        jnp.asarray(inp["w"]), jnp.asarray(inp["b"]), jnp.asarray(inp["x"]))
    assert list(np.asarray(st["valid"])) == [M] * S
    assert list(np.asarray(st["ticks"])) == [M + S - 1] * S  # JAX computes the bubbles
    for out in ranks(S):
        _close(out["state"]["y"], y)
        assert out["state"]["valid"] == M and out["state"]["ticks"] == M


def test_skip_long_residual_matches_jax(x64, ranks):
    S = 4
    inp = _inputs(S)
    w, x = jnp.asarray(inp["w"]), jnp.asarray(inp["x"])

    def stage_fn(wl, xs):
        h, skips = xs
        out = jnp.tanh(h @ wl)
        s = lax.axis_index("stage")
        skips = jax_pp.stash(skips, "s0to3", jnp.where(s == 0, out, skips["s0to3"]))
        val, popped = jax_pp.pop(skips, "s0to3")
        use = s == S - 1
        out = jnp.where(use, out + val, out)
        skips = jax.tree_util.tree_map(lambda a, b: jnp.where(use, a, b), popped, skips)
        return out, skips

    def loss(w):
        xs = (x, jax_pp.init_skips(B, {"s0to3": jnp.zeros((D,), x.dtype)}))
        y, _ = jax_pp.pipeline_apply(stage_fn, w, xs, _mesh(S), 4)
        return jnp.mean(y ** 2), y

    (_, y), gw = jax.jit(jax.value_and_grad(loss, has_aux=True))(w)
    for s, out in enumerate(ranks(S)):
        _close(out["skip"]["y"], y)
        _close(out["skip"]["gw"], gw[s])


def test_skip_slot_errors():
    skips = pp.init_skips(4, {"a": torch.zeros(3)})
    assert skips["a"].shape == (4, 3)
    with pytest.raises(KeyError):
        pp.stash(skips, "missing", torch.zeros(4, 3))
    with pytest.raises(ValueError):
        pp.stash(skips, "a", torch.zeros(4, 5))
    with pytest.raises(KeyError):
        pp.pop(skips, "missing")
    val, out = pp.pop(pp.stash(skips, "a", torch.ones(4, 3)), "a")
    assert float(val.sum()) == 12.0 and float(out["a"].sum()) == 0.0


def test_activations_are_checked_before_any_call():
    with pytest.raises(ValueError, match="not divisible"):
        pp.pipeline_apply(lambda p, h: h, (), torch.zeros(6, 2), None, 4)
    with pytest.raises(ValueError, match="same batch dim"):
        pp.pipeline_apply(lambda p, h: h, (), (torch.zeros(6, 2), torch.zeros(4)), None, 2)


@pytest.mark.parametrize("costs,S", [([1, 1, 1, 1], 2), ([4, 1, 1, 1, 1], 2),
                                     ([1, 2, 3, 4, 5, 6], 3), ([3, 1, 4, 1, 5, 9, 2, 6], 4),
                                     ([2.5, 0.5, 0.5, 3.0, 1.0], 5)])
def test_balance_stages_matches_jax(costs, S):
    assert pp.balance_stages(costs, S) == jax_pp.balance_stages(costs, S)
    with pytest.raises(ValueError):
        pp.balance_stages(costs, len(costs) + 1)


def test_profile_layer_costs_times_each_layer():
    layers = [torch.nn.Linear(16, 16).double() for _ in range(3)]
    costs = pp.profile_layer_costs(layers, torch.randn(4, 16, dtype=torch.float64), iters=2)
    assert len(costs) == 3 and all(c > 0 for c in costs)
