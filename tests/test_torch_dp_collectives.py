"""The port's collectives and gradient reducers (``editor_tpu_torch.parallel``)
against the JAX package's, on the CPU: the port's ranks are gloo processes
(``tests/torch_dp.py``), JAX runs ``shard_map`` over the first W of the
conftest's 8 virtual CPU devices, both on the same numpy inputs.

* The twelve collectives at W = 2 and 4 in float64: every value, and for the
  differentiable ones the gradient of sum(y * w) (JAX's ``jax.grad`` through
  ``shard_map`` with ``check_vma=False``, as ``parallel/ddp.py`` runs it,
  every case in one compile; the port's per-rank backward), within rtol 1e-12 (the sums may run in
  another order at W = 4).
* The reducers at W = 2 on ``tests/test_parallel.py``'s gradients: the mean,
  fp16 and bf16 equal to JAX's element for element; int8 equal, and its
  per-rank scale and dequantised values equal to JAX's formula and to the
  JAX reducer's on one device; PowerSGD over two rounds from JAX's initial Q
  (rank 4): output, Q and each rank's error feedback within 1e-5 of the
  leaf's largest value (fp32 products in another order);
  ``_orthogonalize`` within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from editor_tpu.parallel import collectives as JC
from editor_tpu.parallel.compression import _orthogonalize as jax_orthogonalize
from editor_tpu.parallel.compression import make_reducer as jax_make_reducer
from editor_tpu.parallel.compression import powersgd_reducer as jax_powersgd
from editor_tpu.parallel.mesh import make_mesh as jax_make_mesh
from editor_tpu_torch.parallel.compression import _compressible, _orthogonalize, int8_quantize
from tests.torch_dp import finish, start_ranks
from tests.torch_parity import x64  # noqa: F401


def _mesh(W):
    return jax_make_mesh(data=W, model=1, devices=jax.devices()[:W])


def _smap(fn, mesh, n_in=1):
    return shard_map(fn, mesh=mesh, in_specs=(P("data"),) * n_in, out_specs=P("data"),
                     check_vma=False)


def _cases(W, rng):
    """name -> (port function, keyword arguments, per-rank input shape, JAX
    body, differentiable)."""
    pairs = [(0, 1)] if W == 2 else [(0, 2), (3, 1), (1, 0)]
    return {
        "all_reduce_sum": ("all_reduce", {}, (2, 4), lambda v: JC.all_reduce(v, "data"), True),
        "all_reduce_mean": ("all_reduce", {"op": "mean"}, (2, 4),
                            lambda v: JC.all_reduce(v, "data", "mean"), True),
        "all_reduce_max": ("all_reduce", {"op": "max"}, (2, 4),
                           lambda v: JC.all_reduce(v, "data", "max"), False),
        "all_reduce_min": ("all_reduce", {"op": "min"}, (2, 4),
                           lambda v: JC.all_reduce(v, "data", "min"), False),
        "all_gather": ("all_gather", {}, (2, 4), lambda v: JC.all_gather(v, "data"), True),
        "all_gather_axis1": ("all_gather", {"axis": 1}, (2, 4),
                             lambda v: JC.all_gather(v, "data", axis=1), True),
        "all_gather_stacked": ("all_gather", {"tiled": False}, (2, 4),
                               lambda v: JC.all_gather(v, "data", tiled=False), True),
        "reduce_scatter": ("reduce_scatter", {}, (2 * W, 4),
                           lambda v: JC.reduce_scatter(v, "data"), True),
        "reduce_scatter_axis1": ("reduce_scatter", {"axis": 1}, (2, 4 * W),
                                 lambda v: JC.reduce_scatter(v, "data", axis=1), True),
        "all_to_all": ("all_to_all", {}, (2 * W, 3), lambda v: JC.all_to_all(v, "data"), True),
        "all_to_all_0_1": ("all_to_all", {"split_axis": 0, "concat_axis": 1}, (2 * W, 3),
                           lambda v: JC.all_to_all(v, "data", split_axis=0, concat_axis=1),
                           True),
        "broadcast": ("broadcast", {"root": 1}, (2, 4),
                      lambda v: JC.broadcast(v, "data", root=1), True),
        "ppermute_shift": ("ppermute_shift", {"shift": 1}, (2, 4),
                           lambda v: JC.ppermute_shift(v, "data", 1), True),
        "reduce": ("reduce", {"root": 0}, (2, 4), lambda v: JC.reduce(v, "data", root=0), True),
        "gather": ("gather", {"root": 1}, (2, 4), lambda v: JC.gather(v, "data", root=1), True),
        "scatter": ("scatter", {"root": 0}, (2 * W, 4),
                    lambda v: JC.scatter(v, "data", root=0), True),
        "send_recv": ("send_recv", {"pairs": pairs}, (2, 4),
                      lambda v: JC.send_recv(v, "data", pairs=pairs), True),
    }


def _smap_all(bodies, mesh):
    """One ``shard_map`` of every body, each on its own input."""
    n = len(bodies)
    return shard_map(lambda *vs: tuple(b(v) for b, v in zip(bodies, vs)), mesh=mesh,
                     in_specs=(P("data"),) * n, out_specs=(P("data"),) * n, check_vma=False)


@pytest.mark.parametrize("W", [2, 4])
def test_collectives_match_jax(x64, W, tmp_path):
    rng = np.random.RandomState(W)
    mesh = _mesh(W)
    cases = _cases(W, rng)
    inputs, xs, ws = {}, {}, {}
    for name, (fn, kw, shape, body, grad) in cases.items():
        x = rng.randn(W, *shape)
        xs[name] = jnp.asarray(x.reshape((-1,) + shape[1:]))
        ws[name] = rng.randn(*jax.eval_shape(_smap(body, mesh), xs[name]).shape)
        spec = {"fn": fn, "kw": kw, "x": x, "grad": grad}
        if grad:
            spec["w"] = ws[name].reshape((W, -1) + ws[name].shape[1:])
        inputs[name] = spec
    launch = start_ranks("collectives", W, tmp_path, {"cases": inputs})
    # JAX: every value in one compile, every gradient of sum(y * w) in another
    names = list(cases)
    diff = [n for n in names if cases[n][4]]
    ys = jax.jit(_smap_all([cases[n][3] for n in names], mesh))(*(xs[n] for n in names))
    f_diff = _smap_all([cases[n][3] for n in diff], mesh)
    grads = jax.jit(jax.grad(lambda *v: sum(jnp.sum(y * ws[n]) for n, y in
                                            zip(diff, f_diff(*v))), argnums=tuple(
        range(len(diff)))))(*(xs[n] for n in diff))
    want = {n: {"y": np.asarray(y).reshape((W, -1) + y.shape[1:])} for n, y in zip(names, ys)}
    for n, g in zip(diff, grads):
        want[n]["grad"] = np.asarray(g).reshape(inputs[n]["x"].shape)
    outs = finish(launch)
    for name in cases:
        for key in want[name]:
            got = np.stack([o[name][key].reshape(want[name][key].shape[1:]) for o in outs])
            np.testing.assert_allclose(got, want[name][key], rtol=1e-12, atol=1e-12,
                                       err_msg=f"{name} {key}")
    assert all(o["barrier"] == W for o in outs)


def _reducer_inputs():
    rng = np.random.RandomState(0)  # tests/test_parallel.py::test_reducers_lossless, W = 2
    return {"w": rng.randn(2, 16, 32).astype(np.float32),
            "b": rng.randn(2, 32).astype(np.float32)}


def _jax_reduce(red, grads, state, W):
    """JAX reducer ``red`` on per-device ``grads`` {k: [W, ...]} over W devices:
    (outputs {k: [W, ...]}, new state with each device's own buffers)."""
    mesh = _mesh(W)

    def body(g, s):
        out, s = red.reduce({k: v[0] for k, v in g.items()}, s, "data")
        return {k: v[None] for k, v in out.items()}, s

    spec = {k: P("data") for k in grads}
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, P()), out_specs=(spec, P()),
                          check_vma=False))
    return f({k: jnp.asarray(v) for k, v in grads.items()}, state)


def test_reducers_match_jax(tmp_path):
    grads = _reducer_inputs()
    q_rank = 4
    ps = jax_powersgd(rank=q_rank, min_compression_rate=1.0)
    state0 = ps.init({k: jnp.asarray(v[0]) for k, v in grads.items()})
    ortho = np.random.RandomState(1).randn(10, 4).astype(np.float32)
    launch = start_ranks("reducers", 2, tmp_path, {
        "grads": grads, "powersgd_rank": q_rank,
        "q0": {k[2:-2]: np.asarray(v["q"]) for k, v in state0.items()}, "ortho": ortho})
    jax_out = {}
    for name in ("allreduce", "fp16", "bf16", "int8"):
        red = jax_make_reducer(name)
        jax_out[name], _ = _jax_reduce(red, grads, red.init(None), 2)
    outs = finish(launch)

    for name, out in jax_out.items():
        for k in grads:
            want = np.asarray(out[k])
            for r in range(2):
                np.testing.assert_array_equal(outs[r][name][k], want[r], err_msg=f"{name} {k}")

    # int8 per rank: the scale by JAX's formula, the dequantised values by the
    # JAX reducer on one device (the mean of one rank's own values)
    one = jax_make_reducer("int8")
    for r in range(2):
        own = {k: v[r:r + 1] for k, v in grads.items()}
        deq, _ = _jax_reduce(one, own, (), 1)
        for k, v in grads.items():
            q, scale = outs[r]["int8_local"][k]
            want_scale = np.asarray(jax.jit(lambda g: jnp.max(jnp.abs(g)) / 127.0 + 1e-12)(v[r]))
            np.testing.assert_array_equal(scale, want_scale)
            np.testing.assert_array_equal(q.astype(np.float32) * scale, np.asarray(deq[k])[0])
            tq, ts = int8_quantize(torch.from_numpy(v[r]))  # and the port in this process
            assert np.array_equal(tq.numpy(), q) and float(ts) == float(scale)

    # PowerSGD, two rounds: outputs, Q (the same on both ranks) and each
    # rank's error feedback
    state = state0
    for rnd in range(2):
        out, state = _jax_reduce(ps, grads, state, 2)
        got = outs[0]["powersgd"][rnd]
        for k in grads:
            ref_out = np.asarray(out[k])
            scale = np.abs(ref_out).max()
            for r in range(2):
                np.testing.assert_allclose(outs[r]["powersgd"][rnd]["out"][k], ref_out[r],
                                           rtol=0, atol=1e-5 * scale, err_msg=f"round {rnd} {k}")
            key = f"['{k}']"
            if key not in state:
                continue
            q = np.asarray(state[key]["q"])
            np.testing.assert_allclose(got["state"][k]["q"], q, rtol=0,
                                       atol=1e-5 * np.abs(q).max())
            errs = [np.asarray(s.data) for s in sorted(state[key]["error"].addressable_shards,
                                                      key=lambda s: s.device.id)]
            for r in range(2):
                e = outs[r]["powersgd"][rnd]["state"][k]["error"]
                np.testing.assert_allclose(e, errs[r], rtol=0,
                                           atol=1e-5 * max(np.abs(errs[r]).max(), 1e-6),
                                           err_msg=f"round {rnd} {k} error, rank {r}")
        assert {f"['{k}']" for k in got["state"]} == set(state)

    want = np.asarray(jax_orthogonalize(jnp.asarray(ortho)))
    np.testing.assert_allclose(outs[0]["orthogonalize"], want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(_orthogonalize(torch.from_numpy(ortho)).numpy(), want,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape, rank, rate", [((16, 32), 4, 2.0), ((32,), 4, 1.0),
                                               ((2, 3, 4), 1, 1.5), ((4, 4), 4, 2.0)])
def test_compressible_matches_jax(shape, rank, rate):
    from editor_tpu.parallel.compression import _compressible as jax_compressible
    assert _compressible(shape, rank, rate) == jax_compressible(shape, rank, rate)
