"""The port's ``parallel/rpc.py`` and ``parallel/sharded_tensor.py`` against
the JAX package's.

* RPC: the scenario of ``tests/test_rpc_sharded.py`` (sync and async
  calls, rank addressing, an RRef mutated on its owner, a RemoteModule and
  a DistributedOptimizer step, fault injection with its counters, a delayed
  call, the server-global profile) and a failing remote call, run through
  both packages by ``tests/torch_rpc_worker.py`` (a master and a worker
  process each, the two packages side by side) with module-level functions:
  every value equal, the remote error's message equal. A lambda or a
  closure is refused by the port with a ``TypeError`` that says why, before
  anything is sent (the one API difference: JAX's pickles closures).
* Sharded tensors: one launch of 4 gloo ranks (``tests/torch_dp_worker.py``
  scenario ``sharded``) against JAX's 4-device meshes (('data',) x 4 and
  data 2 x model 2): ``sharded_zeros``, ``sharded_ones``, ``sharded_full``
  and ``from_enumerable`` give JAX's shard metadata (offsets, sizes, device
  index = rank) and values exactly; each rank's block is its chunk;
  ``sharded_rand`` gathers to the same tensor at 4 and 2 data ranks and at
  one (the seeded CPU generator's draw, bit for bit); ``validate`` raises
  JAX's errors. ``utils.debug.monitored_barrier`` under gloo returns its
  seconds, and with a rank late past the deadline raises ``TimeoutError``.
"""

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_dp import child_env, finish, start_ranks, wait_all

HERE = os.path.dirname(os.path.abspath(__file__))
RAND_SHAPE, SEED = (32, 6), 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_rpc(package: str, d: str):
    port = _free_port()
    procs = []
    for role in ("worker1", "master"):
        log = open(os.path.join(d, f"{package}_{role}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_rpc_worker.py"), package, role,
             str(port), d], stdout=log, stderr=subprocess.STDOUT, env=child_env(),
            cwd=os.path.dirname(HERE)))
    return procs


def _rpc_result(package: str, d: str, procs) -> dict:
    codes = wait_all(procs, 150.0)
    if any(codes):
        logs = "".join(open(os.path.join(d, f"{package}_{r}.log")).read()[-2000:]
                       for r in ("worker1", "master"))
        raise AssertionError(f"{package} rpc scenario exited {codes}:\n{logs}")
    with open(os.path.join(d, f"{package}.json")) as f:
        return json.load(f)


def test_rpc_scenario_equals_jax(tmp_path):
    d = str(tmp_path)
    port_procs, jax_procs = _start_rpc("editor_tpu_torch", d), _start_rpc("editor_tpu", d)
    got = _rpc_result("editor_tpu_torch", d, port_procs)
    ref = _rpc_result("editor_tpu", d, jax_procs)
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert got["sync"] == ref["sync"] == 49 and got["async"] == ref["async"] == 81
    assert got["by_rank"] == ref["by_rank"] == 9
    assert got["rref"] == ref["rref"] == 7
    assert got["module"] == ref["module"] == w.sum(0, keepdims=True).tolist()
    assert got["decayed"] == ref["decayed"] == (w * 0.5).tolist()
    assert got["remote_error"] == ref["remote_error"] == "remote raised: ValueError('boom 3')"
    assert got["dropped_calls"] == ref["dropped_calls"] == 2
    assert got["after_drops"] == ref["after_drops"] == 16
    assert got["fetch_through_drops"] == ref["fetch_through_drops"] == 7
    assert got["delayed_s"] >= 0.3 and ref["delayed_s"] >= 0.3
    assert got["profile"] == ref["profile"]
    assert got["profile"]["count"] == 2 and got["profile"]["events"] == 2


def _closure_maker():
    k = 2

    def times_k(x):
        return x * k

    return times_k


@pytest.mark.parametrize("bad", [lambda x: x, _closure_maker(),
                                 functools.partial(lambda x, y: x, 1)],
                         ids=["lambda", "closure", "partial_of_lambda"])
def test_rpc_refuses_lambdas_and_closures_before_sending(bad):
    """No group is needed: the check runs before anything is sent."""
    from editor_tpu_torch.parallel import rpc

    for call in (lambda: rpc.rpc_sync("worker1", bad, (1,)),
                 lambda: rpc.rpc_async("worker1", bad, (1,)),
                 lambda: rpc.remote("worker1", bad),
                 lambda: rpc.RRef("worker1", "k").rpc_sync_method(bad, 1),
                 lambda: rpc.DistributedOptimizer(bad, [])):
        with pytest.raises(TypeError, match="lambda or a closure.*by reference"):
            call()
    with pytest.raises(TypeError, match="lambda or a closure"):
        rpc.RemoteModule("worker1", init_fn=np.zeros, apply_fn=bad)


def _jax_sharded():
    """JAX's factories on its 4-device meshes: {mesh: {case: (metadata sorted
    by device, the global array)}}."""
    from editor_tpu.parallel import make_mesh
    from editor_tpu.parallel import sharded_tensor as J

    import jax
    out = {}
    for name, (data, model) in (("data", (4, 1)), ("data_model", (2, 2))):
        mesh = make_mesh(data=data, model=model, devices=jax.devices()[:4])
        spec0, spec1 = J.ChunkShardingSpec(dim=0), J.ChunkShardingSpec(dim=1)
        shards = tuple(J.ShardMetadata((i * 16, 0), (16, 4), i) for i in range(4))
        arrs = {"zeros": J.sharded_zeros(spec0, (64, 16), mesh),
                "ones": J.sharded_ones(spec1, (4, 32), mesh),
                "full": J.sharded_full(spec0, (8, 6), 2.5, mesh),
                "enumerable": J.from_enumerable(
                    J.EnumerableShardingSpec(shards), (64, 4),
                    lambda m: np.full(m.shard_sizes, m.shard_offsets[0], np.float32), mesh)}
        out[name] = {k: (sorted((dataclasses.astuple(m) for m in J.shard_metadata_of(a)),
                                key=lambda t: t[2]), np.asarray(a))
                     for k, a in arrs.items()}
    return out


def test_sharded_tensors_equal_jax_on_four_ranks(tmp_path):
    launch = start_ranks("sharded", 4, tmp_path, {"rand_shape": RAND_SHAPE, "seed": SEED,
                                                 "late_s": 3.0, "deadline_s": 1.0})
    ref = _jax_sharded()
    outs = finish(launch, timeout=120.0)
    want_rand = torch.rand(RAND_SHAPE, generator=torch.Generator().manual_seed(SEED))
    for name, jax_cases in ref.items():
        for case, (meta, value) in jax_cases.items():
            got = outs[0][name][case]
            assert [tuple(map(lambda v: tuple(v) if isinstance(v, tuple) else v, m))
                    for m in got["meta"]] == meta, (name, case)
            assert np.array_equal(got["full"].numpy(), value), (name, case)
            for r, o in enumerate(outs):
                offsets, sizes, _ = o[name][case]["meta"][r]
                block = o[name][case]["full"].numpy()[
                    tuple(slice(a, a + s) for a, s in zip(offsets, sizes))]
                assert np.array_equal(o[name][case]["local"].numpy(), block), (name, case, r)
        for o in outs:  # the same whole at 4 and 2 data ranks, and at one
            assert torch.equal(o[name]["rand"]["full"], want_rand), name
    for o in outs:
        assert 0.0 <= o["barrier_s"] < 30.0
        assert o["late"] is not None and o["late"].startswith("late")


def test_enumerable_spec_errors_equal_jax():
    from editor_tpu.parallel import sharded_tensor as J

    from editor_tpu_torch.parallel import sharded_tensor as ST

    cases = [((ST.ShardMetadata((0,), (4,), 0),), (4, 4)),
             ((ST.ShardMetadata((0, 0), (8, 4), 0),), (4, 4)),
             ((ST.ShardMetadata((0, 0), (2, 4), 0),), (4, 4))]
    for shards, shape in cases:
        jshards = tuple(J.ShardMetadata(*dataclasses.astuple(s)) for s in shards)
        with pytest.raises(ValueError) as want:
            J.EnumerableShardingSpec(jshards).validate(shape)
        with pytest.raises(ValueError) as got:
            ST.EnumerableShardingSpec(shards).validate(shape)
        assert str(got.value) == str(want.value)
    two_dims = ST.EnumerableShardingSpec(tuple(
        ST.ShardMetadata((i // 2 * 2, i % 2 * 2), (2, 2), i) for i in range(4)))
    with pytest.raises(ValueError, match="only single-dim"):
        ST.from_enumerable(two_dims, (4, 4), lambda m: np.zeros(m.shard_sizes), None)
