"""One process of the RPC scenario of ``tests/test_torch_rpc_sharded.py``,
run as

    python tests/torch_rpc_worker.py <package> <role> <port> <dir>

``<package>`` is ``editor_tpu_torch`` (the port, on torch.distributed.rpc)
or ``editor_tpu`` (the JAX package's TCP implementation); ``<role>`` is
``master`` (rank 0: runs the scenario of ``tests/test_rpc_sharded.py`` and
writes ``<dir>/<package>.json``) or ``worker1`` (rank 1: serves until the
master writes ``<dir>/<package>.done``). Every function sent is defined here
at module level, which both packages can send: the port sends functions by
reference, JAX's by value.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

W = np.arange(6, dtype=np.float32).reshape(2, 3)


def _square(x):
    return x * x


def _make_counter():
    return 0


def _add(v, inc):
    return v + inc


def _init_weight():
    return W


def _linear(params, x):
    return x @ params


def _decay(p, lr):
    return p * (1 - lr)


def _boom(x):
    raise ValueError(f"boom {x}")


def master(rpc, port: int) -> dict:
    out = {}
    t0 = time.time()
    rpc.init_rpc("master", rank=0, world_size=2, master_port=port, timeout=120.0)
    out["init_s"] = time.time() - t0
    out["sync"] = rpc.rpc_sync("worker1", _square, (7,))
    out["async"] = rpc.rpc_async("worker1", _square, (9,)).result(timeout=30)
    out["by_rank"] = rpc.rpc_sync(1, _square, (3,))
    rref = rpc.remote("worker1", _make_counter)
    rref.rpc_sync_method(_add, 5)
    rref.rpc_sync_method(_add, 2)
    out["rref"] = rref.to_here()
    module = rpc.RemoteModule("worker1", init_fn=_init_weight, apply_fn=_linear)
    out["module"] = np.asarray(module(np.ones((1, 2), np.float32))).tolist()
    rpc.DistributedOptimizer(_decay, [module.params_rref]).step(0.5)
    out["decayed"] = np.asarray(module.params_rref.to_here()).tolist()
    try:
        rpc.rpc_sync("worker1", _boom, (3,))
        out["remote_error"] = None
    except RuntimeError as e:
        out["remote_error"] = str(e)
    rpc.enable_fault_injection(messages_to_fail=("call",), num_fail_sends=2)
    dropped = 0
    for _ in range(2):
        try:
            rpc.rpc_sync("worker1", _square, (4,))
        except rpc.FaultyRPCError:
            dropped += 1
    out["dropped_calls"] = dropped
    out["after_drops"] = rpc.rpc_sync("worker1", _square, (4,))
    rpc.enable_fault_injection(messages_to_fail=("fetch",), num_fail_sends=2)
    out["fetch_through_drops"] = rref.to_here()
    rpc.disable_fault_injection()
    rpc.enable_fault_injection(messages_to_fail=(), messages_to_delay={"call": 0.3})
    t = time.time()
    rpc.rpc_sync("worker1", _square, (2,))
    out["delayed_s"] = time.time() - t
    rpc.disable_fault_injection()
    with rpc.server_process_global_profile() as prof:
        rpc.rpc_sync("master", _square, (5,))
        rpc.rpc_sync("master", _square, (6,))
    stats = prof.key_averages()
    out["profile"] = {"count": stats["_square"]["count"],
                      "keys": sorted(stats["_square"]),
                      "event_keys": sorted(prof.events()[0]),
                      "events": len(prof.events())}
    t = time.perf_counter()
    for _ in range(20):
        rpc.rpc_sync("worker1", _square, (2,))
    out["rtt_ms"] = (time.perf_counter() - t) / 20 * 1e3
    return out


def main():
    package, role, port, d = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
    if package == "editor_tpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
    rpc = importlib.import_module(f"{package}.parallel.rpc")
    done = os.path.join(d, f"{package}.done")
    if role == "worker1":
        rpc.init_rpc("worker1", rank=1, world_size=2, master_port=port, timeout=120.0)
        deadline = time.time() + 120
        while not os.path.exists(done) and time.time() < deadline:
            time.sleep(0.05)
        rpc.shutdown()
        return
    try:
        out = master(rpc, port)
    finally:
        open(done, "w").close()
    rpc.shutdown()
    with open(os.path.join(d, f"{package}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
