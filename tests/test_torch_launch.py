"""The launcher ``cli.launch`` and its host modules in the port
(``parallel.elastic``, ``parallel.rendezvous``, ``parallel.etcd``, the
``multihost`` repairs), on the CPU. Every launch has its own time limit.

* The rendezvous cases of ``tests/test_rendezvous.py`` (all but the slow
  stress test and ``test_cycling_iterator``, a sampler test) on the port's
  modules; the JAX file's per-backend store tests are one parametrised case
  a backend (``test_store_ops``, ``test_store_collectives``).
* The supervisor cases of ``tests/test_ddp_elastic.py``: restart until
  success, the restart budget, the watchdog, a round ended by a membership
  change, a failure reported to the caller; each worker's environment is
  torchrun's, and ``--master_port 0`` takes a new port each incarnation.
* ``multihost``: ``initialize`` takes ``RANK``, else ``NODE_RANK *
  NPROC_PER_NODE + LOCAL_RANK``; ``fail_fast`` writes the error file,
  ``leave_on_error`` none for ``SystemExit`` and Ctrl-C.
* The trainer through the launcher: ``cli.launch --nproc_per_node 2`` runs
  ``cli.train --device cpu`` with ``TPU.ZERO_STAGE 3`` (FSDP) on in-memory
  data; rank 1's data fails as epoch 2 starts, after the epoch-1
  checkpoint is committed; the launcher restarts the group ("restarts
  used: 1"), the error file names the exception, both ranks resume from
  the same step, and the stitched losses equal an uninterrupted
  one-process run's (no random draws; rtol 1e-6, float32).
* Two launchers on the ``file`` backend, one process each: the workers,
  with ``RANK`` unset, join one gloo group as ranks 0 and 1.
* A deliberate ``SystemExit`` of a rank writes no error file.
* The round loop joins its keep-alive thread at every round's end, and
  with the last beat stuck in a store ``set`` past the join's limit it
  says so and does not ``leave()`` the rendezvous.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from editor_tpu_torch.parallel.rendezvous import DynamicRendezvous, TCPStore
from tests.torch_dp import WORKER, child_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port():
    # OS-assigned free port: the old time-derived scheme collided whenever
    # two tests started exactly 60s (mod) apart — a real intermittent flake
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_dynamic_rendezvous_three_nodes_consistent_ranks():
    port = _port()
    server = TCPStore("127.0.0.1", port, is_server=True)
    try:
        results = {}

        def node(i):
            st = TCPStore("127.0.0.1", port)
            rdzv = DynamicRendezvous(st, "run1", min_nodes=3, max_nodes=3,
                                     node_id=f"node{i}")
            results[i] = rdzv.next_rendezvous(timeout=20)

        threads = [threading.Thread(target=node, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert len(results) == 3
        rounds = {r[0] for r in results.values()}
        worlds = {r[2] for r in results.values()}
        ranks = sorted(r[1] for r in results.values())
        assert rounds == {0} and worlds == {3} and ranks == [0, 1, 2]
    finally:
        server.close()


def test_scale_up_waits_then_rejoins_bigger_world():
    """The reference agent's membership-change path
    (agent/server/api.py:872-884): a late node parks in the waiting set;
    the agent observes num_nodes_waiting > 0, restarts the round, and
    everyone (old + new) re-rendezvouses into the larger world."""
    port = _port()
    server = TCPStore("127.0.0.1", port, is_server=True)
    try:
        mk = lambda nid: DynamicRendezvous(
            TCPStore("127.0.0.1", port), "run2", min_nodes=2, max_nodes=4,
            settle_s=1.0, node_id=nid)  # wide settle: parked nodes must
        # reliably rejoin the restarted round even on a loaded CI host
        a, b = mk("a"), mk("b")
        res = {}
        ta = threading.Thread(target=lambda: res.update(a=a.next_rendezvous(90)))
        tb = threading.Thread(target=lambda: res.update(b=b.next_rendezvous(90)))
        ta.start(); tb.start(); ta.join(120); tb.join(120)
        assert res["a"][2] == res["b"][2] == 2

        # late third node parks in the waiting set (wide timeouts: under a
        # fully-loaded suite host the polling threads can starve for tens
        # of seconds — this is a protocol test, not a latency test)
        c = mk("c")
        tc = threading.Thread(target=lambda: res.update(c=c.next_rendezvous(120)))
        tc.start()
        deadline = time.time() + 90
        while a.num_nodes_waiting() == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert a.num_nodes_waiting() >= 1

        # agent reaction: tear down the round; all three re-join
        a.restart_round()
        t2a = threading.Thread(target=lambda: res.update(a2=a.next_rendezvous(120)))
        t2b = threading.Thread(target=lambda: res.update(b2=b.next_rendezvous(120)))
        t2a.start(); t2b.start()
        for t in (t2a, t2b, tc):
            t.join(150)
        assert res["a2"][0] == res["b2"][0] == res["c"][0] == 1  # round bumped
        assert res["a2"][2] == res["b2"][2] == res["c"][2] == 3
        assert sorted([res["a2"][1], res["b2"][1], res["c"][1]]) == [0, 1, 2]
    finally:
        server.close()


def test_monitored_barrier_names_straggler():
    from editor_tpu_torch.parallel.rendezvous import (StragglerError,
                                                monitored_barrier)

    port = _port()
    server = TCPStore("127.0.0.1", port, is_server=True)
    try:
        st = TCPStore("127.0.0.1", port)
        # ranks 0 and 2 arrive; rank 1 never does
        errs = {}

        def go(r):
            try:
                monitored_barrier(st, "b1", r, 3, timeout=1.0)
            except StragglerError as e:
                errs[r] = e.missing

        t0 = threading.Thread(target=go, args=(0,))
        t2 = threading.Thread(target=go, args=(2,))
        t0.start(); t2.start(); t0.join(10); t2.join(10)
        assert errs[0] == [1] and errs[2] == [1]
        # full barrier passes
        done = []
        ts = [threading.Thread(
            target=lambda r=r: (monitored_barrier(st, "b2", r, 3, 10),
                                done.append(r))) for r in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(15)
        assert sorted(done) == [0, 1, 2]
    finally:
        server.close()


def _store(backend, tmp_path):
    """(store, cleanup) of a rendezvous store backend under test."""
    if backend == "c10d":
        port = _port()
        server = TCPStore("127.0.0.1", port, is_server=True)
        return TCPStore("127.0.0.1", port), server.close
    if backend == "file":
        from editor_tpu_torch.parallel.rendezvous import FileStore
        return FileStore(str(tmp_path / "s.json")), lambda: None
    from editor_tpu_torch.parallel.etcd import EtcdServer, EtcdStore
    server = EtcdServer()
    return EtcdStore(server.endpoint), server.stop


@pytest.mark.parametrize("backend", ["c10d", "file", "etcd"])
def test_store_ops(backend, tmp_path):
    """The duck-typed store surface on each backend (JAX's
    test_tcp_store_ops, test_etcd_store_ops and the first half of
    test_file_store_collectives): set/get/add/CAS incl. the expect-None
    create-CAS, delete, wait, wait_ne (reference etcd_store.py:26 over
    etcd_server.py:77 for etcd)."""
    client, cleanup = _store(backend, tmp_path)
    try:
        assert client.get("missing") is None
        client.set("k", {"a": 1})
        assert client.get("k") == {"a": 1}
        assert client.add("n", 2) == 2
        assert client.add("n", 3) == 5
        ok, _ = client.compare_and_swap("k", {"a": 1}, {"a": 2})
        assert ok
        ok, cur = client.compare_and_swap("k", {"a": 1}, {"a": 3})
        assert not ok and cur == {"a": 2}
        # create-CAS: expect-None succeeds only while the key is absent
        ok, _ = client.compare_and_swap("fresh", None, 1)
        assert ok
        ok, cur = client.compare_and_swap("fresh", None, 2)
        assert not ok and cur == 1
        assert client.delete("fresh") and not client.delete("fresh")
        t = threading.Timer(0.2, lambda: client.set("late", 7))
        t.start()
        assert client.wait("late", timeout=5) == 7
        changed, v = client.wait_ne("late", 7, timeout=0.3)
        assert not changed and v == 7
    finally:
        cleanup()


@pytest.mark.parametrize("backend", ["c10d", "file", "etcd"])
def test_store_collectives(backend, tmp_path):
    """Host object collectives on each backend (JAX's
    test_object_collectives, test_file_store_collectives and
    test_etcd_store_collectives): a monitored barrier, an all-gather of
    three ranks' objects and the reference DDP sampler's shared-seed
    broadcast."""
    from editor_tpu_torch.parallel.rendezvous import (all_gather_object, broadcast_object,
                                                      monitored_barrier)
    st, cleanup = _store(backend, tmp_path)
    try:
        results = {}

        def go(r):
            monitored_barrier(st, "b0", r, 3, timeout=10, gen=1)
            results[r] = all_gather_object(st, "g1", r, 3, {"rank": r}, gen=1)

        ts = [threading.Thread(target=go, args=(r,)) for r in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(15)
        assert all(results[r] == [{"rank": 0}, {"rank": 1}, {"rank": 2}]
                   for r in range(3))
        seed = broadcast_object(st, "seed", rank=0, obj=1234, gen=1)
        assert broadcast_object(st, "seed", rank=1, gen=1) == 1234 == seed
    finally:
        cleanup()


# ---------------------------------------------------------------------------
# pluggable backend registry (reference elastic/rendezvous/api.py:33,208)
# ---------------------------------------------------------------------------

def test_registry_rejects_unknown_and_mismatched_backends():
    from editor_tpu_torch.parallel.rendezvous import (RendezvousHandlerRegistry,
                                                RendezvousParameters,
                                                rendezvous_registry)
    import pytest
    with pytest.raises(ValueError, match="not registered"):
        rendezvous_registry.create_handler(
            RendezvousParameters("nope", "", "run"))
    reg = RendezvousHandlerRegistry()
    reg.register("a", lambda p: None)
    with pytest.raises(ValueError, match="already registered"):
        reg.register("a", lambda p: None)


def test_static_backend_returns_fixed_membership():
    from editor_tpu_torch.parallel.rendezvous import (RendezvousParameters,
                                                rendezvous_registry)
    h = rendezvous_registry.create_handler(RendezvousParameters(
        "static", "", "job1", config={"rank": 3, "world_size": 8}))
    store, rank, world = h.next_rendezvous()
    assert (rank, world) == (3, 8)
    assert h.num_nodes_waiting() == 0
    h.set_closed()
    import pytest
    from editor_tpu_torch.parallel.rendezvous import RendezvousClosedError
    with pytest.raises(RendezvousClosedError):
        h.next_rendezvous()


def test_file_backend_dynamic_rendezvous(tmp_path):
    """Three nodes over the FILE backend settle into one round with distinct
    ranks — exercises the same DynamicRendezvous state machine as c10d but
    through the fcntl-locked FileStore."""
    import threading
    from editor_tpu_torch.parallel.rendezvous import (RendezvousParameters,
                                                rendezvous_registry)
    path = str(tmp_path / "rdzv.json")
    results = {}

    def node(i):
        h = rendezvous_registry.create_handler(RendezvousParameters(
            "file", path, "job2", min_nodes=3, max_nodes=3,
            config={"node_id": f"n{i}"}))
        store, rank, world = h.next_rendezvous(timeout=20.0)
        results[i] = (rank, world)

    ts = [threading.Thread(target=node, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert len(results) == 3
    assert sorted(r for r, _ in results.values()) == [0, 1, 2]
    assert all(w == 3 for _, w in results.values())


def _backend_env(backend, tmp_path):
    """(endpoint, cleanup) for a dynamic-rendezvous backend under test."""
    if backend == "c10d":
        port = _port()
        server = TCPStore("127.0.0.1", port, is_server=True)
        return f"127.0.0.1:{port}", server.close
    if backend == "file":
        return str(tmp_path / "rdzv.json"), lambda: None
    from editor_tpu_torch.parallel.etcd import EtcdServer
    server = EtcdServer()
    return server.endpoint, server.stop


@pytest.mark.parametrize("backend", ["c10d", "file", "etcd"])
def test_dynamic_rendezvous_matrix_over_backends(backend, tmp_path):
    """The SAME DynamicRendezvous protocol across every registered dynamic
    backend (store, file and etcd): three nodes
    settle into one round with distinct ranks; a late fourth parks in the
    waiting set; restart_round re-rendezvouses everyone into the larger
    world — the reference's c10d-vs-etcd backend split
    (c10d_rendezvous_backend.py:33 / etcd_rendezvous.py:77)."""
    from editor_tpu_torch.parallel.rendezvous import (RendezvousParameters,
                                                rendezvous_registry)
    endpoint, cleanup = _backend_env(backend, tmp_path)
    try:
        handlers = {}

        def mk(i):
            handlers[i] = rendezvous_registry.create_handler(
                RendezvousParameters(
                    backend, endpoint, "matrix_job", min_nodes=3,
                    max_nodes=4,
                    config={"node_id": f"n{i}", "settle_s": 1.0,
                            "is_server": False} if backend == "c10d"
                    else {"node_id": f"n{i}", "settle_s": 1.0}))
            return handlers[i]

        results = {}

        def node(i):
            h = handlers.get(i) or mk(i)
            _, rank, world = h.next_rendezvous(timeout=90.0)
            results[i] = (rank, world)

        for i in range(3):
            mk(i)
        ts = [threading.Thread(target=node, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        assert sorted(r for r, _ in results.values()) == [0, 1, 2]
        assert all(w == 3 for _, w in results.values())

        # late fourth node parks; the agent observes it and restarts
        mk(3)
        t3 = threading.Thread(target=node, args=(3,))
        t3.start()
        deadline = time.time() + 60
        while handlers[0].num_nodes_waiting() == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert handlers[0].num_nodes_waiting() >= 1
        handlers[0].restart_round()
        results.clear()
        ts = [threading.Thread(target=node, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts + [t3]:
            t.join(150)
        assert len(results) == 4
        assert sorted(r for r, _ in results.values()) == [0, 1, 2, 3]
        assert all(w == 4 for _, w in results.values())
    finally:
        cleanup()


@pytest.mark.parametrize("backend", ["file", "etcd"])
def test_launcher_negotiates_node_ranks_via_file_backend(backend, tmp_path):
    """cli.launch --rdzv_backend file/etcd: two node-level launchers settle
    into node ranks {0,1} through the registry before spawning workers
    (reference torchrun --rdzv_backend, distributed/run.py:383-401 — etcd
    path: etcd_rendezvous.py:77)."""
    import subprocess
    import sys
    import threading

    if backend == "etcd":
        from editor_tpu_torch.parallel.etcd import EtcdServer
        server = EtcdServer()
        rdzv = server.endpoint
    else:
        rdzv = str(tmp_path / "rdzv.json")
    script = str(tmp_path / "worker.py")
    with open(script, "w") as f:
        f.write("import os\n"
                "print('W', os.environ['NODE_RANK'],"
                " os.environ['WORLD_SIZE'],"
                " os.environ['MASTER_ADDR'], flush=True)\n")

    outs = {}

    def node(i):
        outs[i] = subprocess.run(
            [sys.executable, "-m", "editor_tpu_torch.cli.launch",
             "--nproc_per_node", "1", "--nnodes", "2",
             "--node_rank", str(i),  # ignored: negotiated via rendezvous
             "--rdzv_backend", backend, "--rdzv_endpoint", rdzv,
             "--rdzv_id", "t1", "--max_restarts", "0",
             "--error_dir", str(tmp_path / f"err{i}"),
             "--", sys.executable, script],
            capture_output=True, text=True, timeout=120, cwd=REPO)

    ts = [threading.Thread(target=node, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(150)
    assert set(outs) == {0, 1}
    ranks, addrs = set(), set()
    for i, r in outs.items():
        assert r.returncode == 0, (i, r.stdout[-500:], r.stderr[-500:])
        for line in r.stdout.splitlines():
            if line.startswith("W "):
                _, nr, ws, ma = line.split()
                ranks.add(int(nr))
                addrs.add(ma)
                assert ws == "2"
    assert ranks == {0, 1}, (ranks, outs[0].stdout, outs[1].stdout)
    # every node received the SAME coordinator address — the elected rank-0
    # node's hostname published through the store, not the static default
    assert len(addrs) == 1, addrs
    import socket
    # the launcher publishes the FQDN when it is real, else the hostname —
    # never the useless reverse-DNS 'localhost'
    assert addrs <= {socket.getfqdn(), socket.gethostname()}
    assert "localhost" not in addrs
    if backend == "etcd":
        server.stop()


def test_abandoned_complete_round_is_revived_by_new_arrival():
    """A completed round whose every participant's heartbeat has expired
    (whole job died; relaunch reuses the run_id on a persistent store) must
    not strand new arrivals in the waiting set forever — the arriving node
    tears the abandoned round down itself and settles a fresh one."""
    port = _port()
    server = TCPStore("127.0.0.1", port, is_server=True)
    try:
        old = DynamicRendezvous(TCPStore("127.0.0.1", port), "ghost",
                                min_nodes=1, max_nodes=2,
                                keep_alive_interval=0.2,
                                keep_alive_max_attempt=2)
        rnd0, rank0, world0 = old.next_rendezvous(timeout=10)
        assert world0 == 1
        # the old job dies: no more keepalives; its heartbeat expires
        time.sleep(0.5)
        fresh = DynamicRendezvous(TCPStore("127.0.0.1", port), "ghost",
                                  min_nodes=1, max_nodes=2,
                                  keep_alive_interval=0.2,
                                  keep_alive_max_attempt=2)
        rnd1, rank1, world1 = fresh.next_rendezvous(timeout=10)
        assert rnd1 > rnd0
        assert (rank1, world1) == (0, 1)
    finally:
        server.close()


def test_rdzv_conf_is_server_string_coercion():
    """--rdzv_conf values are strings; is_server=0 must mean CLIENT."""
    from editor_tpu_torch.parallel.rendezvous import _as_bool
    assert _as_bool("0") is False and _as_bool("false") is False
    assert _as_bool("1") is True and _as_bool("True") is True
    assert _as_bool(True) is True and _as_bool(False) is False


def test_rdzv_conf_parsing_strips_whitespace():
    """The comma+space form shown in --rdzv_conf's help text must not
    silently drop every entry after the first."""
    from editor_tpu_torch.cli.launch import _parse_rdzv_conf
    conf = _parse_rdzv_conf("settle_s=5, keep_alive_interval=2, is_server=1")
    assert conf == {"settle_s": "5", "keep_alive_interval": "2",
                    "is_server": "1"}
    assert _parse_rdzv_conf(" flag , k = v ") == {"flag": "1", "k": "v"}
    assert _parse_rdzv_conf("") == {}


def test_graceful_leave_is_not_scale_down():
    """A node that finishes SUCCESSFULLY leaves the participant set
    (DynamicRendezvous.leave); a peer still working must not read the
    departed node's expiring heartbeat as a scale-down event and kill its
    own nearly-done workers."""
    port = _port()
    server = TCPStore("127.0.0.1", port, is_server=True)
    try:
        nodes = [DynamicRendezvous(TCPStore("127.0.0.1", port), "bye",
                                   min_nodes=2, max_nodes=2, settle_s=0.05,
                                   keep_alive_interval=0.2,
                                   keep_alive_max_attempt=2)
                 for _ in range(2)]
        import threading
        res = {}
        ts = [threading.Thread(
                  target=lambda i=i: res.update(
                      {i: nodes[i].next_rendezvous(timeout=10)}))
              for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert len(res) == 2
        # node 0 finishes its job and departs gracefully
        nodes[0].leave()
        # well past node 0's heartbeat TTL (0.4s):
        time.sleep(1.0)
        assert nodes[1].num_nodes_dead() == 0
        st = nodes[1].store.get(nodes[1].key)
        assert nodes[1].node_id in st["participants"]
        # an actually-dead peer (no leave) IS still detected: node 1 is
        # still a participant but stopped heartbeating after the join, so
        # its hb is now lapsed well past the TTL (0.4s) — a fresh observer
        # on the same round reports it dead (node 0 left gracefully and is
        # out of the participant set entirely, so it does NOT appear)
        observer = DynamicRendezvous(TCPStore("127.0.0.1", port), "bye",
                                     min_nodes=2, max_nodes=2,
                                     settle_s=0.05,
                                     keep_alive_interval=0.2,
                                     keep_alive_max_attempt=2)
        dead = observer.dead_nodes()
        assert nodes[1].node_id in dead, (dead, nodes[1].node_id)
        assert nodes[0].node_id not in dead, (dead, nodes[0].node_id)
    finally:
        server.close()


def test_launcher_cross_node_round_restart_fast(tmp_path):
    """Deterministic (no-JAX) coverage of the launcher's agent loop: two
    node launchers over the file backend; the worker that wins the lock
    file crashes on incarnation 0. Its agent spends a budget token and
    tears the round down; the peer's worker is a plain sleeper (no
    collective cascade), so the peer MUST take the membership
    'round_restarted' branch. Both re-join and succeed on incarnation 1
    (reference api.py:827-884, both branches)."""
    import subprocess
    import sys
    import threading

    rdzv = str(tmp_path / "rdzv.json")
    lock = str(tmp_path / "crash_owner")
    script = str(tmp_path / "worker.py")
    with open(script, "w") as f:
        f.write(
            "import os, sys, time\n"
            "restart = int(os.environ.get('EDITOR_TPU_RESTART_COUNT', '0'))\n"
            "if restart == 0:\n"
            "    try:\n"
            "        fd = os.open(sys.argv[1], os.O_CREAT | os.O_EXCL)\n"
            "        os.close(fd)\n"
            "        time.sleep(1.0)\n"     # let the peer start monitoring
            "        sys.exit(7)\n"         # the one crasher
            "    except FileExistsError:\n"
            "        time.sleep(300)\n"     # peer: no cascade, just blocked
            "print('done', flush=True)\n")

    outs = {}

    def node(i):
        outs[i] = subprocess.run(
            [sys.executable, "-m", "editor_tpu_torch.cli.launch",
             "--nproc_per_node", "1", "--nnodes", "2",
             "--rdzv_backend", "file", "--rdzv_endpoint", rdzv,
             "--rdzv_id", "xfast", "--max_restarts", "1",
             "--monitor_interval", "0.1",
             "--rdzv_conf", "keep_alive_interval=0.3",
             "--error_dir", str(tmp_path / f"err{i}"),
             "--", sys.executable, script, lock],
            capture_output=True, text=True, timeout=120, cwd=REPO)

    ts = [threading.Thread(target=node, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(150)
    assert set(outs) == {0, 1}
    for i, r in outs.items():
        assert r.returncode == 0, (i, r.stdout[-2000:], r.stderr[-1000:])
        assert "restarts used: 1" in r.stdout, (i, r.stdout[-2000:])
    stdouts = [outs[i].stdout for i in range(2)]
    assert sum("worker failure; tearing the round down" in s
               for s in stdouts) == 1, stdouts
    assert sum("membership change (round_restarted)" in s
               for s in stdouts) == 1, stdouts
    # incarnation 1 ran to completion on both nodes
    assert all("done" in s for s in stdouts), stdouts
    # structured agent events persisted per node (torchelastic events
    # analog): every agent logged its round starts; exactly one logged the
    # failure record with the worker's exit code
    import glob as _glob
    import json as _json
    events = []
    for i in range(2):
        paths = _glob.glob(str(tmp_path / f"err{i}" / "events_*.jsonl"))
        assert paths, (i, list((tmp_path / f"err{i}").iterdir()))
        events.append([_json.loads(line)
                       for p in paths for line in open(p)])
    for ev in events:
        assert sum(e["event"] == "workers_started" for e in ev) == 2, ev
    fails = [e for ev in events for e in ev if e["event"] == "worker_failed"]
    assert len(fails) == 1 and fails[0]["failures"][0]["exitcode"] == 7


def test_launcher_joins_the_keepalive_and_leaves_only_after_it(tmp_path, monkeypatch,
                                                                capsys):
    """``_run_elastic`` over the file backend with a stand-in supervisor: a
    FAILED round (a budget token), then a SUCCEEDED one. Each round's
    keep-alive thread has ended before the next rendezvous starts. In the
    last round the store's heartbeat ``set`` blocks: the join gives up after
    ``KEEPALIVE_JOIN_S``, the launcher reports the live thread and skips
    ``leave()``, which a late beat could otherwise undo."""
    from editor_tpu_torch.cli import launch
    from editor_tpu_torch.parallel import elastic, rendezvous

    block, blocked, release = threading.Event(), threading.Event(), threading.Event()

    class BlockingStore:
        def __init__(self, inner):
            self.inner = inner

        def set(self, key, value):
            if "/hb/" in key and block.is_set():
                blocked.set()
                release.wait(30)
            return self.inner.set(key, value)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    beats, earlier_ended, left = [], [], []
    create = rendezvous.rendezvous_registry.create_handler

    def create_handler(params):
        h = create(params)
        h.store = h._rdzv.store = BlockingStore(h.store)
        start, rendezvous_ = h.start_keepalive, h.next_rendezvous

        def start_keepalive():
            beats.append(start())
            return beats[-1]

        def next_rendezvous(timeout):
            earlier_ended.append(all(not b.thread.is_alive() for b in beats[:-1]))
            return rendezvous_(timeout=timeout)

        h.start_keepalive, h.next_rendezvous = start_keepalive, next_rendezvous
        h.leave = lambda: left.append(True)
        return h

    outcomes = [elastic.RoundOutcome.FAILED, elastic.RoundOutcome.SUCCEEDED]

    class Supervisor:
        def __init__(self, spec, **kw):
            pass

        def run_round(self):
            outcome = outcomes.pop(0)
            if outcome == elastic.RoundOutcome.SUCCEEDED:
                block.set()  # the next beat sticks in the store
                assert blocked.wait(10)
            return outcome, [], None

    monkeypatch.setattr(rendezvous.rendezvous_registry, "create_handler", create_handler)
    monkeypatch.setattr(elastic, "ElasticSupervisor", Supervisor)
    monkeypatch.setattr(launch, "KEEPALIVE_JOIN_S", 0.3)
    try:
        rounds = launch.main([
            "--nproc_per_node", "1", "--rdzv_backend", "file",
            "--rdzv_endpoint", str(tmp_path / "rdzv.json"), "--rdzv_id", "ka",
            "--max_restarts", "1", "--monitor_interval", "0.05",
            "--rdzv_conf", "keep_alive_interval=0.05", "--error_dir", str(tmp_path / "err"),
            "--", sys.executable, "-c", "pass"])
        stuck = beats[-1].thread.is_alive()
    finally:
        release.set()
    out = capsys.readouterr().out
    assert rounds == 1 and len(beats) == 2 and earlier_ended == [True, True]
    assert stuck and "still in a store call" in out and left == []
    beats[-1].thread.join(5)
    assert not beats[-1].thread.is_alive()


def test_tcp_store_client_retries_until_server_up():
    """A joiner that dials in before the server's launcher has bound the
    port must poll (the reference TCPStore retries until timeout), not die
    with ConnectionRefusedError."""
    port = _port()
    client = TCPStore("127.0.0.1", port, connect_timeout=10.0)
    holder = {}

    def late_server():
        time.sleep(0.5)
        holder["server"] = TCPStore("127.0.0.1", port, is_server=True)
        holder["server"].set("ready", 1)

    t = threading.Thread(target=late_server, daemon=True)
    t.start()
    try:
        assert client.wait("ready", timeout=10) == 1
    finally:
        t.join(5)
        holder["server"].close()


def test_c10d_auto_server_election():
    """Without node ranks (they are an OUTPUT of rendezvous), the c10d
    creator elects the server by bind: first launcher on the endpoint host
    serves, the co-hosted second gets EADDRINUSE and joins as a client."""
    from editor_tpu_torch.parallel.rendezvous import (RendezvousParameters,
                                                rendezvous_registry)
    port = _port()
    mk = lambda: rendezvous_registry.create_handler(RendezvousParameters(
        backend="c10d", endpoint=f"127.0.0.1:{port}", run_id="auto_run",
        min_nodes=2, max_nodes=2))
    h1 = mk()
    h2 = mk()
    assert (h1.store.server is None) != (h2.store.server is None)
    results = {}

    def node(i, h):
        results[i] = h.next_rendezvous(timeout=20)

    threads = [threading.Thread(target=node, args=(i, h))
               for i, h in enumerate((h1, h2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert sorted(r[1] for r in results.values()) == [0, 1]
    assert {r[2] for r in results.values()} == {2}
    h1.shutdown(), h2.shutdown()


def test_c10d_missing_endpoint_is_a_clear_error():
    from editor_tpu_torch.parallel.rendezvous import (RendezvousParameters,
                                                rendezvous_registry)
    for backend, endpoint in (("c10d", ""), ("c10d", "hostonly"),
                              ("file", "")):
        with pytest.raises(ValueError, match="rdzv_endpoint"):
            rendezvous_registry.create_handler(RendezvousParameters(
                backend=backend, endpoint=endpoint, run_id="x"))


def test_wait_ne_blocks_until_change_and_times_out():
    """The notify path: wait_ne parks on the server's condition variable and
    wakes on mutation; an unchanged key returns (False, value) at timeout."""
    port = _port()
    server = TCPStore("127.0.0.1", port, is_server=True)
    try:
        client = TCPStore("127.0.0.1", port)
        client.set("k", 1)
        changed, v = client.wait_ne("k", 1, timeout=0.3)
        assert not changed and v == 1
        threading.Timer(0.2, lambda: client.set("k", 2)).start()
        t0 = time.time()
        changed, v = client.wait_ne("k", 1, timeout=10.0)
        assert changed and v == 2
        assert time.time() - t0 < 5.0  # woke on notify, not at timeout
        # missing key counts as a change vs any non-None value
        changed, v = client.wait_ne("nope", 1, timeout=0.2)
        assert changed and v is None
    finally:
        server.close()


def test_scale_down_dead_node_detected_and_pruned():
    """Scale-DOWN membership (reference dynamic_rendezvous.py:206-207,
    446-462): a participant that stops heartbeating past the TTL shows up
    in num_nodes_dead(); after the agent restarts the round, the survivors
    re-rendezvous into the SMALLER world without the dead node — previously
    a dead node stayed in the membership blob forever."""
    port = _port()
    server = TCPStore("127.0.0.1", port, is_server=True)
    try:
        mk = lambda nid: DynamicRendezvous(
            TCPStore("127.0.0.1", port), "down", min_nodes=2, max_nodes=3,
            settle_s=0.2, node_id=nid,
            keep_alive_interval=0.2, keep_alive_max_attempt=2)
        a, b, c = mk("a"), mk("b"), mk("c")
        res = {}
        ts = [threading.Thread(
            target=lambda n=n, r=r: res.update({n: r.next_rendezvous(60)}))
            for n, r in (("a", a), ("b", b), ("c", c))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(90)
        assert res["a"][2] == res["b"][2] == res["c"][2] == 3

        # workers run: a and b keep heartbeating, c crashes (no keepalive)
        stop_a, stop_b = a.start_keepalive(), b.start_keepalive()
        deadline = time.time() + 30
        while a.num_nodes_dead() == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert a.dead_nodes() == ["c"]
        assert b.num_nodes_dead() == 1

        # agent reaction: restart; only the live nodes re-join
        a.restart_round()
        t2 = [threading.Thread(
            target=lambda n=n, r=r: res.update({n: r.next_rendezvous(60)}))
            for n, r in (("a2", a), ("b2", b))]
        for t in t2:
            t.start()
        for t in t2:
            t.join(90)
        stop_a.set(); stop_b.set()
        assert res["a2"][0] == res["b2"][0] == 1
        assert res["a2"][2] == res["b2"][2] == 2
        assert sorted([res["a2"][1], res["b2"][1]]) == [0, 1]
    finally:
        server.close()


def test_dead_node_pruned_before_round_settles():
    """A node that joins and then dies before the round completes must not
    get a rank: the joining survivors prune it once its TTL lapses and the
    round settles with the live membership only."""
    port = _port()
    server = TCPStore("127.0.0.1", port, is_server=True)
    try:
        mk = lambda nid, mn: DynamicRendezvous(
            TCPStore("127.0.0.1", port), "prejoin", min_nodes=mn,
            max_nodes=3, settle_s=0.2, node_id=nid,
            keep_alive_interval=0.15, keep_alive_max_attempt=2)
        # ghost joins a round that cannot settle yet (min_nodes=3), then dies
        ghost = mk("ghost", 3)
        def _ghost_join():
            with pytest.raises(TimeoutError):
                ghost.next_rendezvous(0.2)
        tg = threading.Thread(target=_ghost_join)
        tg.start(); tg.join(10)  # times out quickly and never beats again
        time.sleep(0.5)  # > TTL

        a, b = mk("a", 2), mk("b", 2)
        res = {}
        ta = threading.Thread(target=lambda: res.update(a=a.next_rendezvous(60)))
        tb = threading.Thread(target=lambda: res.update(b=b.next_rendezvous(60)))
        ta.start(); tb.start(); ta.join(90); tb.join(90)
        assert res["a"][2] == res["b"][2] == 2  # ghost pruned, not ranked
        assert sorted([res["a"][1], res["b"][1]]) == [0, 1]
    finally:
        server.close()




# ---------------------------------------------------------------------------
# the supervisor (tests/test_ddp_elastic.py's cases)
# ---------------------------------------------------------------------------

WORKER_OK_AFTER_2 = textwrap.dedent("""
    import os, sys
    from editor_tpu_torch.parallel.elastic import record, heartbeat

    @record
    def main():
        heartbeat()
        restart = int(os.environ.get("EDITOR_TPU_RESTART_COUNT", "0"))
        if restart < 2:
            raise RuntimeError(f"simulated crash at restart {restart}")
        print("worker succeeded")

    main()
""")

WORKER_HANG = textwrap.dedent("""
    import time
    from editor_tpu_torch.parallel.elastic import heartbeat
    heartbeat()
    time.sleep(300)  # never heartbeats again
""")


def _write_worker(tmp_path, code, name):
    p = tmp_path / name
    p.write_text(code)
    return str(p)


def test_elastic_restart_until_success(tmp_path):
    from editor_tpu_torch.parallel.elastic import ElasticSupervisor, WorkerSpec
    script = _write_worker(tmp_path, WORKER_OK_AFTER_2, "w1.py")
    spec = WorkerSpec(argv=[sys.executable, script], nproc=1, max_restarts=3,
                      monitor_interval=0.2, error_dir=str(tmp_path / "err"),
                      env={"PYTHONPATH": REPO})
    sup = ElasticSupervisor(spec)
    restarts = sup.run()
    assert restarts == 2
    names = [e["event"] for e in sup.events]
    assert names.count("worker_failed") == 2
    assert "succeeded" in names
    fail_events = [e for e in sup.events if e["event"] == "worker_failed"]
    assert "simulated crash" in fail_events[0]["failures"][0]["message"]


def test_elastic_gives_up(tmp_path):
    from editor_tpu_torch.parallel.elastic import (ChildFailedError, ElasticSupervisor,
                                                   WorkerSpec)
    script = _write_worker(tmp_path, "import sys; sys.exit(3)", "w2.py")
    spec = WorkerSpec(argv=[sys.executable, script], nproc=1, max_restarts=1,
                      monitor_interval=0.1, error_dir=str(tmp_path / "err2"))
    sup = ElasticSupervisor(spec)
    with pytest.raises(ChildFailedError) as ei:
        sup.run()
    assert ei.value.failures[0].exitcode == 3


def test_elastic_watchdog_reaps_hung_worker(tmp_path):
    from editor_tpu_torch.parallel.elastic import (ChildFailedError, ElasticSupervisor,
                                                   WorkerSpec)
    script = _write_worker(tmp_path, WORKER_HANG, "w3.py")
    spec = WorkerSpec(argv=[sys.executable, script], nproc=1, max_restarts=0,
                      monitor_interval=0.3, heartbeat_timeout=2.0,
                      error_dir=str(tmp_path / "err3"), env={"PYTHONPATH": REPO})
    sup = ElasticSupervisor(spec)
    t0 = time.time()
    with pytest.raises(ChildFailedError):
        sup.run()
    assert time.time() - t0 < 60
    assert any(e["event"] == "watchdog_kill" for e in sup.events)


def test_run_round_membership_change_stops_workers(tmp_path):
    """A healthy worker group is stopped and the round ends with
    MEMBERSHIP_CHANGED and the reason (reference api.py:872-884)."""
    from editor_tpu_torch.parallel.elastic import (ElasticSupervisor, RoundOutcome,
                                                   WorkerSpec)
    script = _write_worker(tmp_path, "import time; time.sleep(300)", "wm.py")
    spec = WorkerSpec(argv=[sys.executable, script], nproc=2,
                      monitor_interval=0.1, error_dir=str(tmp_path / "err"))
    sup = ElasticSupervisor(spec, membership_check=lambda: "scale_up",
                            membership_interval=0.0)
    t0 = time.time()
    outcome, failures, reason = sup.run_round()
    assert outcome == RoundOutcome.MEMBERSHIP_CHANGED
    assert reason == "scale_up" and failures == []
    assert time.time() - t0 < 30
    assert all(w.proc.poll() is not None for w in sup.workers)
    assert any(e["event"] == "membership_changed" for e in sup.events)


def test_run_round_reports_failure_without_restarting(tmp_path):
    """run_round leaves the restart policy to the caller: a failed group is
    stopped and reported, never restarted."""
    from editor_tpu_torch.parallel.elastic import (ElasticSupervisor, RoundOutcome,
                                                   WorkerSpec)
    script = _write_worker(tmp_path, "import sys; sys.exit(5)", "wf.py")
    spec = WorkerSpec(argv=[sys.executable, script], nproc=1, max_restarts=9,
                      monitor_interval=0.1, error_dir=str(tmp_path / "err"))
    sup = ElasticSupervisor(spec, restart_count=3)
    outcome, failures, reason = sup.run_round()
    assert outcome == RoundOutcome.FAILED and reason is None
    assert failures[0].exitcode == 5
    starts = [e for e in sup.events if e["event"] == "workers_started"]
    assert len(starts) == 1 and starts[0]["restart"] == 3
    assert failures[0].error_file.endswith("error_3_0.json")


ENV_WORKER = textwrap.dedent("""
    import json, os, sys
    keys = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT", "NODE_RANK", "NPROC_PER_NODE", "EDITOR_TPU_RESTART_COUNT")
    env = {k: os.environ.get(k) for k in keys}
    with open(os.path.join(sys.argv[1], "env_%s_%s.json" % (
            env["EDITOR_TPU_RESTART_COUNT"], env["LOCAL_RANK"])), "w") as f:
        json.dump(env, f)
    if env["EDITOR_TPU_RESTART_COUNT"] == "0" and env["LOCAL_RANK"] == "1":
        sys.exit(4)
""")


def test_static_launch_sets_torchrun_env_and_a_port_each_incarnation(tmp_path):
    """``cli.launch --nproc_per_node 2 --node_rank 1 --nnodes 2``: each
    worker has torchrun's environment (RANK = NODE_RANK * 2 + LOCAL_RANK);
    with ``--master_port 0`` on one node each incarnation gets a free port."""
    script = _write_worker(tmp_path, ENV_WORKER, "env.py")
    r = subprocess.run([sys.executable, "-m", "editor_tpu_torch.cli.launch",
                        "--nproc_per_node", "2", "--nnodes", "2", "--node_rank", "1",
                        "--master_port", "29731", "--max_restarts", "0",
                        "--monitor_interval", "0.1", "--error_dir", str(tmp_path / "e1"),
                        "--", sys.executable, script, str(tmp_path)],
                       capture_output=True, text=True, timeout=60, cwd=REPO)
    assert r.returncode != 0  # local rank 1 exits 4; no restart left
    envs = [json.load(open(tmp_path / f"env_0_{i}.json")) for i in range(2)]
    assert [e["RANK"] for e in envs] == ["2", "3"]
    for i, e in enumerate(envs):
        assert e == dict(e, LOCAL_RANK=str(i), WORLD_SIZE="4", LOCAL_WORLD_SIZE="2",
                         NODE_RANK="1", NPROC_PER_NODE="2", MASTER_PORT="29731")
    for f in tmp_path.glob("env_*.json"):
        f.unlink()
    r = subprocess.run([sys.executable, "-m", "editor_tpu_torch.cli.launch",
                        "--nproc_per_node", "2", "--master_port", "0", "--max_restarts", "1",
                        "--monitor_interval", "0.1", "--error_dir", str(tmp_path / "e2"),
                        "--", sys.executable, script, str(tmp_path)],
                       capture_output=True, text=True, timeout=60, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "restarts used: 1" in r.stdout
    ports = {json.load(open(tmp_path / f"env_{n}_0.json"))["MASTER_PORT"] for n in (0, 1)}
    assert len(ports) == 2 and "0" not in ports
    assert json.load(open(tmp_path / "env_1_1.json"))["RANK"] == "1"


# ---------------------------------------------------------------------------
# multihost repairs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,rank", [
    ({"LOCAL_RANK": "1", "NODE_RANK": "1", "NPROC_PER_NODE": "2"}, 3),
    ({"RANK": "2", "LOCAL_RANK": "1", "NODE_RANK": "1", "NPROC_PER_NODE": "2"}, 2),
    ({"LOCAL_RANK": "1"}, 1), ({}, 0)])
def test_initialize_takes_rank_or_derives_it(env, rank, monkeypatch):
    import torch.distributed as dist

    from editor_tpu_torch.parallel import multihost
    for k in ("RANK", "LOCAL_RANK", "NODE_RANK", "NPROC_PER_NODE", "DIST_INIT_METHOD",
              "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in dict(env, WORLD_SIZE="4").items():
        monkeypatch.setenv(k, v)
    got = {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: got.update(k))
    assert multihost.initialize(init_method="file:///nowhere", device="cpu")
    assert got["rank"] == rank and got["world_size"] == 4


_FAIL = textwrap.dedent("""
    import sys
    from editor_tpu_torch.parallel import multihost
    how = sys.argv[1]
    try:
        if how == "exit":
            raise SystemExit(3)
        if how == "interrupt":
            raise KeyboardInterrupt
        raise ValueError("a fault")
    except BaseException as e:
        if how == "fault_fast":
            multihost.fail_fast(e, exit_code=2)
        if how == "quiet_fast":
            multihost.fail_fast(e, exit_code=2, write_error=False)
        multihost.leave_on_error(e)  # one process: returns
        raise
""")


@pytest.mark.parametrize("how,code,written", [("fault_fast", 2, True),
                                              ("quiet_fast", 2, False),
                                              ("fault", 1, True), ("exit", 3, False),
                                              ("interrupt", -2, False)])
def test_error_file_for_faults_only(how, code, written, tmp_path):
    """``fail_fast`` writes ``EDITOR_TPU_ERROR_FILE`` unless told not to;
    ``leave_on_error`` in one process writes it for a fault and not for a
    deliberate exit (``SystemExit``; Ctrl-C, which Python ends with SIGINT),
    and returns."""
    script = _write_worker(tmp_path, _FAIL, "fail.py")
    err = tmp_path / "err.json"
    r = subprocess.run([sys.executable, script, how], capture_output=True, text=True,
                       timeout=60, cwd=REPO,
                       env=child_env({"EDITOR_TPU_ERROR_FILE": str(err)}))
    assert r.returncode == code, r.stderr[-2000:]
    assert err.exists() == written
    if written:
        data = json.load(open(err))
        assert data["exc_type"] == "ValueError" and data["message"] == "a fault"
        assert "a fault" in data["traceback"]


# ---------------------------------------------------------------------------
# the launcher end to end
# ---------------------------------------------------------------------------

TINY = ["MODEL.TRANSFORMER_TYPE", "vit_tiny_test", "MODEL.PRETRAIN_CHOICE", "random",
        "INPUT.SIZE_TRAIN", "[64, 32]", "INPUT.SIZE_TEST", "[64, 32]",
        "MODEL.FREQUENCY_KEEP", "3", "DATALOADER.NUM_INSTANCE", "2",
        "DATALOADER.NUM_WORKERS", "2", "SOLVER.IMS_PER_BATCH", "8", "SOLVER.LOG_PERIOD", "1",
        "TEST.IMS_PER_BATCH", "5", "TPU.COMPUTE_DTYPE", "float32",
        "INPUT.PROB", "0", "INPUT.RE_PROB", "0", "INPUT.PADDING", "0", "MODEL.DROP_PATH", "0",
        "SOLVER.CHECKPOINT_PERIOD", "1", "SOLVER.EVAL_PERIOD", "2", "SOLVER.MAX_EPOCHS", "2"]


def _launch(tmp_path, scenario, inputs, *args, timeout=150):
    d = tmp_path / scenario
    d.mkdir(exist_ok=True)
    torch.save(inputs, d / "inputs.pt")
    return subprocess.run([sys.executable, "-m", "editor_tpu_torch.cli.launch", *args,
                           "--monitor_interval", "0.2", "--error_dir", str(d / "err"),
                           "--", sys.executable, WORKER, "--launched", scenario, str(d)],
                          capture_output=True, text=True, timeout=timeout, cwd=REPO,
                          env=child_env()), d


def _losses(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [(r["epoch"], r["loss"]) for r in map(json.loads, f) if "loss" in r]


def test_launcher_restarts_fsdp_trainer_and_resumes(tmp_path):
    from editor_tpu_torch.cli import train as cli_train
    from editor_tpu_torch.data.datasets import DatasetSplits
    from tests.torch_dp import decode, items

    out = str(tmp_path / "run")
    argv = ["--device", "cpu"] + TINY + ["TPU.ZERO_STAGE", "3", "OUTPUT_DIR", out]
    r, d = _launch(tmp_path, "launch_train", {"argv": argv, "fail_rank": 1, "fail_epoch": 2},
                   "--nproc_per_node", "2", "--max_restarts", "1", "--master_port", "0")
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    assert "restarts used: 1" in r.stdout
    errors = list((d / "err").glob("agent_*/error_0_1.json"))
    assert errors, list((d / "err").rglob("*"))
    data = json.load(open(errors[0]))
    assert data["exc_type"] == "RuntimeError" and "planted data failure" in data["message"]
    ranks = [torch.load(d / f"out_{r}_1.pt", weights_only=False) for r in range(2)]
    assert ranks[0]["resumed"] == ranks[1]["resumed"] and len(ranks[0]["resumed"]) == 1
    assert ranks[0]["resumed"][0]["epoch"] == 1
    with open(os.path.join(out, "train_log.txt")) as f:
        log = f.read()
    assert "FSDP/ZeRO-3" in log and "Resumed from checkpoint" in log
    # the uninterrupted run: one process, no mesh, the same global batches
    one = str(tmp_path / "one")
    cli_train.main(["--device", "cpu"] + TINY + ["OUTPUT_DIR", one],
                   splits=DatasetSplits(*items(), 4, 2), decode_fn=decode)
    got, ref = _losses(out), _losses(one)
    assert [e for e, _ in got] == [e for e, _ in ref] and {e for e, _ in ref} == {1, 2}
    np.testing.assert_allclose([x for _, x in got], [x for _, x in ref], rtol=1e-6)


def test_two_launchers_one_group_over_the_file_backend(tmp_path):
    rdzv = str(tmp_path / "rdzv.json")
    torch.save({}, tmp_path / "inputs.pt")
    outs = {}

    def node(i):
        outs[i] = subprocess.run(
            [sys.executable, "-m", "editor_tpu_torch.cli.launch", "--nproc_per_node", "1",
             "--nnodes", "2", "--rdzv_backend", "file", "--rdzv_endpoint", rdzv,
             "--rdzv_id", "group", "--max_restarts", "0", "--master_port", "0",
             "--monitor_interval", "0.2", "--error_dir", str(tmp_path / f"err{i}"),
             "--", sys.executable, WORKER, "--launched", "launch_group", str(tmp_path)],
            capture_output=True, text=True, timeout=120, cwd=REPO, env=child_env())

    ts = [threading.Thread(target=node, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(150)
    for i, r in outs.items():
        assert r.returncode == 0, (i, r.stdout[-2000:], r.stderr[-2000:])
    got = [torch.load(tmp_path / f"out_{r}_0.pt", weights_only=False) for r in range(2)]
    for r, g in enumerate(got):
        assert g["env"]["NODE_RANK"] == str(r) and g["env"]["LOCAL_RANK"] == "0"
        assert g["views"] == [[0, 2, 0], [1, 2, 1]]  # one group: derived = launcher's rank
    assert got[0]["env"]["MASTER_ADDR"] == got[1]["env"]["MASTER_ADDR"]


def test_deliberate_exit_writes_no_error_file(tmp_path):
    r, d = _launch(tmp_path, "deliberate_exit", {}, "--nproc_per_node", "2",
                   "--max_restarts", "0", "--master_port", "0", timeout=90)
    assert r.returncode != 0  # the budget is 0: the launcher gives up
    assert "exit 3" in r.stderr, r.stderr[-2000:]
    assert not list((d / "err").glob("agent_*/error_0_1.json"))
