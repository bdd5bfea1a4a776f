"""Elastic launcher, the torchrun equivalent: counterpart of
``editor_tpu/cli/launch.py``.

reference: distributed/run.py:328-696 (torchrun CLI), launcher/api.py:28-95
(LaunchConfig/elastic_launch), legacy launch.py. Spawns N worker processes
with torchrun's environment (RANK/LOCAL_RANK/WORLD_SIZE/LOCAL_WORLD_SIZE/
MASTER_ADDR/MASTER_PORT, plus NODE_RANK and NPROC_PER_NODE; consumed by
``editor_tpu_torch.parallel.multihost.initialize``, which ``cli.train``
calls) under the elastic supervisor (bounded restarts, watchdog, error
files). A failed worker group is restarted whole, and the trainer resumes
from its latest checkpoint.

Usage:
    python -m editor_tpu_torch.cli.launch --nproc_per_node 2 --max_restarts 3 \
        -- python -m editor_tpu_torch.cli.train --config_file configs/RGBNT201.yaml

``--master_port 0`` takes a free port for each incarnation (one node);
``--rdzv_backend c10d|file|etcd`` negotiates node ranks across launchers.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

# how long a round's end waits for the heartbeat thread's last beat
KEEPALIVE_JOIN_S = 10.0


def main(argv=None):
    parser = argparse.ArgumentParser(description="editor_tpu_torch elastic launcher")
    parser.add_argument("--nproc_per_node", type=int,
                        default=int(os.environ.get("NPROC_PER_NODE", "1")))
    parser.add_argument("--nnodes", type=int, default=1)
    parser.add_argument("--node_rank", type=int,
                        default=int(os.environ.get("NODE_RANK", "0")))
    parser.add_argument("--master_addr",
                        default=os.environ.get("MASTER_ADDR", "127.0.0.1"))
    parser.add_argument("--master_port",
                        default=os.environ.get("MASTER_PORT", "29500"),
                        help="the rank-0 node's port; 0: a free port for each "
                             "incarnation")
    parser.add_argument("--rdzv_backend", default="static",
                        help="rendezvous backend from the registry: "
                             "'static' (env-based ranks, the default), "
                             "'c10d' (TCPStore at --rdzv_endpoint), "
                             "'etcd' (etcd v3 gateway at --rdzv_endpoint), "
                             "or 'file' (--rdzv_endpoint is a shared path)")
    parser.add_argument("--rdzv_endpoint", default="",
                        help="host:port (c10d/etcd) or filesystem path (file)")
    parser.add_argument("--rdzv_id", default="editor_tpu_job")
    parser.add_argument("--rdzv_conf", default="",
                        help="backend extras as KEY=VALUE[,KEY=VALUE...] "
                             "(torchrun --rdzv_conf): e.g. settle_s=5, "
                             "keep_alive_interval=2, is_server=1")
    parser.add_argument("--min_nodes", type=int, default=None,
                        help="elastic lower bound (defaults to --nnodes)")
    parser.add_argument("--max_nodes", type=int, default=None,
                        help="elastic upper bound (defaults to --nnodes)")
    parser.add_argument("--max_restarts", type=int, default=3)
    parser.add_argument("--monitor_interval", type=float, default=1.0)
    parser.add_argument("--heartbeat_timeout", type=float, default=None)
    parser.add_argument("--error_dir",
                        default=os.path.join(tempfile.gettempdir(), "editor_tpu_elastic"))
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- worker command line")
    args = parser.parse_args(argv)

    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("no worker command given (append: -- python your_script.py)")

    from editor_tpu_torch.parallel.elastic import ElasticSupervisor, WorkerSpec

    if args.rdzv_backend != "static":
        return _run_elastic(args, cmd)
    if str(args.master_port) == "0" and args.nnodes > 1:
        parser.error("--master_port 0 picks a port on this node: give the static "
                     "launch of several nodes a fixed port, or use --rdzv_backend")

    # static path: fixed node ranks/addresses (torchrun --standalone /
    # --node_rank), one supervisor with internal restart-all
    world = args.nnodes * args.nproc_per_node
    env = {
        "MASTER_ADDR": args.master_addr,
        "MASTER_PORT": str(args.master_port),
        "WORLD_SIZE": str(world),
        "NODE_RANK": str(args.node_rank),
        "NPROC_PER_NODE": str(args.nproc_per_node),
    }
    spec = WorkerSpec(
        argv=cmd,
        nproc=args.nproc_per_node,
        max_restarts=args.max_restarts,
        monitor_interval=args.monitor_interval,
        heartbeat_timeout=args.heartbeat_timeout,
        env=env,
        error_dir=args.error_dir,
    )

    # the supervisor sets each worker's LOCAL_RANK and RANK = NODE_RANK *
    # nproc + LOCAL_RANK
    sup = ElasticSupervisor(spec, event_log=_event_writer(args.error_dir))
    restarts = sup.run()
    print(f"launch complete; restarts used: {restarts}")
    return restarts


def _event_writer(error_dir: str):
    """Persist structured agent events (workers_started / worker_failed /
    membership_changed / restarting / succeeded / gave_up / watchdog_kill)
    as JSONL — the torchelastic events module analog (reference
    elastic/events/api.py:28)."""
    import json
    os.makedirs(error_dir, exist_ok=True)
    path = os.path.join(error_dir, f"events_{os.getpid()}.jsonl")

    def write(rec):
        try:
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass

    return write


def _parse_rdzv_conf(s: str) -> dict:
    """Parse --rdzv_conf KEY=VALUE[,KEY=VALUE...] tolerating whitespace
    around keys/values (torchrun strips these; 'k1=v1, k2=v2' — the format
    the flag's own help text shows — must not silently drop k2)."""
    conf = {}
    for kv in s.split(","):
        key, sep, val = kv.partition("=")
        key = key.strip()
        if not key:
            continue
        conf[key] = val.strip() if sep else "1"  # bare key = flag (torchrun)
    return conf


def _stop_keepalive(ka_stop) -> bool:
    """Stops the heartbeat thread of ``handler.start_keepalive()`` and joins
    it for ``KEEPALIVE_JOIN_S`` at most; returns whether it ended. A thread
    still inside a store call past that is reported: a beat already past
    its stop-check could re-create the heartbeat key after a ``leave()``
    deleted it, so the caller must not leave (the key then expires with
    its TTL)."""
    ka_stop.set()
    thread = getattr(ka_stop, "thread", None)
    if thread is None:
        return True
    thread.join(timeout=KEEPALIVE_JOIN_S)
    if thread.is_alive():
        print(f"the keep-alive thread is still in a store call after {KEEPALIVE_JOIN_S:g} s; "
              "not leaving the rendezvous (its heartbeat key expires with the TTL)")
        return False
    return True


def _elect_coordinator(args, store, node_rank: int, rnd: int) -> tuple:
    """Publish/fetch the rank-0 node's address (the workers' MASTER_ADDR and
    MASTER_PORT) through the
    rendezvous store. Node ranks are random-uuid-ordered, so the elected
    rank-0 node is generally NOT the host named by --master_addr; the key is
    round-scoped because reused run_ids on a persistent store must not see
    a previous round's address (reference: torch elastic workers read the
    rank-0 fqdn from the rendezvous store)."""
    import socket
    key = f"rdzv/{args.rdzv_id}/coord/{rnd}"
    if node_rank == 0:
        # FQDN: short container hostnames are often not DNS-resolvable
        # from peer nodes (torch elastic publishes the fqdn too). But
        # getfqdn() returns 'localhost' when reverse DNS maps the host
        # to 127.0.0.1 — useless to peers, so fall back to the hostname.
        fqdn = socket.getfqdn()
        if not fqdn or fqdn == "localhost" or fqdn.startswith("localhost."):
            fqdn = socket.gethostname()
        port = str(args.master_port)
        if port == "0":
            # auto port: fresh per round, so a restarted coordinator can
            # never collide with a lingering socket of the previous one
            with socket.socket() as s:
                s.bind(("", 0))
                port = str(s.getsockname()[1])
        store.set(key, f"{fqdn}:{port}")
        if rnd > 0:
            # persistent stores (etcd/file) would otherwise accumulate one
            # stale coord key per torn-down round for the job's lifetime
            try:
                store.delete(f"rdzv/{args.rdzv_id}/coord/{rnd - 1}")
            except (OSError, AttributeError):
                pass
        return fqdn, port
    addr, _, port = store.wait(key, timeout=60.0).rpartition(":")
    return addr, port


def _run_elastic(args, cmd) -> int:
    """Dynamic-rendezvous launch: the full torchrun agent loop (reference
    _invoke_run, elastic/agent/server/api.py:827-884). Each node-level
    launcher negotiates membership through the pluggable rendezvous
    registry, spawns its workers, and supervises ONE round at a time:

      * local worker failure  -> consume a --max_restarts token, tear the
        round down (restart_round) so every peer re-joins, re-rendezvous;
      * peer tore the round down (round counter moved) -> stop local
        workers, re-join — restart-all across NODE boundaries;
      * scale-up (nodes parked in the waiting set) / scale-down (peer
        heartbeats expired) -> tear down + re-join with the new membership
        (WORLD_SIZE changes; workers resume from the latest checkpoint).

    Membership-change restarts do not consume the failure budget, matching
    the reference agent."""
    from editor_tpu_torch.parallel.elastic import (ChildFailedError,
                                                   ElasticSupervisor, RoundOutcome,
                                                   WorkerSpec)
    from editor_tpu_torch.parallel.rendezvous import (RendezvousParameters,
                                                      rendezvous_registry)

    # c10d server election is automatic ("auto"): the launcher that can
    # bind --rdzv_endpoint hosts the store, everyone else connects — node
    # ranks are an OUTPUT of the rendezvous, so they cannot gate who serves
    # (with the default node_rank=0 every node would try).
    conf = _parse_rdzv_conf(args.rdzv_conf)
    handler = rendezvous_registry.create_handler(RendezvousParameters(
        backend=args.rdzv_backend, endpoint=args.rdzv_endpoint,
        run_id=args.rdzv_id,
        min_nodes=args.min_nodes or args.nnodes,
        max_nodes=args.max_nodes or args.nnodes,
        config=conf))

    event_log = _event_writer(args.error_dir)
    failures_used = 0   # worker-failure restarts consumed (--max_restarts)
    rounds = 0          # total incarnations (seeds EDITOR_TPU_RESTART_COUNT)
    # join timeout: how long a re-rendezvous may wait for peers to (re)join
    # (a rebooting node can take minutes) — torchrun's join_timeout analog
    join_timeout = float(conf.get("join_timeout_s", 600.0))
    # the heartbeat asserts AGENT liveness, not round phase: it beats from
    # before each rendezvous to the end of the round's probe, so teardown
    # gaps can never read a live peer as dead; each round ends with the
    # thread stopped and joined (no beat races a leave(), a set_closed() or
    # the next round's keys), and the next round starts a new one
    ka_stop = None
    while True:
        if ka_stop is None:
            ka_stop = handler.start_keepalive()
        store, node_rank, nnodes = handler.next_rendezvous(
            timeout=join_timeout)
        rnd = handler.last_round
        print(f"rendezvous[{args.rdzv_backend}] settled: "
              f"node {node_rank}/{nnodes} (round {rnd})")
        try:
            master_addr, master_port = _elect_coordinator(
                args, store, node_rank, rnd)
        except TimeoutError:
            # the elected rank-0 node died between settle and publish: a
            # membership event, not a launcher error — tear the round down
            # and re-join (its heartbeat expiry prunes it from the next
            # round), budget-free like every other peer-death path
            print("coordinator address never published (rank-0 node died?); "
                  "re-rendezvousing")
            rounds += 1
            handler.restart_round()
            continue
        print(f"coordinator (rank-0 node): {master_addr}")

        world = nnodes * args.nproc_per_node
        spec = WorkerSpec(
            argv=cmd,
            nproc=args.nproc_per_node,
            max_restarts=0,  # restart policy lives in THIS loop
            monitor_interval=args.monitor_interval,
            heartbeat_timeout=args.heartbeat_timeout,
            error_dir=args.error_dir,
            env={
                "MASTER_ADDR": master_addr,
                "MASTER_PORT": str(master_port),
                "WORLD_SIZE": str(world),
                "NODE_RANK": str(node_rank),
                "NPROC_PER_NODE": str(args.nproc_per_node),
            },
        )

        def _membership(rnd=rnd):
            try:
                if handler.current_round() != rnd:
                    return "round_restarted"
                if handler.num_nodes_waiting() > 0:
                    return "scale_up"
                if handler.num_nodes_dead() > 0:
                    return "scale_down"
            except Exception:
                # store flakiness mid-probe (teardown of a finished peer
                # hosting the c10d store, a garbled etcd gateway reply):
                # keep supervising — the workers' process group does not
                # depend on the rendezvous store, and run_round guarantees
                # workers are stopped if anything truly fatal escapes
                pass
            return None

        sup = ElasticSupervisor(
            spec, membership_check=_membership,
            membership_interval=float(conf.get("keep_alive_interval", 5.0)),
            restart_count=rounds, event_log=event_log)
        outcome, failures, reason = sup.run_round()

        if outcome == RoundOutcome.FAILED:
            # When one worker dies, every peer's in-flight collective fails
            # within about a second, so healthy nodes land here too (the
            # reference behaves the same under NCCL error cascades). Before
            # spending a budget token, give the rendezvous a short window
            # to reveal a peer-side cause: the ORIGIN agent tears the round
            # down within ~1 monitor tick, so a cascaded failure sees the
            # round counter move (or a pending scale signal) and restarts
            # budget-free — only the true origin (and genuinely local
            # faults) consume --max_restarts.
            probe_deadline = time.time() + 2.0 * args.monitor_interval + 1.0
            while reason is None and time.time() < probe_deadline:
                reason = _membership()
                if reason is None:
                    time.sleep(min(0.2, args.monitor_interval))
        joined = _stop_keepalive(ka_stop)
        ka_stop = None
        if outcome == RoundOutcome.SUCCEEDED:
            print(f"launch complete; restarts used: {rounds}")
            # graceful departure: REMOVE this node from the round's
            # participant set (a peer still checkpointing must not read our
            # expiring heartbeat as scale_down and kill its nearly-done
            # workers), then drop the store connection; not while a beat
            # could still re-create the heartbeat key after leave()
            if joined:
                try:
                    handler.leave()
                except OSError:
                    pass  # store already gone (we may have hosted it)
            handler.shutdown()
            return rounds
        rounds += 1
        if outcome == RoundOutcome.FAILED:
            if reason:
                print(f"membership change ({reason}): local worker exit "
                      f"attributed to a peer event; re-rendezvousing")
                if reason in ("scale_up", "scale_down"):
                    handler.restart_round()
                continue
            if failures_used >= args.max_restarts:
                print("launch failed; restart budget exhausted")
                try:
                    # let peers exit with RendezvousClosedError instead of
                    # blocking out their join timeout (reference agent
                    # shuts the rendezvous down on give-up)
                    handler.set_closed()
                except OSError:
                    pass
                raise ChildFailedError(failures)
            failures_used += 1
            print(f"worker failure; tearing the round down and "
                  f"re-rendezvousing ({args.max_restarts - failures_used} "
                  f"failure restarts left)")
            handler.restart_round()
        else:
            print(f"membership change ({reason}); re-rendezvousing")
            if reason in ("scale_up", "scale_down"):
                # the detecting node tears the round down; peers observe
                # the round counter move ("round_restarted") and re-join
                handler.restart_round()


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
