"""Store-based dynamic rendezvous for elastic membership changes.

reference: distributed/elastic/rendezvous/ — ``RendezvousHandler`` ABC
(api.py:33), the ``DynamicRendezvousHandler`` join/close/keepalive state
machine (dynamic_rendezvous.py:877, ops :779-875), and the c10d-store
backend (c10d_rendezvous_backend.py:33) over a TCPStore (rendezvous.py:54).

Counterpart of ``editor_tpu/parallel/rendezvous.py`` (stdlib only, the same
wire protocol and state machine). ``torch.distributed.init_process_group``
needs a consistent (master address, rank, world size) before the workers
start; this module is the piece that NEGOTIATES those across an elastic
node set for ``cli.launch`` — nodes join a
round, the round settles once min_nodes are present (or closes at
max_nodes), every node gets a deterministic rank, and late arrivals park in
a waiting set that running agents observe via ``num_nodes_waiting`` to
decide to re-rendezvous (the reference's scale-up path,
agent/server/api.py:872-884).

The store is a tiny TCP key-value server with set/get/add/wait plus a
BLOCKING ``wait_ne`` (server-side condition variable) — the TCPStore
equivalent; state lives in one JSON blob updated by compare-and-swap so
concurrent joins are race-free, and waiters park on the blob instead of
polling. Liveness: per-node heartbeat keys with TTL expiry give dead-node
detection and scale-down membership (see :class:`DynamicRendezvous`).
torch's own elastic rendezvous has no 'file' or etcd-v3 backend and no
blocking ``wait_ne``, so it does not take this module's place.
"""

from __future__ import annotations

import abc
import dataclasses
import json
import os
import socket
import socketserver
import struct
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional, Tuple


def _send(sock, obj):
    data = json.dumps(obj).encode()
    sock.sendall(struct.pack("!I", len(data)) + data)


def _recv(sock):
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            raise ConnectionError("peer closed")
        hdr += chunk
    (n,) = struct.unpack("!I", hdr)
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(min(65536, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return json.loads(buf)


class _StoreHandler(socketserver.BaseRequestHandler):
    def handle(self):
        try:
            msg = _recv(self.request)
        except ConnectionError:
            return
        store = self.server.kv  # type: ignore[attr-defined]
        lock = self.server.kv_lock  # type: ignore[attr-defined]
        cond = self.server.kv_cond  # type: ignore[attr-defined]
        op = msg["op"]
        if op == "set":
            with lock:
                store[msg["key"]] = msg["value"]
                cond.notify_all()
            _send(self.request, {"ok": True})
        elif op == "get":
            with lock:
                _send(self.request, {"ok": True,
                                     "value": store.get(msg["key"])})
        elif op == "cas":  # compare-and-swap on the JSON value
            with lock:
                cur = store.get(msg["key"])
                if cur == msg["expect"]:
                    store[msg["key"]] = msg["value"]
                    cond.notify_all()
                    _send(self.request, {"ok": True, "value": msg["value"]})
                else:
                    _send(self.request, {"ok": False, "value": cur})
        elif op == "add":
            with lock:
                cur = int(store.get(msg["key"], 0)) + int(msg["delta"])
                store[msg["key"]] = cur
                cond.notify_all()
            _send(self.request, {"ok": True, "value": cur})
        elif op == "delete":
            with lock:
                existed = store.pop(msg["key"], None) is not None
                cond.notify_all()
            _send(self.request, {"ok": existed})
        elif op == "wait_ne":
            # BLOCKING read: hold the connection until store[key] differs
            # from the client's last-seen value, then return the new value.
            # This is the notify path that makes a parked rendezvous node
            # race-free: the current value is compared UNDER THE SAME LOCK
            # that every mutation takes, so a round restart landing between
            # the client's read and its wait cannot be missed (the
            # lost-wakeup hazard of the previous poll-only protocol).
            deadline = time.time() + float(msg.get("timeout", 30.0))
            with lock:
                while True:
                    cur = store.get(msg["key"])
                    if cur != msg["not_value"]:
                        _send(self.request,
                              {"ok": True, "changed": True, "value": cur})
                        return
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        _send(self.request,
                              {"ok": True, "changed": False, "value": cur})
                        return
                    cond.wait(remaining)


class _StoreServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class TCPStore:
    """Minimal TCPStore equivalent (reference rendezvous.py:54 store
    creation): rank-0 hosts the server; everyone connects as a client.

    Clients retry refused connections for up to ``connect_timeout`` seconds
    — normal multi-node skew means joiners routinely dial in before the
    server's launcher has bound the port (the reference TCPStore polls until
    its timeout for exactly this startup race)."""

    def __init__(self, host: str, port: int, is_server: bool = False,
                 connect_timeout: float = 60.0):
        self.addr = (host, port)
        self.connect_timeout = connect_timeout
        self.server = None
        if is_server:
            self.server = _StoreServer((host, port), _StoreHandler)
            self.server.kv = {}
            self.server.kv_lock = threading.Lock()
            self.server.kv_cond = threading.Condition(self.server.kv_lock)
            threading.Thread(target=self.server.serve_forever,
                             daemon=True).start()

    def _connect(self):
        deadline = time.time() + self.connect_timeout
        while True:
            try:
                return socket.create_connection(self.addr, timeout=10)
            except (ConnectionRefusedError, ConnectionResetError, OSError):
                if self.server is not None or time.time() >= deadline:
                    raise
                time.sleep(0.25)

    def _call(self, msg, sock_timeout: Optional[float] = None):
        with self._connect() as s:
            if sock_timeout is not None:
                s.settimeout(sock_timeout)
            _send(s, msg)
            return _recv(s)

    def set(self, key: str, value) -> None:
        self._call({"op": "set", "key": key, "value": value})

    def get(self, key: str):
        return self._call({"op": "get", "key": key})["value"]

    def add(self, key: str, delta: int = 1) -> int:
        return self._call({"op": "add", "key": key, "delta": delta})["value"]

    def delete(self, key: str) -> bool:
        return self._call({"op": "delete", "key": key})["ok"]

    def compare_and_swap(self, key: str, expect, value):
        r = self._call({"op": "cas", "key": key, "expect": expect,
                        "value": value})
        return r["ok"], r["value"]

    def wait(self, key: str, timeout: float = 30.0):
        deadline = time.time() + timeout
        while True:
            changed, v = self.wait_ne(
                key, None, timeout=max(0.0, deadline - time.time()))
            if changed:
                return v
            if time.time() >= deadline:
                raise TimeoutError(
                    f"store key {key!r} not set within {timeout}s")

    def wait_ne(self, key: str, not_value, timeout: float = 30.0):
        """Block (server-side, condition-variable) until ``store[key]``
        differs from ``not_value`` or the timeout lapses.
        Returns (changed, current_value) — never raises on timeout."""
        r = self._call({"op": "wait_ne", "key": key, "not_value": not_value,
                        "timeout": timeout},
                       sock_timeout=timeout + 15.0)  # outlive the block
        return r["changed"], r["value"]

    def close(self):
        if self.server is not None:
            self.server.shutdown()


class DynamicRendezvous:
    """Join/settle/observe state machine over the store.

    State blob (one JSON value, CAS-updated):
      {"round": N, "participants": {node_id: join_ts},
       "waiting": {node_id: ts}, "complete": bool}

    Liveness (reference dynamic_rendezvous.py:206-207,353,446-462): every
    node owns a HEARTBEAT key ``{key}/hb/{node}`` refreshed on join, on
    every pass through :meth:`next_rendezvous`, and by the background
    :meth:`start_keepalive` thread while workers run. A node whose last
    heartbeat is older than ``keep_alive_interval * keep_alive_max_attempt``
    is DEAD: joining nodes prune dead participants from an un-settled round,
    and the agent detects scale-DOWN of a completed round via
    :meth:`num_nodes_dead` / :meth:`dead_nodes` and re-rendezvouses —
    membership shrink no longer rests solely on worker-failure restarts.

    Blocking: all waits go through the store's ``wait_ne`` (server-side
    condition variable keyed on the same lock every mutation takes), so a
    round restart can never race past a parked node — the lost-wakeup
    hazard of the previous poll-only loop.
    """

    def __init__(self, store: TCPStore, run_id: str, min_nodes: int,
                 max_nodes: int, settle_s: float = 0.3,
                 node_id: Optional[str] = None,
                 keep_alive_interval: float = 5.0,
                 keep_alive_max_attempt: int = 3):
        self.store = store
        self.key = f"rdzv/{run_id}"
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.settle_s = settle_s
        self.node_id = node_id or uuid.uuid4().hex[:8]
        self.keep_alive_interval = keep_alive_interval
        self.keep_alive_max_attempt = keep_alive_max_attempt
        self._last_dead_scan = 0.0

    # -- state helpers -----------------------------------------------------
    _EMPTY = {"round": 0, "participants": {}, "waiting": {},
              "complete": False}

    def _state(self) -> Dict:
        return self.store.get(self.key) or dict(self._EMPTY)

    def _cas(self, old, new) -> bool:
        expect = None if old is None else old
        ok, _ = self.store.compare_and_swap(self.key, expect, new)
        return ok

    # -- liveness ------------------------------------------------------------
    @property
    def _ttl(self) -> float:
        return self.keep_alive_interval * self.keep_alive_max_attempt

    def keep_alive(self) -> None:
        """Refresh this node's heartbeat (reference _KeepAliveOp,
        dynamic_rendezvous.py:446-462)."""
        self.store.set(f"{self.key}/hb/{self.node_id}", time.time())

    def start_keepalive(self) -> threading.Event:
        """Background heartbeat thread for the worker/agent lifetime of a
        completed round (reference _PeriodicTimer keep-alive,
        dynamic_rendezvous.py:206-207). Returns the stop event; the Thread
        rides on it as ``stop.thread`` so shutdown paths can ``join()``
        after ``stop.set()`` — a beat already past its stop-check could
        otherwise re-create the hb key AFTER ``leave()`` deleted it,
        leaking a stale key for the job's lifetime on persistent stores."""
        stop = threading.Event()

        def beat():
            while not stop.is_set():
                try:
                    self.keep_alive()
                except OSError:
                    pass  # store teardown mid-beat: the TTL handles the rest
                stop.wait(self.keep_alive_interval)

        thread = threading.Thread(target=beat, daemon=True)
        thread.start()
        stop.thread = thread
        return stop

    def _drop_heartbeats(self, nodes) -> None:
        """Delete the hb keys of nodes leaving the membership — without
        this, node-id churn (fresh uuid per agent restart) grows the store
        unboundedly. A live node whose key is dropped by a racing peer is
        safe: dead_nodes falls back to its join timestamp until the next
        beat re-creates the key."""
        for node in nodes:
            try:
                self.store.delete(f"{self.key}/hb/{node}")
            except OSError:
                pass

    def dead_nodes(self, participants: Optional[Dict] = None) -> list:
        """Participants whose heartbeat exceeded the TTL (scale-down
        signal; reference _sanitize, dynamic_rendezvous.py:353)."""
        if participants is None:
            participants = self._state()["participants"]
        now = time.time()
        dead = []
        for node, join_ts in participants.items():
            if node == self.node_id:
                continue  # the scanning node is alive by definition — an
                # agent probing between rounds must never read its own
                # paused heartbeat as a scale-down event
            hb = self.store.get(f"{self.key}/hb/{node}")
            last = max(float(hb), join_ts) if hb is not None else join_ts
            if now - last > self._ttl:
                dead.append(node)
        return sorted(dead)

    def num_nodes_dead(self) -> int:
        """Scale-DOWN signal the agent polls next to num_nodes_waiting."""
        return len(self.dead_nodes())

    # -- public API (reference RendezvousHandler, elastic/rendezvous/api.py:33)
    def _wait_changed(self, last_raw, deadline: float,
                      cap: Optional[float] = None) -> None:
        """Block until the state blob differs from ``last_raw`` (notify
        path), the cap lapses (settle checks are time-based), or the
        deadline passes. Bounded by keep_alive_interval so the caller's
        heartbeat refresh in the loop head can never starve."""
        remaining = deadline - time.time()
        if remaining <= 0:
            raise TimeoutError("rendezvous did not complete")
        t = min(remaining, self.keep_alive_interval)
        if cap is not None:
            t = min(t, max(cap, 0.01))
        self.store.wait_ne(self.key, last_raw, timeout=t)

    def next_rendezvous(self, timeout: float = 30.0) -> Tuple[int, int, int]:
        """Join the current round; block until it settles.
        Returns (round, rank, world_size)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            self.keep_alive()  # every pass: this node is provably live
            if self.is_closed():
                raise RendezvousClosedError(
                    "rendezvous was closed (a peer agent gave up)")
            raw = self.store.get(self.key)
            st = raw or dict(self._EMPTY)
            if st["complete"]:
                if self.node_id in st["participants"]:
                    return self._finish(st)
                # an ABANDONED completed round (every participant's
                # heartbeat expired — e.g. a whole job died and was
                # relaunched with the same run_id on a persistent store):
                # no supervising agent is left to restart it, so the
                # arriving node tears it down itself
                ghosts = self.dead_nodes(st["participants"])
                if all(n in ghosts for n in st["participants"]):
                    self.restart_round()
                    continue
                # late arrival: park in the waiting set (scale-up signal),
                # then BLOCK on the blob until the agent restarts the round
                if self.node_id not in st["waiting"]:
                    new = dict(st, waiting={**st["waiting"],
                                            self.node_id: time.time()})
                    if not self._cas(raw, new):
                        continue
                    raw = new
                self._wait_changed(raw, deadline)
                continue
            # prune participants whose heartbeat expired BEFORE the round
            # settles (a node that died mid-join must not get a rank).
            # Rate-limited to one scan per keep-alive interval: the scan is
            # a store round-trip per participant, and wait_ne wakeups can
            # make loop passes far more frequent than heartbeats; expiry
            # persists once reached, so a bounded delay misses nothing
            if time.time() - self._last_dead_scan >= self.keep_alive_interval:
                self._last_dead_scan = time.time()
                dead = self.dead_nodes(st["participants"])
            else:
                dead = []
            if dead:
                alive = {k: v for k, v in st["participants"].items()
                         if k not in dead}
                if self._cas(raw, dict(st, participants=alive)):
                    self._drop_heartbeats(dead)
                continue
            if self.node_id not in st["participants"]:
                if len(st["participants"]) >= self.max_nodes:
                    self._wait_changed(raw, deadline)
                    continue
                new = dict(st, participants={**st["participants"],
                                             self.node_id: time.time()})
                if not self._cas(raw, new):
                    continue
                st, raw = new, new
            n = len(st["participants"])
            newest = max(st["participants"].values())
            settle_left = self.settle_s - (time.time() - newest)
            if n >= self.min_nodes and (settle_left <= 0
                                        or n >= self.max_nodes):
                # re-read so the completed state is built from the SAME value
                # used as the CAS expect — a node that CAS-joined since our
                # earlier read must be included in the completing round, not
                # silently parked in "waiting"
                fresh = self.store.get(self.key)
                fs = fresh or dict(self._EMPTY)
                if fs["complete"] or self.node_id not in fs["participants"]:
                    continue  # someone else completed / round restarted
                done = dict(fs, complete=True)
                if self._cas(fresh, done):
                    return self._finish(done)
                continue
            # below min_nodes: block until the blob changes; inside the
            # settle window: block at most until the window closes
            self._wait_changed(raw, deadline,
                               cap=None if n < self.min_nodes
                               else settle_left)
        raise TimeoutError("rendezvous did not complete")

    def _finish(self, st) -> Tuple[int, int, int]:
        ranks = sorted(st["participants"])
        return st["round"], ranks.index(self.node_id), len(ranks)

    def num_nodes_waiting(self) -> int:
        """Scale-up signal the agent polls (reference api.py:872-884)."""
        return len(self._state()["waiting"])

    def current_round(self) -> int:
        """The store's round counter. An agent that settled in round N and
        later reads current_round() != N knows a peer tore the round down
        (worker failure or membership change on that peer) and must stop
        its own workers and re-join (reference _RendezvousJoinOp observing
        the state version, dynamic_rendezvous.py:779-875)."""
        return self._state()["round"]

    def restart_round(self) -> None:
        """Tear down the round so all (running + waiting) nodes re-join —
        the agent calls this before restarting its workers on membership
        change (scale-up via num_nodes_waiting, scale-down via
        num_nodes_dead). Retries until the round counter has actually
        advanced: a single CAS can lose a benign race (e.g. a late node
        adding itself to the waiting set), and silently dropping the
        teardown would let the caller re-settle instantly into the stale
        completed round and respawn workers against a half-dead cluster."""
        first = None
        while True:
            raw = self.store.get(self.key)
            if raw is None:
                return
            if first is None:
                first = raw["round"]
            if raw["round"] > first:
                return  # a peer already tore this round down
            new = {"round": raw["round"] + 1, "participants": {},
                   "waiting": {}, "complete": False}
            if self.store.compare_and_swap(self.key, raw, new)[0]:
                # rejoining nodes re-create their hb keys on the next beat;
                # keys of nodes that never come back would otherwise leak
                self._drop_heartbeats(set(raw["participants"])
                                      | set(raw["waiting"]))
                return

    def leave(self) -> None:
        """Graceful departure after local SUCCESS: remove this node from
        the completed round's participant set and drop its heartbeat, so a
        peer whose workers are still finishing (final checkpoint/eval)
        never reads our expiring heartbeat as a scale-DOWN event and kills
        its own nearly-done workers (reference: the agent's _exit_barrier +
        rendezvous shutdown, elastic/agent/server/api.py:886)."""
        while True:
            raw = self.store.get(self.key)
            if raw is None or self.node_id not in raw.get("participants", {}):
                break
            parts = {k: v for k, v in raw["participants"].items()
                     if k != self.node_id}
            if self._cas(raw, dict(raw, participants=parts)):
                break
        self._drop_heartbeats([self.node_id])

    def set_closed(self) -> None:
        """Permanently close (reference RendezvousHandler.set_closed)."""
        self.store.set(self.key + "/closed", True)

    def is_closed(self) -> bool:
        return bool(self.store.get(self.key + "/closed"))


# ---------------------------------------------------------------------------
# file-backed store (a second backend sharing the DynamicRendezvous state
# machine — the reference's c10d-store vs etcd split,
# elastic/rendezvous/c10d_rendezvous_backend.py:33 / etcd_rendezvous.py:77)
# ---------------------------------------------------------------------------

class FileStore:
    """Same duck-typed API as :class:`TCPStore` over one JSON file guarded by
    an ``fcntl`` lock — rendezvous for co-hosted processes without a network
    server (torch FileStore equivalent)."""

    def __init__(self, path: str):
        self.path = path
        self._lock_path = path + ".lock"
        open(self._lock_path, "a").close()

    def _locked(self, fn):
        import fcntl
        with open(self._lock_path, "r+") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                if os.path.exists(self.path):
                    with open(self.path) as f:
                        kv = json.load(f)
                else:
                    kv = {}
                out, dirty = fn(kv)
                if dirty:
                    tmp = self.path + ".tmp"
                    with open(tmp, "w") as f:
                        json.dump(kv, f)
                    os.replace(tmp, self.path)
                return out
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)

    def set(self, key: str, value) -> None:
        self._locked(lambda kv: (kv.__setitem__(key, value), True))

    def get(self, key: str):
        return self._locked(lambda kv: (kv.get(key), False))

    def add(self, key: str, delta: int = 1) -> int:
        def op(kv):
            cur = int(kv.get(key, 0)) + int(delta)
            kv[key] = cur
            return cur, True
        return self._locked(op)

    def delete(self, key: str) -> bool:
        def op(kv):
            return kv.pop(key, None) is not None, True
        return self._locked(op)

    def compare_and_swap(self, key: str, expect, value):
        def op(kv):
            cur = kv.get(key)
            if cur == expect:
                kv[key] = value
                return (True, value), True
            return (False, cur), False
        return self._locked(op)

    def wait(self, key: str, timeout: float = 30.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            v = self.get(key)
            if v is not None:
                return v
            time.sleep(0.05)
        raise TimeoutError(f"store key {key!r} not set within {timeout}s")

    def wait_ne(self, key: str, not_value, timeout: float = 30.0):
        """Poll fallback (no server process to block in): same contract as
        :meth:`TCPStore.wait_ne` for co-hosted processes over one file."""
        deadline = time.time() + timeout
        while True:
            v = self.get(key)
            if v != not_value:
                return True, v
            if time.time() >= deadline:
                return False, v
            time.sleep(0.02)

    def close(self):
        pass


# ---------------------------------------------------------------------------
# handler ABC + pluggable backend registry
# (reference elastic/rendezvous/api.py:33 RendezvousHandler,
#  api.py:208 RendezvousHandlerRegistry)
# ---------------------------------------------------------------------------

class RendezvousClosedError(RuntimeError):
    """The rendezvous was permanently closed (reference api.py:13)."""


@dataclasses.dataclass
class RendezvousParameters:
    """Backend-agnostic rendezvous configuration (reference api.py:119-198).

    ``endpoint``: 'host:port' for the c10d backend, a filesystem path for
    the file backend; ``config`` carries backend-specific extras (e.g.
    ``rank``/``world_size`` for the static backend, ``is_server``/
    ``settle_s``/``node_id`` for the dynamic ones)."""

    backend: str
    endpoint: str
    run_id: str
    min_nodes: int = 1
    max_nodes: int = 1
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def get(self, key: str, default=None):
        return self.config.get(key, default)


class RendezvousHandler(abc.ABC):
    """Rendezvous interface (reference api.py:33-117): negotiate
    (rank, world_size) and hand back the store used for follow-up host
    collectives."""

    @abc.abstractmethod
    def get_backend(self) -> str: ...

    @abc.abstractmethod
    def next_rendezvous(self, timeout: float = 30.0) -> Tuple[Any, int, int]:
        """Blocks until a round settles; returns (store, rank, world_size)."""

    @abc.abstractmethod
    def is_closed(self) -> bool: ...

    @abc.abstractmethod
    def set_closed(self) -> None: ...

    @abc.abstractmethod
    def num_nodes_waiting(self) -> int: ...

    @abc.abstractmethod
    def get_run_id(self) -> str: ...

    def shutdown(self) -> bool:
        return True

    def leave(self) -> None:
        """Graceful departure (no-op for fixed-membership backends)."""


class _DynamicHandler(RendezvousHandler):
    """DynamicRendezvous state machine over any store (c10d/file backends)."""

    def __init__(self, backend: str, store, params: RendezvousParameters):
        self._backend = backend
        self.store = store
        self.run_id = params.run_id
        self._rdzv = DynamicRendezvous(
            store, params.run_id, params.min_nodes, params.max_nodes,
            settle_s=float(params.get("settle_s", 0.3)),
            node_id=params.get("node_id"),
            keep_alive_interval=float(params.get("keep_alive_interval", 5.0)),
            keep_alive_max_attempt=int(
                params.get("keep_alive_max_attempt", 3)))

    def get_backend(self) -> str:
        return self._backend

    def next_rendezvous(self, timeout: float = 30.0):
        if self.is_closed():
            raise RendezvousClosedError(self.run_id)
        rnd, rank, world = self._rdzv.next_rendezvous(timeout=timeout)
        self.last_round = rnd  # exposed so callers can round-scope store keys
        return self.store, rank, world

    def is_closed(self) -> bool:
        return self._rdzv.is_closed()

    def set_closed(self) -> None:
        self._rdzv.set_closed()

    def num_nodes_waiting(self) -> int:
        return self._rdzv.num_nodes_waiting()

    def num_nodes_dead(self) -> int:
        """Scale-down signal (participants whose heartbeat TTL expired)."""
        return self._rdzv.num_nodes_dead()

    def current_round(self) -> int:
        """Round counter in the store (see DynamicRendezvous.current_round)."""
        return self._rdzv.current_round()

    def keep_alive(self) -> None:
        self._rdzv.keep_alive()

    def start_keepalive(self):
        """Background heartbeat for the worker lifetime; returns the stop
        Event (the agent sets it on shutdown/restart)."""
        return self._rdzv.start_keepalive()

    def get_run_id(self) -> str:
        return self.run_id

    def restart_round(self) -> None:
        self._rdzv.restart_round()

    def leave(self) -> None:
        self._rdzv.leave()

    def shutdown(self) -> bool:
        self.store.close()
        return True


class _StaticHandler(RendezvousHandler):
    """Fixed-membership rendezvous: rank/world_size from config, no
    negotiation (the reference's 'static' torchrun backend)."""

    def __init__(self, store, params: RendezvousParameters):
        self.store = store
        self.params = params
        self._closed = False

    def get_backend(self) -> str:
        return "static"

    def next_rendezvous(self, timeout: float = 30.0):
        if self._closed:
            raise RendezvousClosedError(self.params.run_id)
        rank = int(self.params.get("rank", 0))
        world = int(self.params.get("world_size", self.params.max_nodes))
        return self.store, rank, world

    def is_closed(self) -> bool:
        return self._closed

    def set_closed(self) -> None:
        self._closed = True

    def num_nodes_waiting(self) -> int:
        return 0

    def get_run_id(self) -> str:
        return self.params.run_id


class RendezvousHandlerRegistry:
    """Name → creator registry (reference api.py:208-263)."""

    def __init__(self):
        self._registry: Dict[str, Callable[[RendezvousParameters],
                                           RendezvousHandler]] = {}

    def register(self, backend: str, creator) -> None:
        if not backend:
            raise ValueError("backend name must be non-empty")
        cur = self._registry.get(backend)
        if cur is not None and cur is not creator:
            raise ValueError(
                f"backend '{backend}' already registered with {cur!r}")
        self._registry[backend] = creator

    def create_handler(self, params: RendezvousParameters) -> RendezvousHandler:
        try:
            creator = self._registry[params.backend]
        except KeyError:
            raise ValueError(
                f"rendezvous backend '{params.backend}' is not registered; "
                f"have {sorted(self._registry)}")
        handler = creator(params)
        if handler.get_backend() != params.backend:
            raise RuntimeError(
                f"handler backend '{handler.get_backend()}' does not match "
                f"requested '{params.backend}'")
        return handler


def _parse_hostport(endpoint: str, backend: str) -> Tuple[str, int]:
    host, _, port = endpoint.rpartition(":")
    try:
        return host or "127.0.0.1", int(port)
    except ValueError:
        raise ValueError(
            f"the '{backend}' rendezvous backend needs --rdzv_endpoint "
            f"HOST:PORT; got {endpoint!r}")


def _as_bool(v) -> bool:
    """Config values can arrive as strings via --rdzv_conf; bool("0") is
    True, so coerce explicitly."""
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes", "on")


def _create_c10d(params: RendezvousParameters) -> RendezvousHandler:
    host, port = _parse_hostport(params.endpoint, "c10d")
    is_server = params.get("is_server", "auto")
    if is_server == "auto":
        # torchrun-style server election without pre-assigned node ranks:
        # try to bind the endpoint — EADDRNOTAVAIL (host is another machine)
        # or EADDRINUSE (a co-hosted launcher already serves) both mean
        # "be a client". Exactly one launcher wins the bind.
        try:
            store = TCPStore(host, port, is_server=True)
        except OSError:
            store = TCPStore(host, port, is_server=False)
    else:
        store = TCPStore(host, port, is_server=_as_bool(is_server))
    return _DynamicHandler("c10d", store, params)


def _create_file(params: RendezvousParameters) -> RendezvousHandler:
    if not params.endpoint:
        raise ValueError("the 'file' rendezvous backend needs "
                         "--rdzv_endpoint PATH (a shared filesystem path)")
    return _DynamicHandler("file", FileStore(params.endpoint), params)


def _create_etcd(params: RendezvousParameters) -> RendezvousHandler:
    """etcd backend (reference elastic/rendezvous/etcd_rendezvous.py:77,
    etcd_store.py:26): the same DynamicRendezvous state machine over an
    etcd v3 HTTP/JSON gateway at --rdzv_endpoint HOST:PORT
    (parallel/etcd.EtcdStore; parallel/etcd.EtcdServer is the bundled
    in-process dev server, like the reference's etcd_server.py:77)."""
    from editor_tpu_torch.parallel.etcd import EtcdStore
    host, port = _parse_hostport(params.endpoint, "etcd")
    store = EtcdStore(f"{host}:{port}",
                      prefix=str(params.get("prefix", "/editor_tpu/")))
    return _DynamicHandler("etcd", store, params)


def _create_static(params: RendezvousParameters) -> RendezvousHandler:
    store = None
    if ":" in params.endpoint:
        host, port = _parse_hostport(params.endpoint, "static")
        store = TCPStore(host, port,
                         is_server=int(params.get("rank", 0)) == 0)
    return _StaticHandler(store, params)


rendezvous_registry = RendezvousHandlerRegistry()
rendezvous_registry.register("c10d", _create_c10d)
rendezvous_registry.register("file", _create_file)
rendezvous_registry.register("etcd", _create_etcd)
rendezvous_registry.register("static", _create_static)


# ---------------------------------------------------------------------------
# host-side control-plane collectives over the store
# ---------------------------------------------------------------------------

class StragglerError(TimeoutError):
    """Raised by monitored_barrier naming the ranks that never arrived."""

    def __init__(self, missing):
        self.missing = sorted(missing)
        super().__init__(f"ranks {self.missing} did not reach the barrier")


def monitored_barrier(store: TCPStore, name: str, rank: int, world_size: int,
                      timeout: float = 30.0, gen: int = 0) -> None:
    """Barrier that NAMES the straggler ranks on timeout (reference
    ``monitored_barrier``, distributed_c10d.py:2742-2805 — its point over a
    plain barrier is the diagnostic). Every rank registers arrival under
    ``barrier/{gen}/{name}/{rank}``; each rank then waits for all others and
    raises :class:`StragglerError` listing whoever is missing.

    ``gen`` scopes the keys to a rendezvous round/generation: pass the
    current round so a name reused after an elastic restart never matches
    stale arrivals from the previous incarnation."""
    store.set(f"barrier/{gen}/{name}/{rank}", True)
    deadline = time.time() + timeout
    missing = set(range(world_size)) - {rank}
    while missing and time.time() < deadline:
        for r in list(missing):
            if store.get(f"barrier/{gen}/{name}/{r}"):
                missing.discard(r)
        if missing:
            time.sleep(0.05)
    if missing:
        raise StragglerError(missing)


def all_gather_object(store: TCPStore, name: str, rank: int, world_size: int,
                      obj, timeout: float = 30.0, gen: int = 0) -> list:
    """Object all-gather over the store (reference's pickle-to-tensor object
    collectives, distributed_c10d.py:1519-1940; used by the reference's DDP
    sampler for its shared seed, sampler_ddp.py:64-109). Values must be
    JSON-serializable — this is a host control-plane primitive, not a
    tensor path. ``gen`` scopes keys to a rendezvous round (see
    :func:`monitored_barrier`)."""
    store.set(f"gather/{gen}/{name}/{rank}", obj)
    out = []
    for r in range(world_size):
        out.append(store.wait(f"gather/{gen}/{name}/{r}", timeout=timeout))
    return out


def broadcast_object(store: TCPStore, name: str, rank: int, obj=None,
                     src: int = 0, timeout: float = 30.0, gen: int = 0):
    """Object broadcast from ``src`` (reference broadcast_object_list).
    ``gen`` scopes the key to a rendezvous round (see
    :func:`monitored_barrier`)."""
    if rank == src:
        store.set(f"bcast/{gen}/{name}", obj)
        return obj
    return store.wait(f"bcast/{gen}/{name}", timeout=timeout)
