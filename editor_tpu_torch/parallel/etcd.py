"""etcd rendezvous backend: v3 HTTP/JSON gateway store + in-process server.

reference: distributed/elastic/rendezvous/etcd_rendezvous.py:77,197 (the
etcd rendezvous), etcd_store.py:26 (Store over etcd), etcd_server.py:77
(the dev-server harness its tests spin up). Counterpart of
``editor_tpu/parallel/etcd.py``, stdlib only.

Role: the DynamicRendezvous join/settle/heartbeat state machine
(parallel/rendezvous.py) is backend-agnostic over a duck-typed store —
this module supplies that store over an etcd cluster's v3 HTTP/JSON
gateway, using the minimal subset kv/put, kv/range, kv/txn (value/CREATE
compare-and-swap — the primitive the whole CAS-blob protocol rides) and
kv/deleterange. Waits are short-poll reads (the gateway's watch API is a
streaming endpoint; the rendezvous protocol only needs the CAS atomicity
from the backend — parked-node wakeup latency is a poll interval).

:class:`EtcdServer` is an in-process implementation of the same gateway
subset (ThreadingHTTPServer + revision-tracked dict), so tests and dev
runs need no etcd binary — the same move as the reference's bundled dev
server (etcd_server.py:77).
"""

from __future__ import annotations

import base64
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class EtcdStore:
    """TCPStore-compatible store over an etcd v3 HTTP/JSON gateway
    (reference EtcdStore, elastic/rendezvous/etcd_store.py:26). Values are
    JSON-encoded then base64'd (the gateway's bytes transport)."""

    def __init__(self, endpoint: str, prefix: str = "/editor_tpu/",
                 timeout: float = 10.0):
        self.base = f"http://{endpoint}/v3"
        self.prefix = prefix
        self.timeout = timeout

    # -- wire helpers --------------------------------------------------------
    def _post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def _k(self, key: str) -> str:
        return base64.b64encode((self.prefix + key).encode()).decode()

    def _v(self, value) -> str:
        return base64.b64encode(json.dumps(value).encode()).decode()

    @staticmethod
    def _decode(kvs) -> Optional[object]:
        if not kvs:
            return None
        return json.loads(base64.b64decode(kvs[0]["value"]))

    # -- store API (duck-typed with parallel.rendezvous.TCPStore) ------------
    def set(self, key: str, value) -> None:
        self._post("/kv/put", {"key": self._k(key), "value": self._v(value)})

    def get(self, key: str):
        r = self._post("/kv/range", {"key": self._k(key)})
        return self._decode(r.get("kvs"))

    def compare_and_swap(self, key: str, expect, value):
        """Atomic CAS via kv/txn: expect None compares CREATE revision 0
        (key must not exist); otherwise compares the serialized VALUE."""
        if expect is None:
            cmp = {"target": "CREATE", "key": self._k(key),
                   "create_revision": "0", "result": "EQUAL"}
        else:
            cmp = {"target": "VALUE", "key": self._k(key),
                   "value": self._v(expect), "result": "EQUAL"}
        r = self._post("/kv/txn", {
            "compare": [cmp],
            "success": [{"requestPut": {"key": self._k(key),
                                        "value": self._v(value)}}],
            "failure": [{"requestRange": {"key": self._k(key)}}],
        })
        if r.get("succeeded"):
            return True, value
        responses = r.get("responses") or []
        kvs = (responses[0].get("responseRange", {}).get("kvs")
               if responses else None)
        return False, self._decode(kvs)

    def add(self, key: str, delta: int = 1) -> int:
        while True:
            cur = self.get(key)
            new = int(cur or 0) + int(delta)
            ok, _ = self.compare_and_swap(key, cur, new)
            if ok:
                return new

    def delete(self, key: str) -> bool:
        r = self._post("/kv/deleterange", {"key": self._k(key)})
        return int(r.get("deleted", 0)) > 0

    # Poll pacing for the blocking waits: start fast (a settle handoff is
    # usually sub-second) and back off toward _POLL_MAX so a node parked for
    # a long join window costs ~1 request/s against the gateway instead of
    # the 20/s a fixed 50 ms poll would (the TCPStore backend blocks on a
    # server-side condition variable; the v3 JSON gateway's watch endpoint
    # is streaming and out of this subset's scope, so paced polling it is).
    _POLL_MIN = 0.05
    _POLL_MAX = 1.0

    def wait(self, key: str, timeout: float = 30.0):
        # do/while shape (like wait_ne): a get() follows EVERY sleep, so a
        # key published during the final backoff window (up to _POLL_MAX)
        # is still observed instead of raising a spurious TimeoutError
        deadline = time.time() + timeout
        pause = self._POLL_MIN
        while True:
            v = self.get(key)
            if v is not None:
                return v
            if time.time() >= deadline:
                raise TimeoutError(
                    f"store key {key!r} not set within {timeout}s")
            time.sleep(min(pause, max(deadline - time.time(), 0.0)))
            pause = min(pause * 1.6, self._POLL_MAX)

    def wait_ne(self, key: str, not_value, timeout: float = 30.0):
        """Paced-poll read (same contract as TCPStore.wait_ne)."""
        deadline = time.time() + timeout
        pause = self._POLL_MIN
        while True:
            v = self.get(key)
            if v != not_value:
                return True, v
            if time.time() >= deadline:
                return False, v
            time.sleep(min(pause, max(deadline - time.time(), 0.0)))
            pause = min(pause * 1.6, self._POLL_MAX)

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# in-process gateway-subset server (reference etcd_server.py:77 dev harness)
# ---------------------------------------------------------------------------

class _EtcdHandler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # silence request logging
        pass

    def _reply(self, obj: dict) -> None:
        data = json.dumps(obj).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", "0"))
        body = json.loads(self.rfile.read(n) or b"{}")
        srv = self.server  # type: ignore[assignment]
        with srv.lock:  # type: ignore[attr-defined]
            if self.path.endswith("/kv/put"):
                self._reply(srv.put(body))
            elif self.path.endswith("/kv/range"):
                self._reply(srv.range(body))
            elif self.path.endswith("/kv/deleterange"):
                self._reply(srv.deleterange(body))
            elif self.path.endswith("/kv/txn"):
                self._reply(srv.txn(body))
            else:
                self.send_response(404)
                self.end_headers()


class EtcdServer(ThreadingHTTPServer):
    """Minimal etcd v3 JSON-gateway kv server: revision-tracked dict behind
    one lock (every txn is atomic, like a single-member etcd). Start with
    port=0 to bind an ephemeral port; ``endpoint`` is what EtcdStore (and
    --rdzv_endpoint) takes."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        super().__init__((host, port), _EtcdHandler)
        self.lock = threading.RLock()
        self.kv = {}          # key(b64 str) -> {"value","create_revision"}
        self.rev = 0
        threading.Thread(target=self.serve_forever, daemon=True).start()

    @property
    def endpoint(self) -> str:
        return f"{self.server_address[0]}:{self.server_address[1]}"

    def stop(self) -> None:
        self.shutdown()

    # -- kv ops (called under self.lock) --------------------------------------
    def put(self, body: dict) -> dict:
        self.rev += 1
        k = body["key"]
        prev = self.kv.get(k)
        self.kv[k] = {"value": body["value"],
                      "create_revision": (prev["create_revision"] if prev
                                          else self.rev),
                      "mod_revision": self.rev}
        return {"header": {"revision": str(self.rev)}}

    def range(self, body: dict) -> dict:
        e = self.kv.get(body["key"])
        if e is None:
            return {"header": {"revision": str(self.rev)}}
        kv = {"key": body["key"], "value": e["value"],
              "create_revision": str(e["create_revision"]),
              "mod_revision": str(e["mod_revision"])}
        return {"header": {"revision": str(self.rev)}, "kvs": [kv],
                "count": "1"}

    def deleterange(self, body: dict) -> dict:
        self.rev += 1
        existed = self.kv.pop(body["key"], None) is not None
        return {"header": {"revision": str(self.rev)},
                "deleted": "1" if existed else "0"}

    def _compare(self, c: dict) -> bool:
        e = self.kv.get(c["key"])
        target = c.get("target", "VALUE")
        if target == "CREATE":
            want = int(c.get("create_revision", 0))
            have = e["create_revision"] if e else 0
            return have == want
        if target == "VALUE":
            return e is not None and e["value"] == c.get("value")
        raise ValueError(f"unsupported compare target {target!r}")

    def txn(self, body: dict) -> dict:
        ok = all(self._compare(c) for c in body.get("compare", []))
        ops = body.get("success" if ok else "failure", [])
        responses = []
        for op in ops:
            if "requestPut" in op:
                responses.append({"responsePut": self.put(op["requestPut"])})
            elif "requestRange" in op:
                responses.append(
                    {"responseRange": self.range(op["requestRange"])})
            else:
                raise ValueError(f"unsupported txn op {sorted(op)}")
        return {"header": {"revision": str(self.rev)}, "succeeded": ok,
                "responses": responses}
