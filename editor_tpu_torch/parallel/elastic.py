"""Elastic supervisor: failure detection, bounded restarts, watchdog, error
propagation.

reference: distributed/elastic/ — SimpleElasticAgent's monitor/restart state
machine (agent/server/api.py:451,827-884: on FAILED/UNHEALTHY restart the
whole worker group while max_restarts remain), the watchdog timer that
SIGKILLs stuck workers (timer/local_timer.py:72-123), the ``record``
decorator + JSON error files (multiprocessing/errors/error_handler.py:39),
and structured events (events/api.py:28).

Counterpart of ``editor_tpu/parallel/elastic.py``, stdlib only. Workers
are processes of one ``torch.distributed`` group each (one a device); on
restart they resume from the latest full-state checkpoint
(``utils/checkpoint.py``, the training loop's auto-resume):
checkpoint-restart elasticity instead of in-flight re-negotiation. A
restarted group re-runs ``multihost.initialize`` with the new
``WORLD_SIZE``, so membership changes (scale up/down) come with it.

Each worker gets torchrun's environment: ``RANK`` (``NODE_RANK *
NPROC_PER_NODE + LOCAL_RANK`` when the launcher gives a node rank),
``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, plus ``NODE_RANK``, ``NPROC_PER_NODE`` and the
supervisor's ``EDITOR_TPU_ERROR_FILE``, ``EDITOR_TPU_HEARTBEAT_FILE`` and
``EDITOR_TPU_RESTART_COUNT``. ``MASTER_PORT`` 0 takes a free port anew for
each incarnation, so that a restarted group never meets a socket its
predecessor left behind. A dead worker's NCCL peers would wait out their
group's timeout; the supervisor stops the whole group within one monitor
tick instead (terminate, then kill after 5 s).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import json
import os
import socket
import subprocess
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional


class WorkerState(enum.Enum):
    # reference: elastic/agent/server/api.py WorkerState
    INIT = "INIT"
    HEALTHY = "HEALTHY"
    UNHEALTHY = "UNHEALTHY"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"


class RoundOutcome(enum.Enum):
    """Result of one supervised worker round (reference RunResult,
    elastic/agent/server/api.py:427-449 + the membership branch of
    _invoke_run api.py:872-884)."""
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    MEMBERSHIP_CHANGED = "MEMBERSHIP_CHANGED"


@dataclasses.dataclass
class WorkerSpec:
    """reference: elastic/agent/server/api.py:43 (WorkerSpec)."""
    argv: List[str]                  # worker command line
    nproc: int = 1
    max_restarts: int = 3
    monitor_interval: float = 0.5
    heartbeat_timeout: Optional[float] = None  # watchdog (None = disabled)
    env: Optional[Dict[str, str]] = None
    error_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "editor_tpu_elastic"))


@dataclasses.dataclass
class ProcessFailure:
    """reference: multiprocessing/errors/__init__.py:79."""
    local_rank: int
    exitcode: int
    error_file: Optional[str]
    message: str


class ChildFailedError(RuntimeError):
    def __init__(self, failures: List[ProcessFailure]):
        self.failures = failures
        super().__init__(
            "; ".join(f"rank {f.local_rank} exit {f.exitcode}: {f.message}"
                      for f in failures))


def record(fn: Callable) -> Callable:
    """Worker-entrypoint decorator writing a JSON error file on crash
    (reference error_handler.py:39 record semantics). The file path comes
    from TORCHELASTIC-style env var ``EDITOR_TPU_ERROR_FILE``."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001
            write_error_file(e)
            raise

    return wrapper


def write_error_file(e: BaseException) -> None:
    """Write the structured JSON error file the supervisor surfaces in
    ProcessFailure, to the TORCHELASTIC-style ``EDITOR_TPU_ERROR_FILE``
    path (no-op when the env var is unset)."""
    path = os.environ.get("EDITOR_TPU_ERROR_FILE")
    if not path:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({
            "message": str(e),
            "exc_type": type(e).__name__,
            "traceback": "".join(traceback.format_exception(e)),
            "timestamp": time.time(),
        }, f)


def heartbeat(path: Optional[str] = None):
    """Workers call this periodically; the supervisor's watchdog reaps
    workers whose heartbeat goes stale (local_timer.py expiring-timer
    equivalent)."""
    path = path or os.environ.get("EDITOR_TPU_HEARTBEAT_FILE")
    if path:
        with open(path, "w") as f:
            f.write(str(time.time()))


def free_port() -> int:
    """A TCP port that was free a moment ago (the OS's choice)."""
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class _Worker:
    local_rank: int
    proc: subprocess.Popen
    error_file: str
    heartbeat_file: str
    started: float


class ElasticSupervisor:
    """SimpleElasticAgent equivalent (api.py:451): start N workers, monitor,
    restart-all on failure while budget remains, reap hung workers."""

    def __init__(self, spec: WorkerSpec,
                 event_log: Optional[Callable[[Dict[str, Any]], None]] = None,
                 membership_check: Optional[Callable[[], Optional[str]]] = None,
                 membership_interval: float = 5.0,
                 restart_count: int = 0):
        """``membership_check`` (multi-node agents only): called every
        ``membership_interval`` seconds while workers are HEALTHY; returning
        a non-None reason string ("round_restarted"/"scale_up"/"scale_down")
        stops the worker group and ends the round with MEMBERSHIP_CHANGED —
        the reference agent's num_nodes_waiting branch (api.py:872-884).
        ``restart_count`` seeds the incarnation counter (the node-level
        launcher creates one supervisor per rendezvous round but workers
        must see a monotonically increasing EDITOR_TPU_RESTART_COUNT)."""
        self.spec = spec
        self.remaining_restarts = spec.max_restarts
        self.restart_count = restart_count
        self.events: List[Dict[str, Any]] = []
        self._event_log = event_log
        self._membership_check = membership_check
        self._membership_interval = membership_interval
        self.workers: List[_Worker] = []

    def _event(self, name: str, **kw):
        rec = {"event": name, "ts": time.time(), **kw}
        self.events.append(rec)
        if self._event_log:
            self._event_log(rec)

    # -- lifecycle ---------------------------------------------------------

    def _start_workers(self):
        # per-supervisor namespace: co-hosted node launchers often share an
        # --error_dir (default /tmp/...), and colliding hb files would let
        # node B's live worker mask node A's hung one from the watchdog
        nspace = os.path.join(self.spec.error_dir, f"agent_{os.getpid()}")
        os.makedirs(nspace, exist_ok=True)
        self.workers = []
        group = dict(self.spec.env or {})
        if group.get("MASTER_PORT") == "0":
            group["MASTER_PORT"] = str(free_port())
        for rank in range(self.spec.nproc):
            err = os.path.join(nspace,
                               f"error_{self.restart_count}_{rank}.json")
            hb = os.path.join(nspace,
                              f"hb_{self.restart_count}_{rank}")
            env = dict(os.environ, **group)
            env["EDITOR_TPU_ERROR_FILE"] = err
            env["EDITOR_TPU_HEARTBEAT_FILE"] = hb
            env["LOCAL_RANK"] = str(rank)
            env["LOCAL_WORLD_SIZE"] = str(self.spec.nproc)
            if "NODE_RANK" in group:  # torchrun's global rank
                env["RANK"] = str(int(group["NODE_RANK"])
                                  * int(group.get("NPROC_PER_NODE", self.spec.nproc)) + rank)
            env["EDITOR_TPU_RESTART_COUNT"] = str(self.restart_count)
            proc = subprocess.Popen(self.spec.argv, env=env)
            self.workers.append(_Worker(rank, proc, err, hb, time.time()))
        self._event("workers_started", count=self.spec.nproc,
                    restart=self.restart_count)

    def _stop_workers(self):
        for w in self.workers:
            if w.proc.poll() is None:
                w.proc.terminate()
        deadline = time.time() + 5
        for w in self.workers:
            try:
                w.proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                w.proc.kill()  # SIGKILL (reference _reap_worker)
                w.proc.wait()

    def _watchdog_check(self):
        if self.spec.heartbeat_timeout is None:
            return
        now = time.time()
        for w in self.workers:
            if w.proc.poll() is not None:
                continue
            try:
                last = float(open(w.heartbeat_file).read().strip())
            except (OSError, ValueError):
                last = w.started
            if now - last > self.spec.heartbeat_timeout:
                self._event("watchdog_kill", rank=w.local_rank,
                            stale_s=now - last)
                w.proc.kill()  # reference local_timer.py:113 _reap_worker

    def _monitor(self) -> WorkerState:
        self._watchdog_check()
        codes = [w.proc.poll() for w in self.workers]
        if any(c is not None and c != 0 for c in codes):
            return WorkerState.FAILED
        if all(c == 0 for c in codes):
            return WorkerState.SUCCEEDED
        return WorkerState.HEALTHY

    def _failures(self) -> List[ProcessFailure]:
        out = []
        for w in self.workers:
            code = w.proc.poll()
            if code in (None, 0):
                continue
            msg = f"process exited with code {code}"
            if os.path.exists(w.error_file):
                try:
                    data = json.load(open(w.error_file))
                    msg = f"{data.get('exc_type')}: {data.get('message')}"
                except (OSError, json.JSONDecodeError):
                    pass
            out.append(ProcessFailure(w.local_rank, code, w.error_file, msg))
        return out

    def run_round(self) -> tuple:
        """Supervise ONE incarnation of the worker group to a terminal
        outcome (reference _monitor_workers + the HEALTHY membership branch,
        api.py:844-884). Returns ``(RoundOutcome, failures, reason)``;
        workers are already stopped on FAILED/MEMBERSHIP_CHANGED — restart
        policy (budget, re-rendezvous) belongs to the caller. Any exception
        escaping the monitor loop (e.g. a membership probe crashing) also
        stops the workers first — a dead supervisor must never orphan a
        running worker group."""
        self._start_workers()
        try:
            return self._monitor_round()
        except BaseException:
            self._stop_workers()
            raise

    def _monitor_round(self) -> tuple:
        last_member_check = time.time()
        while True:
            time.sleep(self.spec.monitor_interval)
            state = self._monitor()
            if state == WorkerState.SUCCEEDED:
                self._event("succeeded", restarts_used=self.restart_count)
                return RoundOutcome.SUCCEEDED, [], None
            if state == WorkerState.FAILED:
                failures = self._failures()
                self._event("worker_failed",
                            failures=[dataclasses.asdict(f) for f in failures])
                self._stop_workers()
                return RoundOutcome.FAILED, failures, None
            if (self._membership_check is not None
                    and time.time() - last_member_check
                    >= self._membership_interval):
                last_member_check = time.time()
                reason = self._membership_check()
                if reason:
                    self._event("membership_changed", reason=reason)
                    self._stop_workers()
                    return RoundOutcome.MEMBERSHIP_CHANGED, [], reason

    def run(self) -> int:
        """Single-node monitor loop with internal restart-all (reference
        _invoke_run, api.py:827-884). Returns the number of restarts used;
        raises ChildFailedError when the budget is exhausted. Multi-node
        launchers drive :meth:`run_round` directly instead so a failure can
        re-enter the rendezvous (cli/launch.py)."""
        while True:
            outcome, failures, _ = self.run_round()
            if outcome == RoundOutcome.SUCCEEDED:
                return self.restart_count
            if outcome == RoundOutcome.MEMBERSHIP_CHANGED:
                raise RuntimeError(
                    "membership change without a rendezvous-driving launcher")
            if self.remaining_restarts > 0:
                self.remaining_restarts -= 1
                self.restart_count += 1
                self._event("restarting", remaining=self.remaining_restarts)
            else:
                self._event("gave_up")
                raise ChildFailedError(failures or [ProcessFailure(
                    -1, -1, None, "workers failed with no error files")])
