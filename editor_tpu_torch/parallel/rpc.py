"""Host-side RPC control plane on ``torch.distributed.rpc``: counterpart of
``editor_tpu/parallel/rpc.py`` (reference: distributed/rpc/ (init_rpc,
rpc_sync, rpc_async, remote, shutdown), nn/api/remote_module.py,
optim/optimizer.py (DistributedOptimizer)).

The surface is the JAX module's: sync and async calls by worker name or
rank, owner-side references (:class:`RRef`: the value stays on its owner,
``to_here`` fetches it through up to 3 retries, ``rpc_sync_method`` replaces
it), :class:`RemoteModule`, a :class:`DistributedOptimizer` that steps the
owners' update functions under one barrier, a server-global profiler of the
calls a process serves, and client-side fault injection (the first sends of
a kind dropped with :class:`FaultyRPCError`, or delayed) with JAX's counters.
A failure inside the called function raises ``RuntimeError('remote raised:
...')`` at the caller, as in JAX.

Transport: the TensorPipe agent of ``torch.distributed.rpc``, its
rendezvous through a TCP store at ``master_addr:master_port`` (rank 0 holds
it). Arguments and results cross as CPU tensors, numpy arrays or plain
Python values (no device maps): a module whose parameters live on a card
returns CPU results. Trusted-cluster use only, as with the reference's
agent: the messages are pickles.

The one difference from the JAX package: torch's RPC pickler sends a
function by reference (its module and name), where JAX's sends closures by
value with cloudpickle. So every function handed to these calls must be
importable by name on the callee: a module-level function, a method of a
module-level class, or a ``functools.partial`` of one. A lambda or a
closure raises ``TypeError`` saying so before anything is sent. The owner
side of ``rpc_sync_method``, ``RemoteModule.forward`` and ``remote`` are this
module's own functions, which take the reference's key and the user's
function as arguments.
"""

from __future__ import annotations

import concurrent.futures
import functools
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional, Tuple

import torch.distributed.rpc as _rpc

_STATE: Dict[str, Any] = {}
_OBJECTS: Dict[str, Any] = {}  # the values this process owns, by RRef key
_PROFILE: Dict[str, Any] = {"events": None}  # the open server-global profile
_LOCK = threading.Lock()
CALL_TIMEOUT_S = 60.0  # each call's deadline (JAX's socket timeout)


class FaultyRPCError(ConnectionError):
    """Raised when fault injection drops an outgoing message."""


def _by_reference(fn: Callable, what: str) -> Callable:
    """``fn`` if torch's RPC pickler can send it (by its module and name),
    else TypeError."""
    inner = fn
    while isinstance(inner, functools.partial):
        inner = inner.func
    if not callable(inner):
        raise TypeError(f"{what}: {fn!r} is not callable")
    qual = getattr(inner, "__qualname__", "")
    if "<lambda>" in qual or "<locals>" in qual:
        raise TypeError(
            f"{what}: {qual} is a lambda or a closure; torch.distributed.rpc sends a "
            "function by reference, so pass a module-level function (or a partial of "
            "one) that the callee can import")
    return fn


class _Failure:
    """A call's exception, carried back to the caller as a value."""

    def __init__(self, error: str):
        self.error = error


def _owner_call(fn: Callable, args: tuple, kwargs: dict, store_as: Optional[str] = None):
    """The callee's side of every call: run ``fn``, record it in an open
    profile, keep the result under ``store_as`` (``remote``) or return it."""
    t0 = time.perf_counter()
    try:
        result = fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - the caller raises it
        return _Failure(repr(e))
    with _LOCK:
        if _PROFILE["events"] is not None:
            _PROFILE["events"].append({
                "name": getattr(fn, "__qualname__", getattr(fn, "__name__", "<fn>")),
                "duration_s": time.perf_counter() - t0,
                "thread": threading.get_ident(),
            })
    if store_as is not None:
        _OBJECTS[store_as] = result
        return None
    return result


def _fetch(key: str):
    return _OBJECTS.get(key)


def _apply_method(key: str, fn: Callable, args: tuple, kwargs: dict) -> None:
    """The owner's side of :meth:`RRef.rpc_sync_method`."""
    _OBJECTS[key] = fn(_OBJECTS[key], *args, **kwargs)


def _run_module(key: str, fn: Callable, args: tuple, kwargs: dict):
    """The owner's side of :meth:`RemoteModule.forward`."""
    return fn(_OBJECTS[key], *args, **kwargs)


def init_rpc(name: str, rank: int, world_size: int, master_addr: str = "127.0.0.1",
             master_port: int = 29631, timeout: float = 30.0) -> None:
    """Join the RPC group of ``world_size`` workers as ``name`` / ``rank``
    (rank 0 holds the rendezvous store at ``master_addr:master_port``);
    ``TimeoutError`` if the group is not whole within ``timeout`` seconds."""
    opts = _rpc.TensorPipeRpcBackendOptions(
        init_method=f"tcp://{master_addr}:{master_port}", rpc_timeout=timeout)
    done: Dict[str, Any] = {}

    def join():
        try:
            _rpc.init_rpc(name, rank=rank, world_size=world_size, rpc_backend_options=opts)
            done["ok"] = True
        except BaseException as e:  # noqa: BLE001 - raised in the caller's thread
            done["error"] = e

    t = threading.Thread(target=join, daemon=True)
    t.start()
    t.join(timeout)
    if "error" in done:
        raise done["error"]
    if "ok" not in done:
        raise TimeoutError(f"rpc rendezvous at {master_addr}:{master_port} incomplete "
                           f"after {timeout} s ({world_size} workers)")
    _STATE.update(name=name, rank=rank, world_size=world_size,
                  pool=concurrent.futures.ThreadPoolExecutor(max_workers=8))


def enable_fault_injection(messages_to_fail: Tuple[str, ...] = ("call",),
                           messages_to_delay: Optional[Dict[str, float]] = None,
                           num_fail_sends: int = 1) -> None:
    """Test-only fault injection on this client (the reference's faulty
    agent): the first ``num_fail_sends`` sends of each kind in
    ``messages_to_fail`` ('call': calls, ``remote`` and methods; 'fetch':
    ``RRef.to_here``) raise :class:`FaultyRPCError`; kinds in
    ``messages_to_delay`` wait the given seconds before they are sent."""
    _STATE["faults"] = {"fail": {k: num_fail_sends for k in messages_to_fail},
                        "delay": dict(messages_to_delay or {})}


def disable_fault_injection() -> None:
    _STATE.pop("faults", None)


def _maybe_inject_fault(kind: str) -> None:
    faults = _STATE.get("faults")
    if not faults:
        return
    delay = faults["delay"].get(kind)
    if delay:
        time.sleep(delay)
    remaining = faults["fail"].get(kind, 0)
    if remaining > 0:
        faults["fail"][kind] = remaining - 1
        raise FaultyRPCError(f"injected drop of '{kind}' message "
                             f"({remaining - 1} drops remaining)")


def _send(to, kind: str, fn: Callable, args: tuple, retries: int = 0):
    """One request and its reply; ``retries`` re-sends after a dropped
    message (fetches are retried, user calls are not, as in the reference)."""
    attempt = 0
    while True:
        try:
            _maybe_inject_fault(kind)
            reply = _rpc.rpc_sync(to, fn, args, timeout=CALL_TIMEOUT_S)
            break
        except ConnectionError:
            if attempt >= retries:
                raise
            attempt += 1
            time.sleep(0.05 * attempt)
    if isinstance(reply, _Failure):
        raise RuntimeError(f"remote raised: {reply.error}")
    return reply


def rpc_sync(to, fn: Callable, args: tuple = (), kwargs: Optional[dict] = None):
    """``fn(*args, **kwargs)`` on worker ``to`` (a name or a rank)."""
    return _send(to, "call", _owner_call,
                 (_by_reference(fn, "rpc_sync"), tuple(args), kwargs or {}))


def rpc_async(to, fn: Callable, args: tuple = (), kwargs: Optional[dict] = None):
    """:func:`rpc_sync` in a thread: a ``concurrent.futures.Future``
    (``.result(timeout)``)."""
    _by_reference(fn, "rpc_async")
    return _STATE["pool"].submit(rpc_sync, to, fn, args, kwargs)


class RRef:
    """A reference to a value that lives on its owner."""

    def __init__(self, owner, key: str):
        self.owner = owner
        self.key = key

    def to_here(self):
        """The value, fetched from the owner (retried through up to 3
        dropped messages)."""
        return _send(self.owner, "fetch", _fetch, (self.key,), retries=3)

    def rpc_sync_method(self, fn: Callable, *args, **kwargs):
        """Replace the owner's value by ``fn(value, *args, **kwargs)``, run on
        the owner."""
        _by_reference(fn, "RRef.rpc_sync_method")
        return rpc_sync(self.owner, _apply_method, (self.key, fn, args, kwargs))


def remote(to, fn: Callable, args: tuple = (), kwargs: Optional[dict] = None) -> RRef:
    """Run ``fn(*args, **kwargs)`` on ``to`` and keep the result there."""
    key = f"rref-{uuid.uuid4().hex}"
    _send(to, "call", _owner_call,
          (_by_reference(fn, "remote"), tuple(args), kwargs or {}, key))
    return RRef(to, key)


class server_process_global_profile:
    """Profile every call this process serves, on all its threads: a context
    manager; ``events()`` gives each call's {'name', 'duration_s',
    'thread'}, ``key_averages()`` {name: {'count', 'total_s', 'mean_s'}}."""

    def __enter__(self):
        with _LOCK:
            _PROFILE["events"] = []
        return self

    def __exit__(self, *exc):
        with _LOCK:
            self._events = list(_PROFILE["events"] or [])
            _PROFILE["events"] = None
        return False

    def events(self):
        return list(self._events)

    def key_averages(self):
        agg: Dict[str, Dict[str, float]] = {}
        for e in self._events:
            a = agg.setdefault(e["name"], {"count": 0, "total_s": 0.0})
            a["count"] += 1
            a["total_s"] += e["duration_s"]
        for a in agg.values():
            a["mean_s"] = a["total_s"] / a["count"]
        return agg


def shutdown() -> None:
    """Leave the group: torch's graceful shutdown, which waits until every
    worker has called it and the outstanding calls are done."""
    pool = _STATE.pop("pool", None)
    if pool is not None:
        pool.shutdown(wait=True)
    if "name" in _STATE:
        _rpc.shutdown()
        _STATE.clear()
    _OBJECTS.clear()


class RemoteModule:
    """A (params, apply_fn) pair living on worker ``on``; forward by RPC.
    ``init_fn()`` makes the params on the owner (on its card, if it puts
    them there); ``apply_fn(params, *args)`` runs there."""

    def __init__(self, on, init_fn: Callable, apply_fn: Callable):
        self.on = on
        self.apply_fn = _by_reference(apply_fn, "RemoteModule apply_fn")
        self.params_rref = remote(on, init_fn)

    def forward(self, *args, **kwargs):
        return rpc_sync(self.on, _run_module, (self.params_rref.key, self.apply_fn, args, kwargs))

    __call__ = forward


class DistributedOptimizer:
    """Steps each owner's params by ``update_fn(params, *step_args)`` on the
    owner, all RRefs at once, returning when every one is done."""

    def __init__(self, update_fn: Callable, param_rrefs):
        self.update_fn = _by_reference(update_fn, "DistributedOptimizer update_fn")
        self.param_rrefs = list(param_rrefs)

    def step(self, *step_args):
        futures = [_STATE["pool"].submit(rref.rpc_sync_method, self.update_fn, *step_args)
                   for rref in self.param_rrefs]
        for f in futures:
            f.result()
