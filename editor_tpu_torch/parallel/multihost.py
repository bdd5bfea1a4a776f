"""Process-group set-up and host coordination: counterpart of
``editor_tpu/parallel/multihost.py`` (reference: distributed_c10d.py
``init_process_group``).

One process per device, as torch runs data parallelism: ``initialize``
joins the default ``torch.distributed`` group of its arguments or of the
launcher's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``: what ``torchrun``
and ``cli.launch`` set; or ``DIST_INIT_METHOD`` in place of the first two),
with NCCL on CUDA and gloo on the CPU, and a timeout, so that a
collective whose peer has died raises instead of waiting for ever. On CUDA
each rank's device is ``cuda:LOCAL_RANK``, made current before anything is
built. Without a group every function here answers for one process.
"""

from __future__ import annotations

import datetime
import os
import sys
import traceback
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, local_rank: Optional[int] = None,
               device: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the default process group; returns whether this call made one
    (False when a group is already up, or for one process).

    Arguments fall back to the launcher's environment: ``init_method`` to
    ``DIST_INIT_METHOD`` (a ``file://`` rendezvous, say) or else to
    ``env://`` when ``MASTER_ADDR`` is set, ``world_size`` to ``WORLD_SIZE``,
    ``rank`` to ``RANK`` or else, as the JAX package derives it,
    ``NODE_RANK * NPROC_PER_NODE + LOCAL_RANK``, ``local_rank`` to
    ``LOCAL_RANK`` (else ``rank``).
    With none of the three this is a single-process run and no group is
    made (False). ``device`` 'cpu' makes
    a gloo group; otherwise the group is NCCL on ``cuda:local_rank``, which
    becomes the current device, and a missing CUDA device raises. Every
    collective of the group raises after ``timeout_s`` seconds."""
    env = os.environ
    if dist.is_initialized():
        return False
    if init_method is None:
        init_method = env.get("DIST_INIT_METHOD") or ("env://" if "MASTER_ADDR" in env
                                                      else None)
        if init_method is None:
            return False
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if rank is None:
        if "RANK" in env:
            rank = int(env["RANK"])
        elif "LOCAL_RANK" in env:
            rank = (int(env.get("NODE_RANK", "0")) * int(env.get("NPROC_PER_NODE", "1"))
                    + int(env["LOCAL_RANK"]))
        else:
            rank = 0
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for an NCCL group: pass device='cpu' for gloo")
        torch.cuda.set_device(local_rank)
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def barrier() -> None:
    """``dist.barrier`` over the default group (no-op without one)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shutdown() -> None:
    """Barrier, so that no rank leaves while a peer still writes, then
    ``destroy_process_group``. For a failing rank use :func:`fail_fast`."""
    if dist.is_initialized():
        barrier()
        dist.destroy_process_group()


def fail_fast(exc: BaseException, exit_code: int = 1, write_error: bool = True) -> None:
    """End a failing rank at once: write the elastic error file
    (``parallel.elastic.write_error_file``: ``EDITOR_TPU_ERROR_FILE``, which
    ``cli.launch`` sets), print the traceback and ``os._exit``.
    ``write_error`` False is for a deliberate exit (``sys.exit``, Ctrl-C):
    no error file, so the launcher spends no restart on it.

    Every clean way out of a group is collective (the shutdown barrier,
    ``destroy_process_group``, interpreter teardown), and would wait for
    peers that sit in a train-step collective. A rank that exits instead
    closes its connections: a gloo peer's collective then raises at once,
    an NCCL peer's when the group's timeout runs out, and each peer leaves
    through this function too."""
    from editor_tpu_torch.parallel.elastic import write_error_file
    try:
        if write_error:
            write_error_file(exc)
        traceback.print_exception(exc)
    finally:
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(exit_code)


def leave_on_error(exc: BaseException) -> None:
    """An entry point's handler for an exception that ends its run: a rank
    of a multi-process run leaves at once through :func:`fail_fast` (the
    exit code of a ``SystemExit``, 130 for Ctrl-C, else 1), with the error
    file for a fault and none for a deliberate exit; one process writes the
    error file of a fault (a launcher's single worker) and returns, and the
    caller re-raises as usual."""
    deliberate = isinstance(exc, (SystemExit, KeyboardInterrupt))
    if process_count() <= 1:
        if not deliberate:
            from editor_tpu_torch.parallel.elastic import write_error_file
            write_error_file(exc)
        return
    if isinstance(exc, KeyboardInterrupt):
        code = 130
    elif isinstance(exc, SystemExit):
        code = exc.code if isinstance(exc.code, int) else (0 if exc.code is None else 1)
    else:
        code = 1
    fail_fast(exc, exit_code=code, write_error=not deliberate)


def broadcast_host_value(value: int) -> int:
    """Rank 0's host integer (a sampling seed, say) on every rank."""
    if not dist.is_initialized():
        return int(value)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(value)], dtype=torch.int64, device=device)
    dist.broadcast(t, src=0)
    return int(t.item())
