"""Full train-state checkpoints and flat ``.npz`` weight files: counterpart of
``editor_tpu/utils/checkpoint.py``.

The reference saves the model's ``state_dict`` only, so a run cannot resume
exactly (engine/processor.py:120-127). As in the JAX package, a checkpoint
here is the whole train state: ``{"model": state_dict (parameters, BN running
stats and ``num_batches_tracked``, OCFR centers), "optimizer":
Optimizer.state_dict() (step count and slots), "generator": the train step's
generator state, "step", "epoch"}``, one ``torch.save`` file a step under the
directory, written to a temporary name and renamed. Files load with
``torch.load(weights_only=True)``. The JAX package's Orbax directories are
not read here.

Saves are asynchronous by default (``TPU.ASYNC_CHECKPOINT``, as Orbax's in
the JAX loop): ``save`` copies the payload to host memory (device tensors
into pinned buffers kept across saves, CPU tensors cloned), so the caller may
change the model at once, and one writer thread writes, renames and prunes.
A save waits for the write before it; ``restore``, ``latest_step`` and
``all_steps`` wait for a pending write; a writer's exception is raised at the
next ``save``, ``wait`` or ``close``.

``save_params_npz`` / ``load_params_npz`` read and write the JAX package's
flat ``.npz`` weight files (``jax.tree_util.keystr`` keys of ``{"params",
"state"}``, as ``tools/convert_checkpoint.py`` writes them) through the
weight bridge ``utils/jax_weights``.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _host_copy(obj: Any, buffers: Dict[tuple, torch.Tensor], key: tuple = ()) -> Any:
    """``obj`` with every tensor copied to host memory: a device tensor into
    the pinned buffer kept under its path in ``buffers`` (without blocking),
    a CPU tensor cloned."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.device.type == "cpu":
            return t.clone()
        buf = buffers.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = buffers[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t, non_blocking=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v, buffers, key + (k,)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v, buffers, key + (i,)) for i, v in enumerate(obj))
    return obj


def _devices(obj: Any) -> set:
    if isinstance(obj, torch.Tensor):
        return {obj.device} if obj.device.type == "cuda" else set()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return set().union(*map(_devices, obj)) if obj else set()
    return set()


class CheckpointManager:
    """Keeps the latest ``max_to_keep`` checkpoints of a directory; with
    ``use_async`` a save returns once its payload is in host memory."""

    def __init__(self, directory: str, max_to_keep: int = 5, use_async: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.use_async = use_async
        os.makedirs(self.directory, exist_ok=True)
        self._buffers: Dict[tuple, torch.Tensor] = {}
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.pt")

    def _steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def all_steps(self) -> List[int]:
        self.wait()
        return self._steps()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _write(self, step: int, payload: Dict[str, Any]) -> None:
        tmp = self.path(step) + ".tmp"
        try:
            torch.save(payload, tmp)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        os.replace(tmp, self.path(step))
        for old in self._steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def _write_caught(self, step: int, payload: Dict[str, Any]) -> None:
        try:
            self._write(step, payload)
        except Exception as e:  # raised in the caller at wait()
            self._error = e

    def save(self, step: int, payload: Dict[str, Any]) -> bool:
        """Writes ``payload`` as step ``step``; False (and nothing written)
        when that step is already saved, as a periodic and a best-mAP save
        can land on one step. Asynchronous: returns once the payload is in
        host memory, the write pending."""
        if step in self.all_steps():
            return False
        if not self.use_async:
            self._write(step, payload)
            return True
        host = _host_copy(payload, self._buffers)
        for device in _devices(payload):  # the pinned copies have landed
            torch.cuda.current_stream(device).synchronize()
        self._writer = threading.Thread(target=self._write_caught, args=(step, host),
                                        name=f"checkpoint-{step}", daemon=True)
        self._writer.start()
        return True

    def wait(self) -> None:
        """Waits for the pending write; raises its exception if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        self.wait()
        return torch.load(self.path(step), map_location="cpu", weights_only=True)


def _group() -> tuple:
    """(rank, world size) of the default process group, (0, 1) without one."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _comm_payload(comm: Any, mesh=None) -> Any:
    """A reducer state consolidated: each leaf's ``q`` (the same on every
    rank) and every rank's ``error`` in rank order, on the host; with a
    ``mesh``, every data rank's (the ranks of a model group hold the same
    canonical state)."""
    from editor_tpu_torch.parallel import collectives as C
    if not isinstance(comm, dict) or not comm:
        return {}
    out = {}
    for name, st in comm.items():
        errors = C.all_gather(st["error"], mesh, tiled=False)
        out[name] = {"q": st["q"].detach().cpu(), "errors": list(errors.cpu().unbind(0))}
    return out


def _tp(tp_mesh):
    """(process group, size, rank) of ``tp_mesh``'s model axis, or None
    below 2."""
    from editor_tpu_torch.parallel.mesh import model_group, model_rank, model_size
    if model_size(tp_mesh) <= 1:
        return None
    return model_group(tp_mesh), model_size(tp_mesh), model_rank(tp_mesh)


def train_state(model: torch.nn.Module, optimizer, generator: torch.Generator,
                epoch: int, comm: Any = None, tp_mesh=None) -> Optional[Dict[str, Any]]:
    """The checkpoint payload of a run after ``epoch``.

    Under a process group the call is collective (every rank makes it) and
    the payload comes back on rank 0 only (None elsewhere): the model is the
    same on every rank; a ZeRO-1 optimizer gathers its slots into the
    single-device format; an FSDP optimizer (``parallel.fsdp``) gathers the
    parameters and the slots into it (the model's state copied to the host
    inside ``gathered()``); ``generators`` holds every rank's generator state
    in rank order (``generator`` stays rank 0's); ``comm``, a data-parallel
    step's reducer state, is saved with each rank's PowerSGD error feedback
    (``errors``). ``tp_mesh``: the model is cut over the mesh's model axis
    (``parallel.tp.shard_editor``); its parameters and their slots are
    gathered over the model group and un-permuted, the canonical layout (a
    ZeRO-1 or FSDP optimizer gathers its slots over the data group first,
    and the data row of rank 0 gathers over its model group), and the
    reducer's state is the data group's (its leaves are canonical already).
    The file loads into a single-device run and into any tp."""
    import torch.distributed as dist
    rank, world = _group()
    model_state = None
    tp = _tp(tp_mesh)
    opt = optimizer.state_dict()  # None off data rank 0 for ZeRO-1 and FSDP
    # the ranks that hold a part of the payload: rank 0, or under tensor
    # parallelism its whole model group (every rank of a model group shares
    # its data rank, so each group takes one branch)
    keep = rank == 0 if tp is None else opt is not None
    if hasattr(optimizer, "gathered"):  # FSDP: the full parameters exist only here
        with optimizer.gathered():
            if keep:
                model_state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    elif keep:
        model_state = model.state_dict()
    if tp is not None and keep:
        from editor_tpu_torch.parallel import tp as tpm
        canon = tpm.gather_train_state({"model": model_state, "optimizer": opt},
                                       tpm.slot_names(model, optimizer),
                                       model.cfg.vit.num_heads, tp[0])
        model_state, opt = canon["model"], canon["optimizer"]
    gens = [generator.get_state()]
    if dist.is_initialized():
        gens = [None] * world
        dist.all_gather_object(gens, generator.get_state())
    comm_state = _comm_payload(comm, tp_mesh if tp is not None else None) \
        if comm is not None else None
    if rank != 0:
        return None
    payload = {"model": model_state, "optimizer": opt, "generator": gens[0],
               "step": optimizer.count, "epoch": epoch}
    if dist.is_initialized():
        payload["generators"] = gens
    if comm_state is not None:
        payload["comm"] = comm_state
    return payload


@torch.no_grad()
def load_train_state(payload: Dict[str, Any], model: torch.nn.Module, optimizer,
                     generator: torch.Generator, comm: Any = None, tp_mesh=None) -> int:
    """Restores a :func:`train_state` payload in place; returns its epoch.

    Every rank loads the same file: a ZeRO-1 optimizer takes its own slots,
    an FSDP one its blocks of the parameters and the slots (a collective).
    A rank takes its own generator state and PowerSGD error when the file
    was saved at this world size; otherwise rank 0 takes the saved rank 0's
    generator, the other ranks keep their fresh ones, and the error
    feedback restarts from zero (``q`` is kept). ``tp_mesh``: the model
    is cut over its model axis, and takes this rank's blocks of the
    canonical parameters and slots; the error feedback is the data
    rank's."""
    rank, world = _group()
    tp = _tp(tp_mesh)
    c_rank, c_world = rank, world
    if tp is not None:
        from editor_tpu_torch.parallel.mesh import data_rank, data_size
        c_rank, c_world = data_rank(tp_mesh), data_size(tp_mesh)
    if tp is not None:
        from editor_tpu_torch.parallel import tp as tpm
        payload = tpm.shard_train_state(payload, tpm.slot_names(model, optimizer),
                                        model.cfg.vit.num_heads, tp[1], tp[2])
    if hasattr(optimizer, "gathered"):
        with optimizer.gathered():
            model.load_state_dict(payload["model"], strict=True)
    else:
        model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    gens = payload.get("generators")
    if gens is not None and len(gens) == world:
        generator.set_state(gens[rank])
    elif rank == 0:
        generator.set_state(payload["generator"])
    if isinstance(comm, dict) and comm:
        saved = payload.get("comm", {})
        for name, st in comm.items():
            if name not in saved:
                continue
            st["q"].copy_(saved[name]["q"])
            errors = saved[name]["errors"]
            if len(errors) == c_world:
                st["error"].copy_(errors[c_rank])
            else:
                st["error"].zero_()
    return int(payload["epoch"])


def restore_eval_state(directory: str) -> Dict[str, Any]:
    """The model ``state_dict`` of the latest checkpoint in ``directory``
    (the training loop's ``OUTPUT_DIR/ckpt``)."""
    return CheckpointManager(directory).restore()["model"]


_KEY = re.compile(r"\['([^']*)'\]")


def _keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree: Any, path: tuple = ()) -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out: Dict[str, np.ndarray] = {}
        for k in sorted(tree):  # the JAX package's leaf order: sorted dict keys
            out.update(_flatten(tree[k], path + (k,)))
        return out
    return {_keystr(path): np.asarray(tree)}


def save_params_npz(path: str, model: torch.nn.Module) -> None:
    """Write ``model``'s weights as the JAX package's flat ``.npz`` of
    ``{"params": ..., "state": ...}``, which its ``load_params_npz`` reads
    into ``editor_init``'s tree."""
    from editor_tpu_torch.utils.jax_weights import jax_tree_from_state_dict

    params, state = jax_tree_from_state_dict(model.state_dict(), model.cfg)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten({"params": params, "state": state}))


def load_params_npz(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a flat ``.npz`` that the JAX package's ``save_params_npz`` wrote
    (``{"params", "state"}``, as ``tools/convert_checkpoint.py``) into
    ``model``, strictly, through ``state_dict_from_jax``; returns ``model``."""
    from editor_tpu_torch.utils.jax_weights import state_dict_from_jax

    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            parts = _KEY.findall(key)
            if _keystr(tuple(parts)) != key:
                raise ValueError(f"{path}: key {key!r} is not a path of dict keys")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    if set(tree) != {"params", "state"}:
        raise ValueError(f"{path}: top-level keys {sorted(tree)}, not params and state")
    sd = state_dict_from_jax(tree["params"], tree["state"], model.cfg)
    model.load_state_dict(sd, strict=True)
    return model
