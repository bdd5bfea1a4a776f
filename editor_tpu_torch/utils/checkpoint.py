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


def train_state(model: torch.nn.Module, optimizer, generator: torch.Generator,
                epoch: int) -> Dict[str, Any]:
    """The checkpoint payload of a run after ``epoch``."""
    return {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
            "generator": generator.get_state(), "step": optimizer.count, "epoch": epoch}


def load_train_state(payload: Dict[str, Any], model: torch.nn.Module, optimizer,
                     generator: torch.Generator) -> int:
    """Restores a :func:`train_state` payload in place; returns its epoch."""
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    generator.set_state(payload["generator"])
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
