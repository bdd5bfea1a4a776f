"""Full train-state checkpoints: counterpart of ``editor_tpu/utils/checkpoint.py``.

The reference saves the model's ``state_dict`` only, so a run cannot resume
exactly (engine/processor.py:120-127). As in the JAX package, a checkpoint
here is the whole train state: ``{"model": state_dict (parameters, BN running
stats and ``num_batches_tracked``, OCFR centers), "optimizer":
Optimizer.state_dict() (step count and slots), "generator": the train step's
generator state, "step", "epoch"}``, one ``torch.save`` file a step under the
directory, written to a temporary name and renamed. Files load with
``torch.load(weights_only=True)``. The JAX package's Orbax directories are
not read here.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """Keeps the latest ``max_to_keep`` checkpoints of a directory."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Dict[str, Any]) -> bool:
        """Writes ``payload`` as step ``step``; False (and nothing written)
        when that step is already saved, as a periodic and a best-mAP save
        can land on one step."""
        if step in self.all_steps():
            return False
        tmp = self.path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return True

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
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
