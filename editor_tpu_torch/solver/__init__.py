"""Optimizer and LR schedule of the train step."""

from editor_tpu_torch.solver.optimizer import Optimizer, make_optimizer, param_group_labels
from editor_tpu_torch.solver.schedule import cosine_lr_schedule, make_scheduler

__all__ = ["Optimizer", "cosine_lr_schedule", "make_optimizer", "make_scheduler",
           "param_group_labels"]
