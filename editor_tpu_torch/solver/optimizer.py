"""Optimizer with the JAX package's per-parameter groups: counterpart of
``editor_tpu/solver/optimizer.py`` (reference: solver/make_optimizer.py).

Groups: biases get lr x BIAS_LR_FACTOR and WEIGHT_DECAY_BIAS; with
LARGE_FC_LR the classifier heads get 2 x lr; the unused legacy ImageNet head
``BACKBONE.base.fc`` is frozen (``requires_grad`` off, in no group). SGD has
momentum and coupled weight decay (``g += wd * w`` before the momentum
buffer), AdamW decoupled decay. :meth:`Optimizer.step` takes the scalar lr of
the epoch (``lr_fn(epoch, BASE_LR)``) and scales it by each group's factor,
as the JAX train step does.

As in the JAX update, a parameter without a gradient in this step (a head
the configuration does not use, such as BACKBONE_BN under AL) is updated with
a zero gradient, so its weight decay and momentum still act; AdamW's bias
corrections are computed in fp32, as there. The updates run as
``torch._foreach_*`` ops over each group, one kernel per op and group on the
card.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

FROZEN = ("BACKBONE.base.fc.",)
CLASSIFIER_HEADS = ("FUSE_HEAD", "BACKBONE_HEAD", "AL_HEAD")


def param_group_labels(model: nn.Module, large_fc_lr: bool = False) -> Dict[str, str]:
    """'default' | 'bias' | 'fc' | 'frozen' for each named parameter."""

    def label(name: str) -> str:
        if name.startswith(FROZEN):
            return "frozen"
        if large_fc_lr and name.split(".")[0] in CLASSIFIER_HEADS:
            return "fc"
        if name.endswith(".bias"):
            return "bias"
        return "default"

    return {name: label(name) for name, _ in model.named_parameters()}


class Optimizer:
    """SGD (momentum, coupled decay) or AdamW over groups of
    ``{"params", "lr_factor", "weight_decay"}``."""

    betas, eps = (0.9, 0.999), 1e-8  # AdamW, as the JAX optimizer

    def __init__(self, groups: List[Dict[str, Any]], name: str = "SGD",
                 momentum: float = 0.9):
        if name not in ("SGD", "AdamW"):
            raise ValueError(f"unsupported optimizer '{name}'")
        self.groups, self.name, self.momentum = groups, name, momentum
        self.count = 0
        # per group: SGD momentum buffers, or AdamW first and second moments
        slots = ("buf",) if name == "SGD" else ("mu", "nu")
        self.state = [{k: [torch.zeros_like(p) for p in g["params"]] for k in slots}
                      for g in groups]

    def zero_grad(self) -> None:
        for g in self.groups:
            for p in g["params"]:
                p.grad = None

    def params(self) -> List[torch.Tensor]:
        return [p for g in self.groups for p in g["params"]]

    def state_dict(self) -> Dict[str, Any]:
        """The step count (AdamW's bias correction) and every slot, per group
        in group order: what a run needs to resume exactly."""
        return {"name": self.name, "count": self.count,
                "state": [{k: list(v) for k, v in st.items()} for st in self.state]}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Copies a :meth:`state_dict` into this optimizer's slots (on their
        device); the optimizer and its groups must be the same."""
        if sd["name"] != self.name or len(sd["state"]) != len(self.state):
            raise ValueError(f"optimizer state of {sd['name']} with {len(sd['state'])} "
                             f"groups into {self.name} with {len(self.state)}")
        for st, saved in zip(self.state, sd["state"]):
            for k, slots in st.items():
                if len(saved[k]) != len(slots) or any(
                        a.shape != b.shape for a, b in zip(slots, saved[k])):
                    raise ValueError(f"optimizer slot '{k}' does not match this model")
                for a, b in zip(slots, saved[k]):
                    a.copy_(b)
        self.count = int(sd["count"])

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.count += 1
        for g, st in zip(self.groups, self.state):
            params = g["params"]
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            glr, wd = lr * g["lr_factor"], g["weight_decay"]
            if self.name == "SGD":
                d = torch._foreach_add(grads, params, alpha=wd)
                torch._foreach_mul_(st["buf"], self.momentum)
                torch._foreach_add_(st["buf"], d)
                torch._foreach_add_(params, st["buf"], alpha=-glr)
            else:
                b1, b2 = self.betas
                t = torch.tensor(float(self.count), dtype=torch.float32)
                c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
                c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
                torch._foreach_mul_(st["mu"], b1)
                torch._foreach_add_(st["mu"], grads, alpha=1 - b1)
                torch._foreach_mul_(st["nu"], b2)
                torch._foreach_addcmul_(st["nu"], grads, grads, value=1 - b2)
                denom = torch._foreach_div(st["nu"], c2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, self.eps)
                upd = torch._foreach_div(st["mu"], c1)
                torch._foreach_div_(upd, denom)
                torch._foreach_add_(upd, params, alpha=wd)
                torch._foreach_add_(params, upd, alpha=-glr)


def make_optimizer(cfg: Any, model: nn.Module) -> Optimizer:
    """The optimizer of ``cfg.SOLVER`` over ``model``'s parameters; freezes
    ``BACKBONE.base.fc``."""
    s = cfg.SOLVER
    labels = param_group_labels(model, large_fc_lr=s.LARGE_FC_LR)
    spec = {"default": (1.0, s.WEIGHT_DECAY), "bias": (s.BIAS_LR_FACTOR, s.WEIGHT_DECAY_BIAS),
            "fc": (2.0, s.WEIGHT_DECAY)}
    groups = {k: [] for k in spec}
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            p.requires_grad_(False)
        else:
            groups[labels[name]].append(p)
    return Optimizer([{"params": ps, "lr_factor": spec[k][0], "weight_decay": spec[k][1]}
                      for k, ps in groups.items() if ps],
                     name=s.OPTIMIZER_NAME, momentum=s.MOMENTUM)
