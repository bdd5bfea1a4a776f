"""The benchmark's one bridge to the system under test, ``editor_tpu_torch``:
the model built as the program's entry points build it, with the weights
the benchmark made; the train step as ``engine/loop.py:_train`` builds it on
one device; the evaluation pass as ``loop.evaluate`` runs it; and a counter
at the fusion block's boundary. Nothing else in the benchmark imports the
program, and nothing here reads or writes the program's state beyond what
the benchmark hands it and what its calls return.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch


def config(cfg: dict):
    """The program's ``Config`` of a configuration file (its ``load_config``
    overrides)."""
    from editor_tpu_torch.config import load_config
    return load_config(None, list(cfg["load_config"]))


def compute_dtype(pcfg) -> torch.dtype:
    return getattr(torch, pcfg.TPU.COMPUTE_DTYPE)


@torch.no_grad()
def build_model(cfg: dict, pcfg, weights: Dict[str, torch.Tensor],
                buffers: Dict[str, torch.Tensor], device):
    """``Editor`` of the configuration on ``device``, its parameters and its
    training buffers copied from the benchmark's; every name must match."""
    from editor_tpu_torch.models.editor import Editor, editor_config_from

    ecfg = editor_config_from(pcfg, cfg["num_classes"], cfg["camera_num"])
    model = Editor(ecfg, device=device)
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError("the program's parameters differ from the configuration's: "
                           f"{sorted(set(params) ^ set(weights))[:8]}")
    for name, p in params.items():
        if p.shape != weights[name].shape:
            raise RuntimeError(f"{name}: program {tuple(p.shape)}, benchmark "
                               f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])
    bufs = dict(model.named_buffers())
    for name, b in buffers.items():
        bufs[name].copy_(b)
    return model


def train_step(pcfg, cfg: dict, model, seed: int) -> Tuple[Callable, object]:
    """(step, optimizer): ``build_train_step`` with the configuration's
    optimizer, losses, schedule and augmentation, on one device."""
    from editor_tpu_torch.data.transforms import make_train_augment
    from editor_tpu_torch.engine.train import build_train_step
    from editor_tpu_torch.losses import make_loss
    from editor_tpu_torch.solver import make_optimizer, make_scheduler

    opt = make_optimizer(pcfg, model)
    step = build_train_step(model, opt, make_loss(pcfg, cfg["num_classes"]),
                            make_scheduler(pcfg), pcfg.SOLVER.BASE_LR, compute_dtype(pcfg),
                            augment=make_train_augment(pcfg.INPUT),
                            grad_accum=pcfg.TPU.GRAD_ACCUM, seed=seed)
    return step, opt


def momentum_by_name(model, opt) -> Dict[str, torch.Tensor]:
    """A copy of the optimizer's SGD momentum, by parameter name."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for group, state in zip(opt.groups, opt.state):
        for p, buf in zip(group["params"], state["buf"]):
            out[names[id(p)]] = buf.detach().clone()
    return out


def params_by_name(model) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def eval_transform(pcfg):
    from editor_tpu_torch.data.transforms import make_eval_transform
    return make_eval_transform(tuple(pcfg.INPUT.PIXEL_MEAN), tuple(pcfg.INPUT.PIXEL_STD))


def inference(model, pcfg, batches, num_query: int):
    """One evaluation pass: ``do_inference`` as ``loop.evaluate`` calls it.
    Returns (cmc, mAP, query features, gallery features)."""
    from editor_tpu_torch.engine.evaluate import do_inference

    cmc, mAP, _, _, _, qf, gf = do_inference(
        model, batches, num_query, feat_norm=pcfg.TEST.FEAT_NORM == "yes",
        reranking=pcfg.TEST.RE_RANKING == "yes", compute_dtype=compute_dtype(pcfg))
    return cmc, mAP, qf, gf


def build_kernels(device) -> None:
    """Build (or load from the checkout's build directory) the program's
    kernel library, so that set-up shows its cost as a part of its own."""
    if torch.device(device).type == "cuda":
        from editor_tpu_torch.ops import _build
        _build.library()


class FusionCounter:
    """Counts, at the fusion block's input, each forward's rows and, per
    row, 1 + the patch tokens its mask keeps: their sum and sum of squares,
    kept on the device until read."""

    def __init__(self, model):
        self.rows: List[int] = []
        self.sums: List[torch.Tensor] = []
        self.handle = model.FUSE_block.register_forward_pre_hook(self._hook)

    def _hook(self, module, args):
        mask = args[1]
        v = 1.0 + mask.to(torch.float32).sum(dim=(1, 2))
        self.rows.append(int(mask.shape[0]))
        self.sums.append(torch.stack([v.sum(), (v * v).sum()]))

    def read(self, lo: int = 0, hi=None) -> List[Tuple[int, float, float]]:
        """(rows, sum, sum of squares) of forwards ``lo:hi``."""
        if not self.sums[lo:hi]:
            return []
        s = torch.stack(self.sums[lo:hi]).cpu().tolist()
        return [(r, a, b) for r, (a, b) in zip(self.rows[lo:hi], s)]

    def close(self) -> None:
        self.handle.remove()

