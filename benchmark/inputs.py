"""What the benchmark makes from ``--seed`` and hands to the program and the
reference alike: the weights, the synthetic splits and the P x K plan.

Everything is drawn on the run's device from ``torch.Generator``s (the plan
from numpy's), in a few large calls, so a seed gives the same inputs on
every run of one device. The splits are uint8 NHWC images: an identity's
items share a smooth random prototype per modality, and an item adds its own
smooth and pixel noise and its camera's tint. At initialised weights the
camera embedding (SIE) outweighs what the images carry, so features rank
by camera and the retrieval is near chance: the check compares features
and metrics, not how well the model retrieves.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.editor import MODS, Shape, buffer_shapes, param_shapes


def seeds(seed: int) -> Dict[str, int]:
    """Independent 32-bit seeds of the run's parts, from one whole number."""
    words = np.random.SeedSequence(int(seed)).generate_state(4)
    return dict(zip(("weights", "data", "step", "plan"), (int(w) for w in words)))


def _std(name: str, shape, s: Shape) -> float:
    """The initial standard deviation of a weight (``editor_init``'s
    distributions; biases and norms are set, not drawn)."""
    if name.endswith("patch_embed.proj.weight"):
        return (2.0 / (s.patch * s.patch * s.C)) ** 0.5
    if name.split(".")[0] in ("RGB_REDUCE", "NIR_REDUCE", "TIR_REDUCE"):
        return (2.0 / shape[0]) ** 0.5
    if name.split(".")[0] in ("FUSE_HEAD", "BACKBONE_HEAD", "AL_HEAD"):
        return 0.001
    return 0.02


def _drawn(name: str, shape) -> bool:
    last = name.split(".")[-1]
    norm = any(k in name for k in ("norm", "_BN"))
    return not (last == "bias" or (norm and last == "weight"))


def make_weights(s: Shape, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter, fp32 on ``device``: one normal draw cut at two
    standard deviations and scaled per leaf; biases 0, norm weights 1."""
    shapes = param_shapes(s)
    drawn = [n for n, sh in shapes.items() if _drawn(n, sh)]
    total = sum(int(np.prod(shapes[n])) for n in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, off = {}, 0
    for name, shape in shapes.items():
        if name in drawn:
            n = int(np.prod(shape))
            out[name] = flat[off:off + n].view(shape) * _std(name, shape, s)
            off += n
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


def make_buffers(s: Shape, device) -> Dict[str, torch.Tensor]:
    """BN running mean 0 and variance 1, class centers 0."""
    return {n: (torch.ones(sh, device=device) if n.endswith("running_var")
                else torch.zeros(sh, device=device)) for n, sh in buffer_shapes(s).items()}


def _smooth(gen, n: int, lo: Tuple[int, int], size: Tuple[int, int], device) -> torch.Tensor:
    """[n, 3, H, W] smooth noise: a coarse normal grid upsampled."""
    z = torch.randn((n, 3) + lo, generator=gen, device=device)
    return F.interpolate(z, size=size, mode="bilinear", align_corners=False)


def make_looks(num_ids: int, num_cams: int, gen: torch.Generator, device) -> dict:
    """Each identity's prototype per modality ([ids, 3, 16, 8], upsampled
    later) and each camera's tint per channel."""
    protos = {m: torch.randn((num_ids, 3, 16, 8), generator=gen, device=device) for m in MODS}
    return {"protos": protos,
            "tint": torch.randn((num_cams, 3), generator=gen, device=device) * 10.0}


def make_split(pids: torch.Tensor, cams: torch.Tensor, looks: dict, size: Tuple[int, int],
               gen: torch.Generator, chunk: int = 256) -> Dict[str, torch.Tensor]:
    """uint8 [R, H, W, 3] images per modality for items of identity
    ``pids`` seen by camera ``cams``, with the identities' and cameras'
    ``looks``."""
    device = pids.device
    protos, tint = looks["protos"], looks["tint"]
    out = {m: torch.empty((pids.shape[0],) + tuple(size) + (3,), dtype=torch.uint8,
                          device=device) for m in MODS}
    for a in range(0, pids.shape[0], chunk):
        p, c = pids[a:a + chunk], cams[a:a + chunk]
        n = p.shape[0]
        for m in MODS:
            base = F.interpolate(protos[m][p], size=size, mode="bilinear", align_corners=False)
            x = (128.0 + 48.0 * base + 20.0 * _smooth(gen, n, (32, 16), size, device)
                 + 12.0 * torch.randn((n, 3) + tuple(size), generator=gen, device=device)
                 + tint[c][:, :, None, None])
            out[m][a:a + n] = x.clamp_(0, 255).round_().to(torch.uint8).permute(0, 2, 3, 1)
    out["pid"], out["camid"] = pids, cams
    return out


def train_split(traffic: dict, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The training split: ``items`` items over ``ids`` identities, in order
    0, 1, ..., each seen by a random one of the configuration's cameras."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n, ids = traffic["items"], traffic["ids"]
    pids = torch.arange(n, device=device) % ids
    cams = torch.randint(0, cfg["camera_num"], (n,), generator=gen, device=device)
    looks = make_looks(ids, cfg["camera_num"], gen, device)
    return make_split(pids, cams, looks, tuple(cfg["model"]["img_size"]), gen)


def eval_split(traffic: dict, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Query rows first, then gallery rows, of ``ids`` identities: a query's
    camera is random among ``cameras``, the gallery cycles through them, so
    every query has a match in another camera."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nq, ng, ids, ncam = traffic["query"], traffic["gallery"], traffic["ids"], traffic["cameras"]
    size = tuple(cfg["model"]["img_size"])
    q_p = torch.arange(nq, device=device) % ids
    q_c = torch.randint(0, ncam, (nq,), generator=gen, device=device)
    g_p = torch.arange(ng, device=device) % ids
    g_c = (torch.arange(ng, device=device) // ids) % ncam
    looks = make_looks(ids, ncam, gen, device)
    query = make_split(q_p, q_c, looks, size, gen)
    gallery = make_split(g_p, g_c, looks, size, gen)
    return {k: torch.cat([query[k], gallery[k]]) for k in list(MODS) + ["pid", "camid"]}


def pk_plan(pids: np.ndarray, ids_per_batch: int, instances: int, steps: int,
            seed: int) -> np.ndarray:
    """[steps, ids_per_batch * instances] item indices: each epoch the
    identities in a random order, ``ids_per_batch`` a batch (the remainder
    dropped), each with ``instances`` of its items drawn without
    replacement (with, where it has fewer)."""
    rng = np.random.default_rng(seed)
    by_id = [np.flatnonzero(pids == i) for i in range(int(pids.max()) + 1)]
    per_epoch = len(by_id) // ids_per_batch
    plan = []
    while len(plan) < steps:
        order = rng.permutation(len(by_id))
        for b in range(per_epoch):
            rows = [rng.choice(by_id[i], instances, replace=by_id[i].size < instances)
                    for i in order[b * ids_per_batch:(b + 1) * ids_per_batch]]
            plan.append(np.concatenate(rows))
    return np.stack(plan[:steps])
