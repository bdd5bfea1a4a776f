"""The plain EDITOR reference: the tri-modal forward, its training losses,
SGD and the train augmentation, in plain PyTorch over a name -> tensor
dict of parameters, with no kernel, no batching trick and no state of the
program.

It follows the published description as the program's plain paths compute
it (``editor_tpu_torch``'s CPU paths), with two deliberate departures, both
exact in arithmetic:

* the frequency mask takes the modality mean directly: for Haar with zero
  padding on sides that divide by 2^J, DWT -> band mean -> IDWT is the
  identity on the modality mean (linear, perfect reconstruction);
* the fusion tail runs uncompacted (every patch token, the unselected ones
  zero): the program's compact tail drops rows that carry zero attention
  and pool weight.

``Arith`` decides where products round: fp32 with TF32 off (the reference)
or every product's operands rounded to fp8 e4m3 with a per-tensor scale
(the control, the step below the configuration's bf16).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

MODS = ("RGB", "NI", "TI")
FUSE_MODS = ("R", "N", "T")
REDUCE = ("RGB_REDUCE", "NIR_REDUCE", "TIR_REDUCE")
CENTERS = ("RGB_centers", "NIR_centers", "TIR_centers")
MASK_FILL = -65504.0
FP8_MAX = 448.0


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
        return (x * s).to(torch.float8_e4m3fn).to(x.dtype) / s

    @staticmethod
    def backward(ctx, g):
        return g


class Arith:
    """Products of the reference: plain fp32, or with fp8 operands."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.fp8 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))

    def linear(self, x, w, b=None):
        y = self.mm(x, w.t())
        return y if b is None else y + b

    def conv(self, x, w, stride):
        return F.conv2d(self.q(x), self.q(w), stride=stride)


class Shape:
    """The sizes of one configuration file's ``model`` block."""

    def __init__(self, cfg: dict):
        m = cfg["model"]
        self.H, self.W = m["img_size"]
        self.patch = m["patch_size"]
        self.stride = tuple(m["stride_size"])
        self.C, self.depth, self.heads = m["embed_dim"], m["depth"], m["num_heads"]
        self.hidden = int(self.C * m["mlp_ratio"])
        self.gh = (self.H - self.patch) // self.stride[0] + 1
        self.gw = (self.W - self.patch) // self.stride[1] + 1
        self.P = self.gh * self.gw
        self.N = self.P + 1
        self.head_keep, self.freq_keep = m["head_keep"], m["frequency_keep"]
        self.al = bool(m["al"])
        self.drop_path = m["drop_path_rate"]
        self.sie = m["sie_xishu"]
        self.K, self.cams = cfg["num_classes"], cfg["camera_num"]
        self.fusion_heads = m["fusion_heads"]
        self.fusion_hidden = int(self.C * m["fusion_mlp_ratio"])


def param_shapes(s: Shape) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the model under the reference's state_dict names."""
    C, hid, K = s.C, s.hidden, s.K
    out: Dict[str, Tuple[int, ...]] = {}
    b = "BACKBONE.base."
    out[b + "patch_embed.proj.weight"] = (C, 3, s.patch, s.patch)
    out[b + "patch_embed.proj.bias"] = (C,)
    out[b + "cls_token"] = (1, 1, C)
    out[b + "pos_embed"] = (1, s.N, C)
    if s.cams > 1:
        out[b + "sie_embed"] = (s.cams, 1, C)
    for i in range(s.depth):
        p = f"{b}blocks.{i}."
        for name, shape in (("norm1.weight", (C,)), ("norm1.bias", (C,)),
                            ("attn.qkv.weight", (3 * C, C)), ("attn.qkv.bias", (3 * C,)),
                            ("attn.proj.weight", (C, C)), ("attn.proj.bias", (C,)),
                            ("norm2.weight", (C,)), ("norm2.bias", (C,)),
                            ("mlp.fc1.weight", (hid, C)), ("mlp.fc1.bias", (hid,)),
                            ("mlp.fc2.weight", (C, hid)), ("mlp.fc2.bias", (C,))):
            out[p + name] = shape
    out[b + "norm.weight"], out[b + "norm.bias"] = (C,), (C,)
    out[b + "fc.weight"], out[b + "fc.bias"] = (1000, C), (1000,)
    f = "FUSE_block."
    hid = s.fusion_hidden
    for m in FUSE_MODS:
        out[f"{f}norm{m}.weight"], out[f"{f}norm{m}.bias"] = (C,), (C,)
        out[f"{f}attn{m}.qkv.weight"], out[f"{f}attn{m}.proj.weight"] = (3 * C, C), (C, C)
        out[f"{f}norm{m}_.weight"], out[f"{f}norm{m}_.bias"] = (C,), (C,)
        out[f"{f}mlp{m}.fc1.weight"], out[f"{f}mlp{m}.fc2.weight"] = (hid, C), (C, hid)
    out[f + "norm1.weight"], out[f + "norm1.bias"] = (C,), (C,)
    out[f + "attn1.qkv.weight"], out[f + "attn1.proj.weight"] = (3 * C, C), (C, C)
    out[f + "norm2.weight"], out[f + "norm2.bias"] = (C,), (C,)
    out[f + "mlp.fc1.weight"], out[f + "mlp.fc2.weight"] = (hid, C), (C, hid)
    out[f + "out_norm.weight"], out[f + "out_norm.bias"] = (C,), (C,)
    for r in REDUCE:
        out[r + ".weight"], out[r + ".bias"] = (C, 2 * C), (C,)
    out["FUSE_HEAD.weight"], out["BACKBONE_HEAD.weight"] = (K, 3 * C), (K, C)
    out["FUSE_BN.weight"], out["FUSE_BN.bias"] = (3 * C,), (3 * C,)
    out["BACKBONE_BN.weight"], out["BACKBONE_BN.bias"] = (C,), (C,)
    if s.al:
        out["AL_HEAD.weight"] = (K, 3 * C)
        out["AL_BN.weight"], out["AL_BN.bias"] = (3 * C,), (3 * C,)
    return out


def buffer_shapes(s: Shape) -> Dict[str, Tuple[int, ...]]:
    """The training state outside the parameters: BN running statistics and
    the OCFR class centers."""
    out = {}
    for bn, d in (("FUSE_BN", 3 * s.C), ("BACKBONE_BN", s.C)) + ((("AL_BN", 3 * s.C),)
                                                                   if s.al else ()):
        out[bn + ".running_mean"], out[bn + ".running_var"] = (d,), (d,)
    for c in CENTERS:
        out["FUSE_block.memory_cls." + c] = (s.K, s.C)
    return out


# ---------------------------------------------------------------- pieces


def layer_norm(x, P, name, eps):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], eps)


def drop_path(x, rate: float, u: Optional[torch.Tensor]):
    if u is None:
        return x
    keep = 1.0 - rate
    y = x / keep
    return y * torch.floor(keep + u) if rate > 0 else y


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """[R, G] -> bool with k True a row, ties to the lowest index."""
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k]
    return torch.zeros_like(scores, dtype=torch.bool).scatter_(1, idx, True)


def frequency_mask(mods: List[torch.Tensor], s: Shape) -> torch.Tensor:
    """[B, P] bool: the ``freq_keep`` patch windows with the most positive
    pixels of the grey modality mean."""
    mean = (mods[0] + mods[1] + mods[2]) / 3.0 if len(mods) == 3 else sum(mods) / len(mods)
    gray = mean.sum(-1) / mean.shape[-1]
    pos = (gray > 0).to(torch.int32)
    counts = pos.unfold(1, s.patch, s.stride[0]).unfold(2, s.patch, s.stride[1]).sum((3, 4))
    flat = counts.reshape(counts.shape[0], -1).to(torch.float32)
    return topk_mask(flat, min(s.freq_keep, flat.shape[-1]))


def _block(P, i, x, s: Shape, ar: Arith, probs: torch.Tensor, rate, u):
    p = f"BACKBONE.base.blocks.{i}."
    B, N, C = x.shape
    H, D = s.heads, C // s.heads
    h = layer_norm(x, P, p + "norm1", 1e-6)
    qkv = ar.linear(h, P[p + "attn.qkv.weight"], P[p + "attn.qkv.bias"])
    q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
    attn = torch.softmax(ar.mm(q, k.transpose(-1, -2)) * D ** -0.5, dim=-1)
    with torch.no_grad():
        probs[i].copy_(attn)
    out = ar.mm(attn, v).transpose(1, 2).reshape(B, N, C)
    u0, u1 = (None, None) if u is None else (u[0], u[1])
    x = x + drop_path(ar.linear(out, P[p + "attn.proj.weight"], P[p + "attn.proj.bias"]),
                      rate, u0)
    h = layer_norm(x, P, p + "norm2", 1e-6)
    f = F.gelu(ar.linear(h, P[p + "mlp.fc1.weight"], P[p + "mlp.fc1.bias"]))
    return x + drop_path(ar.linear(f, P[p + "mlp.fc2.weight"], P[p + "mlp.fc2.bias"]), rate, u1)


def backbone(P, x, cams, s: Shape, ar: Arith, draws: Optional[torch.Tensor],
             remat: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, 3] -> (tokens [B, N, C] after the final norm, rollout [B, heads, P])."""
    b = "BACKBONE.base."
    y = ar.conv(x.permute(0, 3, 1, 2), P[b + "patch_embed.proj.weight"], s.stride)
    y = (y + P[b + "patch_embed.proj.bias"][:, None, None]).flatten(2).transpose(1, 2)
    B = y.shape[0]
    t = torch.cat([P[b + "cls_token"].expand(B, 1, s.C), y], dim=1) + P[b + "pos_embed"]
    if s.cams > 1:
        t = t + s.sie * P[b + "sie_embed"][cams.long()]
    rates = torch.linspace(0.0, s.drop_path, s.depth, dtype=torch.float64).tolist()
    probs = torch.empty((s.depth, B, s.heads, s.N, s.N), dtype=t.dtype, device=t.device)
    for i in range(s.depth):
        u = None if draws is None else draws[i]
        if remat:  # the maps ride in the closure: later blocks write the buffer
            t = checkpoint(lambda x, i=i, u=u: _block(P, i, x, s, ar, probs, rates[i], u), t,
                           use_reentrant=False)
        else:
            t = _block(P, i, t, s, ar, probs, rates[i], u)
    t = layer_norm(t, P, b + "norm", 1e-6)
    with torch.no_grad():
        v = probs[-1][:, :, 0, :]
        for a in reversed(probs[:-1]):
            v = torch.einsum("bhn,bhnm->bhm", v, a)
    return t, v[:, :, 1:]


def masked_attention(qkv, m, heads: int, ar: Arith):
    """qkv [B, N, 3C], m [B, N] (1 keep) -> [B, N, C]: masked pairs filled,
    softmax, query rows re-masked."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // heads
    q, k, v = qkv.reshape(B, N, 3, heads, D).permute(2, 0, 3, 1, 4)
    logits = ar.mm(q, k.transpose(-1, -2)) * D ** -0.5
    pair = m[:, None, :, None] * m[:, None, None, :]
    logits = torch.where(pair == 0, torch.full_like(logits, MASK_FILL), logits)
    attn = torch.softmax(logits, dim=-1) * m[:, None, :, None]
    return ar.mm(attn, v).transpose(1, 2).reshape(B, N, C)


def _fuse_block(P, x, m, norm, attn, norm_, mlp, heads, ar: Arith):
    qkv = ar.linear(layer_norm(x, P, norm, 1e-5) * m, P[attn + ".qkv.weight"])
    x = x + ar.linear(masked_attention(qkv, m[..., 0], heads, ar), P[attn + ".proj.weight"])
    h = F.gelu(ar.linear(layer_norm(x, P, norm_, 1e-5) * m, P[mlp + ".fc1.weight"]))
    return x + ar.linear(h, P[mlp + ".fc2.weight"])


def batch_norm(x, P, Bf, name, training: bool):
    if training:
        mu = x.mean(0)
        var = (x - mu).square().mean(0)
        with torch.no_grad():
            n = x.shape[0]
            Bf[name + ".running_mean"].mul_(0.9).add_(0.1 * mu)
            Bf[name + ".running_var"].mul_(0.9).add_(0.1 * var * (n / max(n - 1, 1)))
    else:
        mu, var = Bf[name + ".running_mean"], Bf[name + ".running_var"]
    return (x - mu) * torch.rsqrt(var + 1e-5) * P[name + ".weight"] + P[name + ".bias"]


def forward(P, Bf, images: Dict[str, torch.Tensor], cams: torch.Tensor, s: Shape,
            ar: Arith, training: bool = False, labels: Optional[torch.Tensor] = None,
            draws: Optional[torch.Tensor] = None, remat: bool = False):
    """Eval: the [B, 3C] features. Training: (pairs of (score, feat), aux
    loss), the BN statistics and class centers in ``Bf`` moved in place."""
    mods = [images[k] for k in MODS]
    M, B = len(mods), mods[0].shape[0]
    mask_fre = frequency_mask(mods, s)
    tokens, rollout = backbone(P, torch.cat(mods), cams.repeat(M), s, ar, draws, remat)
    toks, rolls = tokens.split(B), rollout.split(B)
    union = mask_fre
    for r in rolls:
        union = union | topk_mask(r.reshape(B * s.heads, s.P), s.head_keep).reshape(
            B, s.heads, s.P).any(1)
    index = union[:, :, None].to(tokens.dtype)
    feats = [torch.cat([t[:, :1], t[:, 1:] * index], dim=1) for t in toks]

    mask = torch.cat([torch.ones_like(index[:, :1]), index], dim=1)  # [B, N, 1]
    f = "FUSE_block."
    refined = [_fuse_block(P, x, mask, f"{f}norm{n}", f"{f}attn{n}", f"{f}norm{n}_",
                           f"{f}mlp{n}", s.fusion_heads, ar) for x, n in zip(feats, FUSE_MODS)]
    aux = None
    if training:
        bg = 1.0 - index
        aux = sum((toks[i][:, 1:] * bg - toks[j][:, 1:] * bg).square().mean()
                  for i in range(M) for j in range(i + 1, M))
        onehot = F.one_hot(labels.long(), s.K).to(tokens.dtype)
        counts = onehot.sum(0)
        for c, x in zip(CENTERS, refined):
            fn = x[:, 0] / torch.linalg.vector_norm(x[:, 0], dim=-1, keepdim=True).clamp_min(1e-12)
            center = Bf[f + "memory_cls." + c]
            with torch.no_grad():
                mean = (onehot.t() @ fn) / counts.clamp_min(1.0)[:, None]
                center.copy_(torch.where((counts > 0)[:, None], 0.8 * mean + 0.2 * center,
                                         center))
            aux = aux + (center[labels.long()] - fn).square().mean()
    x = torch.cat(refined, dim=1)
    mt = mask.repeat(1, M, 1)
    x = _fuse_block(P, x, mt, f + "norm1", f + "attn1", f + "norm2", f + "mlp",
                    s.fusion_heads, ar)
    fused = layer_norm(x, P, f + "out_norm", 1e-5) * mt
    num = index.sum(1)
    cls4t = []
    for i, r in enumerate(REDUCE[:M]):
        seg = fused[:, i * s.N:(i + 1) * s.N]
        pooled = torch.cat([seg[:, 0], seg[:, 1:].sum(1) / num], dim=-1)
        cls4t.append(ar.linear(pooled, P[r + ".weight"], P[r + ".bias"]))
    cls4t = torch.cat(cls4t, dim=-1)
    if not training:
        return cls4t
    pairs = [(ar.linear(batch_norm(cls4t, P, Bf, "FUSE_BN", True), P["FUSE_HEAD.weight"]),
              cls4t)]
    raw = [t[:, 0] for t in toks]
    if s.al:
        ori = torch.cat(raw, dim=-1)
        pairs.append((ar.linear(batch_norm(ori, P, Bf, "AL_BN", True), P["AL_HEAD.weight"]),
                      ori))
    else:
        for c in raw:
            pairs.append((ar.linear(batch_norm(c, P, Bf, "BACKBONE_BN", True),
                                    P["BACKBONE_HEAD.weight"]), c))
    return pairs, aux


# ---------------------------------------------------------------- training


def id_loss(score, labels, K: int, eps: float = 0.1):
    logp = torch.log_softmax(score, dim=1)
    t = (1.0 - eps) * F.one_hot(labels.long(), K).to(score.dtype) + eps / K
    return (-t * logp).mean(0).sum()


def triplet_loss(feat, labels):
    """Batch-hard soft-margin triplet on euclidean distances."""
    sq = (feat * feat).sum(1, keepdim=True)
    dist = (sq + sq.t() - 2.0 * feat @ feat.t()).clamp_min(1e-12).sqrt()
    pos = labels[:, None] == labels[None, :]
    big = torch.finfo(dist.dtype).max
    ap = torch.where(pos, dist, torch.full_like(dist, -big)).amax(1)
    an = torch.where(pos, torch.full_like(dist, big), dist).amin(1)
    return torch.logaddexp(ap - an, torch.zeros_like(ap)).mean()


def total_loss(pairs, aux, labels, K: int):
    return sum(id_loss(sc, labels, K) + triplet_loss(ft, labels) for sc, ft in pairs) + aux


def learning_rate(epoch: int, sol: dict) -> float:
    """Epoch-stepped cosine with linear warmup, one cycle (timm)."""
    base = sol["base_lr"]
    init, floor_lr = 0.01 * base, 0.001 * base
    if epoch < sol["warmup_iters"]:
        return init + epoch * (base - init) / max(sol["warmup_iters"], 1)
    if epoch >= sol["max_epochs"]:
        return floor_lr
    cos = math.cos(math.pi * epoch / sol["max_epochs"])
    return floor_lr + 0.5 * (base - floor_lr) * (1.0 + cos)


def frozen(name: str) -> bool:
    return name.startswith("BACKBONE.base.fc.")


def group_of(name: str, sol: dict) -> Tuple[float, float]:
    """(lr factor, weight decay) of a trainable parameter."""
    if name.endswith(".bias"):
        return sol["bias_lr_factor"], sol["weight_decay_bias"]
    return 1.0, sol["weight_decay"]


@torch.no_grad()
def sgd_step(P, grads, bufs, lr: float, sol: dict) -> None:
    """SGD with momentum and coupled weight decay; a parameter without a
    gradient moves by its decay alone."""
    for name, w in P.items():
        if frozen(name):
            continue
        factor, wd = group_of(name, sol)
        g = grads.get(name)
        d = (torch.zeros_like(w) if g is None else g) + wd * w
        bufs[name] = d if name not in bufs else sol["momentum"] * bufs[name] + d
        w.sub_(lr * factor * bufs[name])


def augment(x_u8: torch.Tensor, gen: torch.Generator, inp: dict) -> torch.Tensor:
    """Flip, zero-pad and crop, normalise, pixel-mode random erasing, with
    the draws taken from ``gen`` in the train step's order."""
    dev = x_u8.device
    B, H, W, _ = x_u8.shape
    x = x_u8.to(torch.float32) / 255.0
    flip = torch.rand((B, 1, 1, 1), generator=gen, device=dev) < inp["prob"]
    x = torch.where(flip, x.flip(2), x)
    p = inp["padding"]
    xp = F.pad(x, (0, 0, p, p, p, p))
    off = torch.randint(0, 2 * p + 1, (2, B), generator=gen, device=dev)
    rows = off[0][:, None, None] + torch.arange(H, device=dev)[None, :, None]
    cols = off[1][:, None, None] + torch.arange(W, device=dev)[None, None, :]
    x = xp[torch.arange(B, device=dev)[:, None, None], rows, cols]
    mean = torch.tensor(inp["pixel_mean"], device=dev)
    std = torch.tensor(inp["pixel_std"], device=dev)
    x = (x - mean) / std
    apply = torch.rand((B,), generator=gen, device=dev) < inp["re_prob"]
    attempts = 10
    area = (0.02 + (1 / 3 - 0.02) * torch.rand((B, attempts), generator=gen, device=dev)) * (H * W)
    lo, hi = math.log(0.3), math.log(1 / 0.3)
    ar = torch.exp(lo + (hi - lo) * torch.rand((B, attempts), generator=gen, device=dev))
    hs = torch.round(torch.sqrt(area * ar)).to(torch.int64)
    ws = torch.round(torch.sqrt(area / ar)).to(torch.int64)
    valid = (hs < H) & (ws < W)
    first = valid.to(torch.uint8).argmax(1, keepdim=True)
    h, w = hs.gather(1, first)[:, 0], ws.gather(1, first)[:, 0]
    do = apply & valid.any(1)
    top = torch.floor(torch.rand((B,), generator=gen, device=dev) * (H - h + 1)).to(torch.int64)
    left = torch.floor(torch.rand((B,), generator=gen, device=dev) * (W - w + 1)).to(torch.int64)
    r = torch.arange(H, device=dev)[None, :, None]
    c = torch.arange(W, device=dev)[None, None, :]
    box = ((r >= top[:, None, None]) & (r < (top + h)[:, None, None])
           & (c >= left[:, None, None]) & (c < (left + w)[:, None, None]))
    noise = torch.randn(x.shape, generator=gen, device=dev, dtype=torch.float32)
    return torch.where((box & do[:, None, None])[..., None], noise, x)


def train_steps(P, Bf, batches, epochs, seed: int, s: Shape, cfg: dict, ar: Arith,
                remat: bool = True):
    """Run the train steps on ``batches`` (uint8 images, 'pid', 'camid')
    from parameters ``P`` (updated in place). Returns (losses, first step's
    gradients by name)."""
    dev = next(iter(P.values())).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    sol, inp = cfg["solver"], cfg["input"]
    bufs: Dict[str, torch.Tensor] = {}
    losses, first = [], None
    for batch, epoch in zip(batches, epochs):
        images = {k: augment(batch[k], gen, inp) for k in MODS}
        B = batch["pid"].shape[0]
        draws = torch.rand((s.depth, 2, len(MODS) * B, 1, 1), generator=gen, device=dev)
        for w in P.values():
            w.grad = None
        with torch.enable_grad():
            pairs, aux = forward(P, Bf, images, batch["camid"], s, ar, training=True,
                                 labels=batch["pid"], draws=draws, remat=remat)
            loss = total_loss(pairs, aux, batch["pid"], s.K)
            trainable = [w for n, w in P.items() if not frozen(n)]
            loss.backward(inputs=trainable)
        grads = {n: w.grad for n, w in P.items() if w.grad is not None}
        if first is None:
            first = {n: g.clone() for n, g in grads.items()}
        sgd_step(P, grads, bufs, learning_rate(epoch, sol), sol)
        losses.append(float(loss.detach()))
    for w in P.values():
        w.grad = None
    return losses, first


# ---------------------------------------------------------------- evaluation


def features(P, Bf, images_u8: Dict[str, torch.Tensor], cams, s: Shape, cfg: dict,
             ar: Arith, rows: int = 64) -> torch.Tensor:
    """The [R, 3C] features of every row, ``rows`` at a time."""
    inp = cfg["input"]
    dev = cams.device
    mean = torch.tensor(inp["pixel_mean"], device=dev)
    std = torch.tensor(inp["pixel_std"], device=dev)
    out = []
    with torch.no_grad():
        for a in range(0, cams.shape[0], rows):
            imgs = {k: (images_u8[k][a:a + rows].to(torch.float32) / 255.0 - mean) / std
                    for k in MODS}
            out.append(forward(P, Bf, imgs, cams[a:a + rows], s, ar))
    return torch.cat(out)


def cmc_map(qf, gf, q_pids, g_pids, q_cams, g_cams, max_rank: int = 50):
    """Market-1501 protocol: gallery entries with the query's pid and camera
    left out; CMC [max_rank] and mAP over the queries with a match, from
    fp64 distances, query by query."""
    qf, gf = qf.double(), gf.double()
    dist = ((qf * qf).sum(1, keepdim=True) + (gf * gf).sum(1)[None]
            - 2.0 * qf @ gf.t()).cpu().numpy()
    q_pids, g_pids = q_pids.cpu().numpy(), g_pids.cpu().numpy()
    q_cams, g_cams = q_cams.cpu().numpy(), g_cams.cpu().numpy()
    cmc, aps = np.zeros(max_rank), []
    for i in range(dist.shape[0]):
        order = np.argsort(dist[i], kind="stable")
        keep = ~((g_pids[order] == q_pids[i]) & (g_cams[order] == q_cams[i]))
        hits = (g_pids[order] == q_pids[i])[keep].astype(np.float64)
        if not hits.any():
            continue
        first = int(np.flatnonzero(hits)[0])
        if first < max_rank:
            cmc[first:] += 1
        prec = np.cumsum(hits) / np.arange(1, hits.size + 1)
        aps.append(float((prec * hits).sum() / hits.sum()))
    return cmc / len(aps), float(np.mean(aps))
