"""Expert parallelism: the GShard mixture-of-experts layer, counterpart of
``editor_tpu/parallel/moe.py``.

The router takes fp32 logits, a softmax, the top k = 2 experts per token and
renormalises their gates; the aux loss is Switch's load-balance loss
``E * sum_e f_e p_e`` (f: the share of tokens whose first choice is e, p:
the mean router probability of e). Each expert has ``capacity`` slots; a
(token, choice) pair takes the next slot of its expert in the flat (token,
choice) order, and the pairs at or past capacity are dropped (gate 0: the
residual carries the token). Capacity is ``int(capacity_factor * k * T / E)
or 1``. The expert FFN is ``gelu(x w1 + b1) w2 + b2`` (JAX's default, tanh
GELU), in fp32 as JAX computes it.

JAX builds the dispatch as a one-hot ``[T, K, E, C]`` tensor and two
einsums; at the flagship's joint block (T = 33,792, E = 8, C = 16,896) that
is ~36 GB. Here the slots come from a cumsum over a ``[T*K, E]`` one-hot,
the tokens are copied into the ``[E, C, D]`` buffer by index
(:func:`dispatch`) and the outputs read back by index (:func:`combine`): the
same numbers, nothing of size T*E*C. The routing and the expert products are
plain PyTorch, as they are plain XLA in JAX (no Pallas kernel).

* :func:`moe_ffn_dense`: every expert on this device; with ``group`` (a
  data mesh or process group) the tokens are this rank's rows of a global
  batch and the routing is the global batch's: the slots start after the
  ranks before (an all-gather of each rank's per-expert counts), capacity
  comes from the global T and the aux loss's means are all-reduced.
* :func:`moe_ffn`: experts sharded over an 'expert' group: each rank takes
  its T/S tokens (its own capacity), one autograd ``all_to_all`` sends each
  expert's buffer to its owner, its E/S experts run, one ``all_to_all``
  brings the outputs back, and they are all-gathered into [T, D].
* :func:`moe_ffn_shards`: S independent shards of T/S tokens on one device,
  each with its own capacity, the aux loss the mean of the shards' (the
  one-device twin of :func:`moe_ffn`).

Beside a data group (``group=``; JAX jits these functions over a batch
sharded on a 'data' axis, which only places rows) x is this rank's rows of
a global batch in rank order and the function is the global batch's: each
rank returns its rows of the global y. Where a rank's rows are whole shards
(:func:`moe_ffn` whose 'expert' group is the data group, the GShard layout;
:func:`moe_ffn_shards` with S a multiple of the data size) they are routed
here and nothing is gathered; otherwise (a 2-D ('data', 'expert') mesh,
where every expert rank of a data row holds the same rows) the rows are
all-gathered over the data group, the function runs on the global tokens,
and the rank keeps its rows.

Gradients follow ``collectives``: a rank's gradient is that of the sum of
every rank's loss, so where every rank of a group computes the same loss,
the mean over the group of the ranks' gradients is the loss's gradient.
With a data group, a rank's y rows are its share of the global function,
and the gathers' backward (a reduce-scatter) hands each rank the gradient
of its own rows, as the global-batch step expects.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from editor_tpu_torch.parallel import collectives as C


class MoEParams(NamedTuple):
    router: torch.Tensor  # [D, E]
    w1: torch.Tensor      # [E, D, F]
    b1: torch.Tensor      # [E, F]
    w2: torch.Tensor      # [E, F, D]
    b2: torch.Tensor      # [E, D]


def moe_init(dim: int, hidden: int, num_experts: int, generator: torch.Generator,
             dtype=torch.float32, device=None) -> MoEParams:
    """JAX's distributions: router normal * 0.02, w1 normal * sqrt(2 / dim),
    w2 normal * sqrt(2 / hidden), biases zero (drawn on the CPU from
    ``generator``, in that order)."""
    E = num_experts

    def normal(shape, std):
        return (torch.randn(shape, generator=generator) * std).to(dtype=dtype, device=device)

    return MoEParams(router=normal((dim, E), 0.02),
                     w1=normal((E, dim, hidden), (2.0 / dim) ** 0.5),
                     b1=torch.zeros((E, hidden), dtype=dtype, device=device),
                     w2=normal((E, hidden, dim), (2.0 / hidden) ** 0.5),
                     b2=torch.zeros((E, dim), dtype=dtype, device=device))


def capacity_of(T: int, E: int, k: int = 2, capacity_factor: float = 2.0) -> int:
    return int(capacity_factor * k * T / E) or 1


def route(router: torch.Tensor, x: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, D] -> (gates [T, k] renormalised, expert ids [T, k] int64,
    router probabilities [T, E] fp32)."""
    logits = x.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: ties go to the lower expert (a masked token's zero
    # row ties every expert), which torch.topk does not promise
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    return gates / gates.sum(dim=-1, keepdim=True), idx, probs


def aux_loss(idx: torch.Tensor, probs: torch.Tensor, E: int, group=None) -> torch.Tensor:
    """Switch's load-balance loss ``E * sum(f * p)``; with ``group`` both
    means over every rank's tokens."""
    sel1 = F.one_hot(idx[:, 0], E).to(torch.float32)
    if group is None:
        f, p = sel1.mean(dim=0), probs.mean(dim=0)
    else:  # every rank holds as many tokens
        T = idx.shape[0] * dist.get_world_size(C._pg(group))
        f = C.all_reduce(sel1.sum(dim=0), group).detach() / T
        p = C.all_reduce(probs.sum(dim=0), group) / T
    return E * (f * p).sum()


def slots(idx: torch.Tensor, E: int, offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The slot of each (token, choice) pair in its expert's buffer [T, K]:
    the number of pairs routed to that expert before it in the flat (token,
    choice) order, plus ``offset[e]`` (the pairs of earlier ranks)."""
    T, K = idx.shape
    flat = F.one_hot(idx.reshape(-1), E)                  # [T*K, E]
    pos = (torch.cumsum(flat, dim=0) - flat).mul_(flat).sum(dim=-1).reshape(T, K)
    return pos if offset is None else pos + offset[idx]


def dispatch(x: torch.Tensor, idx: torch.Tensor, pos: torch.Tensor, E: int, capacity: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The [E, capacity, D] expert buffers: token t in slot ``pos[t, j]`` of
    expert ``idx[t, j]`` for every pair with ``pos < capacity``, zeros
    elsewhere (JAX's ``einsum("td,tec->ecd", x, dispatch)``). Returns (the
    buffers, each pair's flat buffer row: ``e * capacity + pos``, or
    ``E * capacity`` for a dropped pair)."""
    T, K = idx.shape
    D = x.shape[-1]
    keep = pos < capacity
    row = torch.where(keep, idx * capacity + pos, torch.full_like(pos, E * capacity))
    src = x[:, None, :].expand(T, K, D).reshape(T * K, D)
    buf = torch.zeros((E * capacity + 1, D), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, row.reshape(-1), src)  # kept rows are unique; row E*C is the bin
    return buf[:-1].reshape(E, capacity, D), row


def combine(ye: torch.Tensor, row: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """y [T, D] = sum over a token's kept pairs of gate * its expert's output
    in its slot (JAX's ``einsum("ecd,tec->td", ye, combine)``)."""
    T, K = row.shape
    E, Cap, D = ye.shape
    flat = torch.cat([ye.reshape(E * Cap, D), ye.new_zeros((1, D))])
    g = flat.index_select(0, row.reshape(-1)).reshape(T, K, D)
    w = torch.where(row < E * Cap, gates.to(ye.dtype), torch.zeros_like(gates, dtype=ye.dtype))
    return (g * w[..., None]).sum(dim=1)


def expert_ffn(w1, b1, w2, b2, x: torch.Tensor) -> torch.Tensor:
    """x [E, n, D] through each expert: gelu(x w1 + b1) w2 + b2, in fp32."""
    f32 = torch.float32
    h = torch.bmm(x, w1.to(f32)) + b1.to(f32)[:, None, :]
    return torch.bmm(F.gelu(h, approximate="tanh"), w2.to(f32)) + b2.to(f32)[:, None, :]


def moe_ffn_dense(params: MoEParams, x: torch.Tensor, k: int = 2,
                  capacity_factor: float = 2.0, capacity: Optional[int] = None,
                  group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, D] -> (y [T, D] in x's dtype, aux loss), every expert on this
    device. ``capacity`` overrides the derived slot count (the per-shard
    oracle). ``group``: x is this rank's rows of a global batch (ranks in
    order), routed as the global batch (module docstring)."""
    T, D = x.shape
    E = params.router.shape[-1]
    xf = x.to(torch.float32)
    gates, idx, probs = route(params.router, x, k)
    offset = None
    T_all = T
    if group is not None:
        counts = torch.bincount(idx.reshape(-1), minlength=E)
        every = C.all_gather(counts, group, tiled=False)       # [W, E]
        r = dist.get_rank(C._pg(group))
        offset = every[:r].sum(dim=0)
        T_all = T * every.shape[0]
    cap = capacity if capacity is not None else capacity_of(T_all, E, k, capacity_factor)
    aux = aux_loss(idx, probs, E, group)
    xe, row = dispatch(xf, idx, slots(idx, E, offset), E, cap)
    ye = expert_ffn(params.w1, params.b1, params.w2, params.b2, xe)
    return combine(ye, row, gates).to(x.dtype), aux


def _group_rank(group) -> Tuple[int, int]:
    """(rank, size) of this process in the data ``group``."""
    pg = C._pg(group)
    return dist.get_rank(pg), dist.get_world_size(pg)


def moe_ffn_shards(params: MoEParams, x: torch.Tensor, shards: int, k: int = 2,
                   capacity_factor: float = 2.0, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, D] as ``shards`` S consecutive shards of T/S tokens, each routed
    by :func:`moe_ffn_dense` with the capacity of T/S tokens; the aux loss is
    the mean of the shards'. With ``group`` (module docstring) T is the
    global batch's: shards inside this rank's rows run here, else the rows
    are gathered."""
    S, n = shards, x.shape[0]
    r, W = _group_rank(group) if group is not None else (0, 1)
    if (n * W) % S:
        raise ValueError(f"tokens {n * W} not divisible by moe_shards={S}")
    Ts = n * W // S
    cap = capacity_of(Ts, params.router.shape[-1], k, capacity_factor)
    gather = group is not None and n % Ts != 0
    z = C.all_gather(x, group) if gather else x
    outs = [moe_ffn_dense(params, t, k, capacity=cap) for t in z.split(Ts)]
    y = torch.cat([o[0] for o in outs])
    aux = torch.stack([o[1] for o in outs]).mean()
    if gather:
        y = y[r * n:(r + 1) * n]
    elif group is not None:
        aux = C.all_reduce(aux, group, "mean")
    return y, aux


def moe_ffn(params: MoEParams, x: torch.Tensor, mesh, k: int = 2,
            capacity_factor: float = 2.0, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over ``mesh``'s 'expert' group (a ``DeviceMesh``
    with an 'expert' dimension, or a process group) of S ranks: x [T, D],
    the same on every rank; rank r routes tokens ``r*T/S:(r+1)*T/S`` with a
    capacity from T/S, its experts ``r*E/S:(r+1)*E/S`` run every rank's
    tokens routed to them, and y [T, D] comes back all-gathered; the aux
    loss is the mean of the ranks'. The same function as ``moe_shards`` = S
    on one device. ``group``: a data group beside it (module docstring);
    where the expert group is the data group (the same ranks in the same
    order) x is this rank's shard, and y its rows, without a gather."""
    from editor_tpu_torch.parallel.mesh import axis_group
    pg, S = axis_group(mesh, "expert")
    E = params.router.shape[-1]
    if E % S:
        raise ValueError(f"experts {E} not divisible by expert={S}")
    local = group is not None and (dist.get_process_group_ranks(C._pg(group))
                                   == dist.get_process_group_ranks(pg))
    rows = x.shape[0]
    if group is not None and not local:
        x = C.all_gather(x, group)  # the global batch's tokens, rank-major
    T = rows * S if local else x.shape[0]
    if T % S:
        raise ValueError(f"tokens {T} not divisible by expert={S}")
    r = dist.get_rank(pg)
    Tl, El = T // S, E // S
    cap = capacity_of(Tl, E, k, capacity_factor)
    xl = x if local else x[r * Tl:(r + 1) * Tl]
    gates, idx, probs = route(params.router, xl, k)
    aux = C.all_reduce(aux_loss(idx, probs, E), pg, "mean")
    xe, row = dispatch(xl.to(torch.float32), idx, slots(idx, E), E, cap)
    D = xe.shape[-1]
    xr = C.all_to_all(xe, pg, 0, 0)                           # [(source, local e), C, D]
    xr = xr.reshape(S, El, cap, D).transpose(0, 1).reshape(El, S * cap, D)
    sl = slice(r * El, (r + 1) * El)
    ye = expert_ffn(params.w1[sl], params.b1[sl], params.w2[sl], params.b2[sl], xr)
    ye = ye.reshape(El, S, cap, D).transpose(0, 1).reshape(S * El, cap, D)
    yr = C.all_to_all(ye, pg, 0, 0)                           # [E, C, D], my tokens
    y = combine(yr, row, gates).to(x.dtype)
    if local:
        return y, aux
    y = C.all_gather(y, pg, axis=0)
    if group is not None:
        d = _group_rank(group)[0]
        y = y[d * rows:(d + 1) * rows]
    return y, aux
