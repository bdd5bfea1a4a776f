"""Pipeline parallelism, the GPipe schedule: counterpart of
``editor_tpu/parallel/pipeline.py`` (reference: distributed/pipeline/sync/,
``Pipe`` with chunked microbatches, pipe.py:172; activation checkpointing,
checkpoint.py:253; the profile-based balance, _balance/).

One process per stage. The mesh's 'stage' group (``parallel.mesh.make_mesh(
stage=S)``, or a process group taken as the axis) orders the stages by its
group rank; each rank holds only its own stage's parameters and runs its
stage function on the M microbatches in order: stage 0 takes them from the
batch, every later stage receives them from the stage before it, and the
last stage's outputs are broadcast to every stage, so that whatever follows
the pipeline runs replicated on each. The schedule runs only real
microbatches: the JAX module's M + S - 1 clock ticks include bubbles that a
stage computes and masks, and the function without them is the same. So a
stateful stage function sees ``valid`` True on every call, and its state
counts exactly the M microbatches.

The backward is the mirrored schedule, inside one autograd Function: the
last stage takes the gradient of the broadcast result (once: every rank
computes the same loss from it, and only the last stage's gradient enters
the pipeline), each stage back-propagates its microbatches and sends the
gradient of its inputs to the stage before it. So the loss must depend on
the result on every rank, and every rank must run the backward. With
``remat`` a stage keeps only its microbatch inputs and recomputes its
forward in the backward, as ``jax.checkpoint`` of the stage function does.
Every rank issues its point-to-point calls in the same order in both
passes (receive, compute, send; microbatches 0..M-1 forward, M-1..0
backward), which is what NCCL needs not to hang. While a stage recomputes,
:func:`is_recomputing` is True (the reference's ``is_recomputing``,
pipeline/sync/checkpoint.py): only the recomputed outputs that take a
gradient are used, so a stage may skip the work of the others.

Between stages only the activation leaves that carry a gradient send one
back: the first microbatch's exchange carries each leaf's flag, and the
last stage broadcasts its flags with the result.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from editor_tpu_torch.parallel import collectives as C
from editor_tpu_torch.parallel.mesh import axis_group

_WARM: set = set()
_STATE = threading.local()


def is_recomputing() -> bool:
    """True while :func:`pipeline_apply` recomputes a stage's forward in the
    backward (``remat``)."""
    return getattr(_STATE, "recomputing", False)


@contextlib.contextmanager
def _recomputing():
    _STATE.recomputing = True
    try:
        yield
    finally:
        _STATE.recomputing = False


def _warm(pg) -> None:
    """The first call on an NCCL group must involve every rank of it (a
    pair's P2P would set up the communicator on two ranks only): one
    all-reduce over the stage group before its first point-to-point call."""
    if pg in _WARM:
        return
    if dist.get_backend(pg) == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
        C._all_reduce_(torch.zeros(1, device=dev), pg)
    _WARM.add(pg)


def param_leaves(stage_params: Any) -> List[torch.Tensor]:
    """The tensors of ``stage_params`` that take a gradient: an
    ``nn.Module``'s parameters, or a pytree's tensor leaves."""
    if isinstance(stage_params, nn.Module):
        leaves = list(stage_params.parameters())
    else:
        leaves = [t for t in tree_flatten(stage_params)[0] if isinstance(t, torch.Tensor)]
    return [t for t in leaves if t.requires_grad]


class _Schedule:
    """One call's GPipe schedule on this rank (see the module docstring)."""

    def __init__(self, fn, stage_params, pg, S: int, stage: int, M: int, remat: bool,
                 treedef, x_leaves: Sequence[torch.Tensor], state):
        self.fn, self.params, self.pg = fn, stage_params, pg
        self.S, self.stage, self.M, self.remat = S, stage, M, remat
        self.treedef, self.state = treedef, state
        self.shapes = [(t.shape, t.dtype, t.device) for t in x_leaves]
        self.B = x_leaves[0].shape[0]
        self.mb = self.B // M
        self.params_g = param_leaves(stage_params)
        self.saved: list = []

    # -- helpers ---------------------------------------------------------
    def _empty(self, rows: int, which=None) -> List[torch.Tensor]:
        idx = range(len(self.shapes)) if which is None else which
        return [torch.empty((rows,) + tuple(self.shapes[j][0][1:]), dtype=self.shapes[j][1],
                            device=self.shapes[j][2]) for j in idx]

    def _flags_tensor(self, flags) -> torch.Tensor:
        return torch.tensor([int(f) for f in flags], dtype=torch.int32,
                            device=self.shapes[0][2])

    def _call(self, inp: List[torch.Tensor], state):
        out, state = self.fn(self.params, tree_unflatten(inp, self.treedef), state, True)
        out_leaves, out_def = tree_flatten(out)
        if out_def != self.treedef or any(
                o.shape != (self.mb,) + tuple(s[0][1:]) or o.dtype != s[1]
                for o, s in zip(out_leaves, self.shapes)):
            raise ValueError("a stage must return activations of its input's structure, "
                             "shapes and dtypes (the GPipe partition)")
        return out_leaves, tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                                    else t, state)

    # -- forward -----------------------------------------------------------
    def forward(self, x_leaves: Sequence[torch.Tensor], keep_graph: bool):
        """Runs this stage's microbatches; returns the result leaves (the
        last stage's outputs, broadcast) and sets ``self.out_flags``."""
        S, s, M, mb = self.S, self.stage, self.M, self.mb
        if S > 1:
            _warm(self.pg)
        self.in_flags = [t.requires_grad and t.is_floating_point() for t in x_leaves]
        result = self._empty(self.B)
        flags = None
        state = self.state
        for i in range(M):
            rows = slice(i * mb, (i + 1) * mb)
            if s == 0:
                inp = [t[rows].detach() for t in x_leaves]
            else:
                inp = self._empty(mb)
                extra = [self._flags_tensor(self.in_flags)] if i == 0 else []
                C._exchange([], None, extra + inp, s - 1, self.pg)
                if i == 0:
                    self.in_flags = [bool(f) for f in extra[0].tolist()]
            if keep_graph:
                inp = [t.requires_grad_(f) for t, f in zip(inp, self.in_flags)]
            # under remat the first microbatch still builds its graph (then
            # drops it), to learn which outputs take a gradient
            track = keep_graph and (not self.remat or i == 0)
            with torch.enable_grad() if track else torch.no_grad():
                out, new_state = self._call(inp, state)
            if keep_graph:
                self.saved.append((inp, state if self.remat else out))
            state = new_state
            if flags is None:
                flags = [o.requires_grad for o in out]
            out = [o.detach() for o in out]
            if s < S - 1:
                extra = [self._flags_tensor(flags)] if i == 0 else []
                C._exchange(extra + out, s + 1, [], None, self.pg)
            else:
                for r, o in zip(result, out):
                    r[rows].copy_(o)
        self.state = state
        self.out_flags = flags
        if S > 1:
            fl = self._flags_tensor(flags if s == S - 1 else [0] * len(result))
            C._broadcast_(fl, S - 1, self.pg)
            self.result_flags = [bool(f) for f in fl.tolist()]
            for r in result:
                C._broadcast_(r, S - 1, self.pg)
        else:
            self.result_flags = flags
        return result

    # -- backward ----------------------------------------------------------
    def backward(self, grads: Sequence[Optional[torch.Tensor]]):
        """The mirrored schedule: (gradients of the x leaves, of the
        parameter leaves)."""
        S, s, M, mb = self.S, self.stage, self.M, self.mb
        out_idx = [j for j, f in enumerate(self.out_flags) if f]
        in_idx = [j for j, f in enumerate(self.in_flags) if f]
        gx = [torch.zeros(sh, dtype=dt, device=dev) if f else None
              for (sh, dt, dev), f in zip(self.shapes, self.in_flags)] if s == 0 else None
        gp: List[Optional[torch.Tensor]] = [None] * len(self.params_g)
        for i in reversed(range(M)):
            rows = slice(i * mb, (i + 1) * mb)
            if s == S - 1:
                g_out = [grads[j][rows] if grads[j] is not None
                         else torch.zeros_like(self.saved[i][0][j]) for j in out_idx]
            else:
                g_out = self._empty(mb, out_idx)
                C._exchange([], None, g_out, s + 1, self.pg)
            inp, kept = self.saved[i]
            if self.remat:
                inp = [t.detach().requires_grad_(f) for t, f in zip(inp, self.in_flags)]
                with torch.enable_grad(), _recomputing():
                    out, _ = self._call(inp, kept)
            else:
                out = kept
            pairs = [(out[j], g) for j, g in zip(out_idx, g_out) if out[j].requires_grad]
            wrt = [inp[j] for j in in_idx] + self.params_g
            if pairs and wrt:
                got = torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                          allow_unused=True)
            else:
                got = [None] * len(wrt)
            g_in = [g if g is not None else torch.zeros_like(inp[j])
                    for j, g in zip(in_idx, got[:len(in_idx)])]
            for k, g in enumerate(got[len(in_idx):]):
                if g is not None:
                    gp[k] = g if gp[k] is None else gp[k] + g
            if s > 0:
                C._exchange(g_in, s - 1, [], None, self.pg)
            else:
                for j, g in zip(in_idx, g_in):
                    gx[j][rows].copy_(g)
            self.saved[i] = None
        return gx, gp


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, n_x: int, *tensors):
        result = sched.forward(tensors[:n_x], keep_graph=True)
        ctx.sched, ctx.n_x = sched, n_x
        ctx.mark_non_differentiable(*[r for r, f in zip(result, sched.result_flags) if not f])
        return tuple(result)

    @staticmethod
    def backward(ctx, *grads):
        gx, gp = ctx.sched.backward(grads)
        gx = gx if gx is not None else [None] * ctx.n_x
        return (None, None, *gx, *gp)


def pipeline_apply(stage_fn: Callable[..., Any], stage_params: Any, x: Any, mesh,
                   num_microbatches: int, axis_name: str = "stage", remat: bool = False,
                   stage_state: Any = None) -> Any:
    """Run ``x`` through the S pipeline stages of ``mesh``'s ``axis_name``
    dimension (a ``DeviceMesh``, or a process group taken as the axis).

    ``stage_fn(params, activations) -> activations``, the same structure,
    shapes and dtypes out as in; with ``stage_state`` the stateful form
    ``(params, activations, state, valid) -> (activations, state)``, where
    ``state`` is this stage's state carried from microbatch to microbatch
    and ``valid`` is True (the schedule runs no bubbles). ``stage_params``:
    THIS rank's stage's parameters, a pytree of tensors or an ``nn.Module``
    (the JAX function's stacked [S, ...] leaves, one slice per rank).
    ``x``: a tensor or a pytree of tensors sharing their leading batch dim
    B, which ``num_microbatches`` must divide; every rank passes the same
    (stage 0's is read). Returns the last stage's output on every rank, the
    structure of ``x`` (and this stage's final state with ``stage_state``).
    With gradients enabled the call is differentiable in ``x`` and in
    ``stage_params``, and every rank must take the backward."""
    leaves, treedef = tree_flatten(x)
    B = leaves[0].shape[0]
    if any(t.shape[0] != B for t in leaves):
        raise ValueError("all activation leaves need the same batch dim")
    if B % num_microbatches:
        raise ValueError(f"batch {B} not divisible by {num_microbatches}")
    pg, S = axis_group(mesh, axis_name)
    stage = dist.get_rank(pg)
    stateful = stage_state is not None
    if stateful:
        fn = stage_fn
    else:
        def fn(p, a, st, valid):  # noqa: ANN001 - the stateful form with no state
            del st, valid
            return stage_fn(p, a), None
    sched = _Schedule(fn, stage_params, pg, S, stage, num_microbatches, remat, treedef,
                      leaves, stage_state)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in leaves + sched.params_g)
    if grad:
        result = _Pipeline.apply(sched, len(leaves), *leaves, *sched.params_g)
    else:
        result = sched.forward(leaves, keep_graph=False)
    out = tree_unflatten(list(result), treedef)
    return (out, sched.state) if stateful else out


def pipeline_train_step(stage_fn: Callable[..., Any], loss_fn: Callable[[Any], torch.Tensor],
                        mesh, num_microbatches: int, axis_name: str = "stage",
                        remat: bool = True) -> Callable:
    """``step(stage_params, x) -> (loss, grads)``: the loss of the pipeline's
    output (computed on every rank) and the gradient of each of this rank's
    ``param_leaves(stage_params)`` (zeros where a leaf has none), training
    through the pipeline; ``remat`` recomputes each microbatch's stage
    forward in the backward (the reference's 'always' checkpoint mode)."""

    def step(stage_params, x):
        leaves = param_leaves(stage_params)
        out = pipeline_apply(stage_fn, stage_params, x, mesh, num_microbatches, axis_name,
                             remat=remat)
        loss = loss_fn(out)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    return step


# ---------------------------------------------------------------------------
# cross-stage skip tensors (reference pipeline/sync/skip/skippable.py:52,
# portal.py:29): a skip is a named slot of the activation pytree that travels
# with its microbatch; intermediate stages relay it, and its gradient comes
# back through the same relay
# ---------------------------------------------------------------------------

def init_skips(batch: int, templates: dict) -> dict:
    """Zero-filled skip slots for :func:`pipeline_apply`'s activations:
    ``{name: [d1, ...] template}`` -> ``{name: zeros [batch, d1, ...]}`` of
    the template's dtype and device."""
    return {name: torch.zeros((batch,) + tuple(t.shape), dtype=t.dtype, device=t.device)
            for name, t in templates.items()}


def stash(skips: dict, name: str, value: torch.Tensor) -> dict:
    """Write a named skip slot (reference ``yield stash(name, tensor)``,
    skippable.py:310); the slot must exist and ``value`` match its shape."""
    if name not in skips:
        raise KeyError(f"skip slot {name!r} not declared (init_skips)")
    if skips[name].shape != value.shape:
        raise ValueError(f"skip {name!r}: stash shape {tuple(value.shape)} != slot "
                         f"{tuple(skips[name].shape)}")
    out = dict(skips)
    out[name] = value
    return out


def pop(skips: dict, name: str):
    """Read a named skip slot and zero it (reference ``yield pop(name)``,
    skippable.py:332): ``(value, skips)``."""
    if name not in skips:
        raise KeyError(f"skip slot {name!r} not declared (init_skips)")
    value = skips[name]
    out = dict(skips)
    out[name] = torch.zeros_like(value)
    return value, out


# ---------------------------------------------------------------------------
# balance (reference _balance/blockpartition.py:18, profile.py:44)
# ---------------------------------------------------------------------------

def balance_stages(costs: Sequence[float], num_stages: int) -> List[int]:
    """Contiguous blocks of layers minimising the largest block's cost: the
    number of layers per stage (O(n^2 S) dynamic programme)."""
    n = len(costs)
    if num_stages > n:
        raise ValueError("more stages than layers")
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    INF = float("inf")
    dp = [[INF] * (n + 1) for _ in range(num_stages + 1)]
    cut = [[0] * (n + 1) for _ in range(num_stages + 1)]
    dp[0][0] = 0.0
    for s in range(1, num_stages + 1):
        for j in range(s, n + 1):
            for i in range(s - 1, j):
                cand = max(dp[s - 1][i], prefix[j] - prefix[i])
                if cand < dp[s][j]:
                    dp[s][j] = cand
                    cut[s][j] = i
    sizes = []
    j = n
    for s in range(num_stages, 0, -1):
        i = cut[s][j]
        sizes.append(j - i)
        j = i
    return list(reversed(sizes))


@torch.no_grad()
def profile_layer_costs(layer_fns: Sequence[Callable], x: torch.Tensor,
                        iters: int = 3) -> List[float]:
    """Seconds per call of each layer, each fed its predecessor's output
    (reference _balance/profile.py:44): CUDA events for a CUDA ``x``, the
    host clock otherwise; one untimed call first."""
    costs = []
    cuda = x.is_cuda
    for fn in layer_fns:
        y = fn(x)
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        for _ in range(iters):
            y = fn(x)
        if cuda:
            end.record()
            end.synchronize()
            costs.append(start.elapsed_time(end) / 1e3 / iters)
        else:
            costs.append((time.perf_counter() - t0) / iters)
        x = y
    return costs
