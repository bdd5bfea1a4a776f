"""One rank of the port's data-parallel CPU tests (gloo), run as

    python tests/torch_dp_worker.py <scenario> <rank> <world> <dir>

by ``tests/torch_dp.py::run_ranks``. It reads ``<dir>/inputs.pt``, joins the
group through ``file://<dir>/rendezvous``, runs the scenario and writes
``<dir>/out_<rank>.pt``. Under ``cli.launch`` it runs as

    python tests/torch_dp_worker.py --launched <scenario> <dir>

takes its rank from the launcher's environment, joins the group there
(the CLIs do) and writes ``<dir>/out_<rank>_<incarnation>.pt``. It imports
torch and the port only (no JAX): the JAX oracles run in the pytest
process.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from editor_tpu_torch.parallel import collectives as C  # noqa: E402
from editor_tpu_torch.parallel import multihost  # noqa: E402

def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# collectives and reducers
# ---------------------------------------------------------------------------

def collectives(inp, rank, world, out_dir):
    """Each collective on this rank's x (float64), its value and, for the
    differentiable ones, the gradient of sum(y * w) on this rank."""
    out = {}
    for name, spec in inp["cases"].items():
        x = _t(spec["x"][rank]).clone().requires_grad_(True)
        fn = getattr(C, spec["fn"])
        y = fn(x, **spec.get("kw", {}))
        out[name] = {"y": y.detach().numpy()}
        if spec.get("grad"):
            (y * _t(spec["w"][rank])).sum().backward()
            out[name]["grad"] = x.grad.numpy()
    out["barrier"] = int(C.barrier())
    return out


def reducers(inp, rank, world, out_dir):
    from editor_tpu_torch.parallel.compression import (_orthogonalize, int8_quantize,
                                                       make_reducer, powersgd_reducer)
    grads = {k: _t(v[rank]) for k, v in inp["grads"].items()}
    out = {}
    for name in ("allreduce", "fp16", "bf16", "int8"):
        red = make_reducer(name)
        got, _ = red.reduce(grads, red.init(grads), None)
        out[name] = {k: v.numpy() for k, v in got.items()}
    out["int8_local"] = {k: tuple(t.numpy() for t in int8_quantize(v)) for k, v in grads.items()}
    ps = powersgd_reducer(rank=inp["powersgd_rank"], min_compression_rate=1.0)
    state = ps.init(grads)
    for k, q in inp["q0"].items():
        state[k]["q"] = _t(q)
    rounds = []
    for _ in range(2):
        got, state = ps.reduce(grads, state, None)
        rounds.append({"out": {k: v.numpy() for k, v in got.items()},
                       "state": {k: {s: t.numpy() for s, t in v.items()}
                                 for k, v in state.items()}})
    out["powersgd"] = rounds
    out["orthogonalize"] = _orthogonalize(_t(inp["ortho"])).numpy()
    return out


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _model(inp):
    from editor_tpu_torch.models.editor import Editor
    model = Editor(inp["ecfg"], device="cpu").to(inp.get("dtype", torch.float64))
    model.load_state_dict(inp["sd"], strict=True)
    return model


def _solver(model, inp):
    from editor_tpu_torch.config import Config
    from editor_tpu_torch.losses import make_loss
    from editor_tpu_torch.solver import make_optimizer, make_scheduler
    cfg = Config()
    if inp.get("optimizer"):
        cfg.SOLVER.OPTIMIZER_NAME = inp["optimizer"]
    return (make_optimizer(cfg, model), make_loss(cfg, inp["ecfg"].num_classes),
            make_scheduler(cfg), cfg.SOLVER.BASE_LR)


def _state(model, opt=None, tp_mesh=None):
    """The model's state_dict, cloned; under FSDP gathered, under tensor
    parallelism gathered into the canonical layout (collectives)."""
    if hasattr(opt, "gathered"):
        with opt.gathered():
            return _state(model, None, tp_mesh)
    if tp_mesh is not None:
        from editor_tpu_torch.parallel.mesh import model_group
        from editor_tpu_torch.parallel.tp import gather_editor_state
        return {k: v.clone() for k, v in gather_editor_state(model,
                                                             model_group(tp_mesh)).items()}
    return {k: v.clone() for k, v in model.state_dict().items()}


def _build(kind, model, inp, mesh, backbone=None):
    from editor_tpu_torch.engine.train import build_train_step
    from editor_tpu_torch.parallel.compression import make_reducer
    from editor_tpu_torch.parallel.ddp import build_ddp_train_step
    from editor_tpu_torch.parallel.zero import zero1_state_shardings
    opt, loss, lr_fn, base_lr = _solver(model, inp)
    dtype = inp.get("dtype", torch.float64)
    if kind == "ddp":
        reducer = make_reducer(inp["reducer"], rank=4)
        if inp.get("whole"):  # an elementwise reducer on the canonical leaves
            import dataclasses
            reducer = dataclasses.replace(reducer, elementwise=False)
        step = build_ddp_train_step(model, opt, loss, lr_fn, base_lr, mesh, reducer=reducer,
                                    compute_dtype=dtype)
        for k, q in inp.get("q0", {}).items():
            step.comm[k]["q"] = _t(q).to(step.comm[k]["q"].dtype)
        return step, opt
    from editor_tpu_torch.engine.train import fsdp_state_shardings
    zero = (zero1_state_shardings(opt, mesh) if kind == "zero1" else
            fsdp_state_shardings(model, opt, mesh) if kind == "fsdp" else None)
    step = build_train_step(model, opt, loss, lr_fn, base_lr, compute_dtype=dtype,
                            grad_accum=inp.get("grad_accum", 1), mesh=mesh,
                            state_shardings=zero,
                            gather_params_compute=inp.get("gather", kind == "fsdp"),
                            backbone=backbone)
    return step, step.optimizer


_MESH = {}


def _mesh(model: int = 1, stage=None):
    """The ('data', 'model') mesh over every rank with that model axis (with
    ``stage``, the ('data', 'stage', 'model') mesh), made once a process."""
    from editor_tpu_torch.parallel.mesh import make_mesh
    if (model, stage) not in _MESH:
        _MESH[model, stage] = make_mesh(-1, model, stage=stage)
    return _MESH[model, stage]


def _train_run(spec, rank, world):
    """One run: ``kind`` 'global' | 'zero1' | 'fsdp' | 'ddp' | 'single' for ``steps``
    steps on the global ``batch`` (each rank its rows); ``tp`` > 1: the
    step on a (W / tp, tp) mesh, the model cut by ``shard_editor`` (with
    'ddp', ``whole`` reduces an elementwise reducer on the canonical
    leaves; with 'fsdp', ``gather`` False builds it without
    ``gather_params_compute``); optionally resumed from the checkpoint ``resume`` and
    saving one (``train_state``, rank 0 writes) at ``save_path`` after
    ``save_after`` steps; ``stage``: the pipelined backbone over that many
    stages (``microbatches``) on a (W / (stage tp), stage, tp) mesh. Returns
    losses, accs, lrs and the final state_dict (canonical under tp)."""
    from editor_tpu_torch.parallel.mesh import shard_batch
    from editor_tpu_torch.utils.checkpoint import load_train_state, train_state
    kind, tp, stage = spec["kind"], spec.get("tp", 1), spec.get("stage")
    mesh = None if kind == "single" else _mesh(tp, stage)
    tp_mesh = mesh if tp > 1 else None
    model = _model(spec)
    if tp_mesh is not None:
        from editor_tpu_torch.parallel.tp import shard_editor
        shard_editor(model, tp_mesh)
    backbone = None
    if stage is not None:
        from editor_tpu_torch.parallel.pipeline_vit import make_pipeline_backbone
        backbone = make_pipeline_backbone(mesh, spec["microbatches"])
    step, opt = _build(kind, model, spec, mesh, backbone)
    first = 1
    if spec.get("resume"):
        first = load_train_state(torch.load(spec["resume"], weights_only=False), model, opt,
                                 step.generator, comm=getattr(step, "comm", None),
                                 tp_mesh=tp_mesh) + 1
    batch = {k: _t(v) for k, v in spec["batch"].items()}
    if mesh is not None:
        batch = shard_batch(mesh, batch, 1 if kind == "ddp" else spec.get("grad_accum", 1))
    out = {"loss": [], "acc": [], "lr": [], "sds": [], "collectives": []}
    for epoch in range(first, first + spec["steps"]):
        C.reset_collective_counts()
        m = step(batch, epoch)
        out["collectives"].append(C.collective_counts())
        out["loss"].append(float(m["loss"]))
        out["acc"].append(float(m["acc"]))
        out["lr"].append(float(m["lr"]))
        if kind == "fsdp":  # between steps: this rank's storage and blocks
            from editor_tpu_torch.parallel.zero import state_memory_bytes
            out.setdefault("param_bytes", []).append(opt.param_bytes())
            out.setdefault("slot_bytes", []).append(state_memory_bytes(opt))
            out.setdefault("shards", []).append(
                {leaf.key: leaf.shard.clone() for leaf in opt.leaves})
        out["sds"].append(_state(model, opt, tp_mesh))
        if spec.get("save_after") == epoch:
            payload = train_state(model, opt, step.generator, epoch,
                                  comm=getattr(step, "comm", None), tp_mesh=tp_mesh)
            if rank == 0:
                torch.save(payload, spec["save_path"])
    out["sd"] = _state(model, opt, tp_mesh)
    if kind == "fsdp":  # shard_params of the gathered model = the blocks held
        from editor_tpu_torch.parallel.fsdp import shard_params
        with opt.gathered():
            out["shard_params"] = shard_params(model, mesh)
    if kind == "ddp" and step.comm:
        out["comm"] = {k: {s: t.clone() for s, t in v.items()} for k, v in step.comm.items()}
    if kind == "zero1":
        from editor_tpu_torch.parallel.zero import state_memory_bytes
        out["slot_bytes"] = state_memory_bytes(opt, per_device=True)
        out["slot_bytes_total"] = state_memory_bytes(opt, per_device=False)
    return out


def localsgd(inp, rank, world, out_dir):
    """LocalSGD (``period`` 2) for ``steps`` steps: ``toy`` the JAX test's
    update (w <- w - 0.5 (w - mean(batch)), this rank's row of
    ``arange(W)``), else the single-device train step on this rank's rows
    of the global batch. Each step's metrics and state."""
    from editor_tpu_torch.parallel.localsgd import build_localsgd_train_step
    from editor_tpu_torch.parallel.mesh import shard_batch
    mesh = _mesh()
    if inp.get("toy"):
        w = torch.zeros((), dtype=torch.float64)

        def local_update(batch, epoch):
            target = batch.mean()
            w.copy_(w - 0.5 * (w - target))
            return {"loss": ((w - target) ** 2).mean()}

        step = build_localsgd_train_step(local_update, mesh, period=2, model=[w])
        batch = torch.arange(float(world), dtype=torch.float64).reshape(world, 1)[rank]
        out = []
        for i in range(inp["steps"]):
            m = step(batch, 1, i)
            out.append({"w": float(w), **{k: float(v) for k, v in m.items()}})
        return out
    model = _model(inp)
    local, _ = _build("single", model, inp, None)
    step = build_localsgd_train_step(local, mesh, period=2, model=model)
    batch = shard_batch(mesh, {k: _t(v) for k, v in inp["batch"].items()})
    out = []
    for i in range(inp["steps"]):
        m = step(batch, i + 1, i)
        out.append({"loss": float(m["loss"]), "averaged": float(m["averaged"]),
                    "sd": _state(model)})
    return out


def tp_eval(inp, rank, world, out_dir):
    """The eval step on a (W / tp, tp) mesh with the model cut (features of
    ``batch``, every rank), and ``FeatureExtractor(mesh=)`` on the uint8
    ``request`` against a one-device extractor of the full model."""
    from editor_tpu_torch.engine.evaluate import build_eval_step
    from editor_tpu_torch.parallel.tp import shard_editor
    from editor_tpu_torch.serve import FeatureExtractor
    mesh = _mesh(inp["tp"])
    full = _model(inp)
    model = shard_editor(_model(inp), mesh)
    batch = {k: _t(v) for k, v in inp["batch"].items() if k != "pid"}
    feats = build_eval_step(model, torch.float64, mesh)(batch)
    req = {k: np.asarray(v) for k, v in inp["request"].items()}
    got = FeatureExtractor(model, batch_size=4, compute_dtype=torch.float64, mesh=mesh)(req)
    ref = FeatureExtractor(full, batch_size=4, compute_dtype=torch.float64)(req)
    return {"feats": feats, "served": got, "served_ref": ref}


def _axis_mesh(world, name):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (world,), mesh_dim_names=(name,))


def _grads(loss, leaves):
    """(the loss, the gradient of each of ``leaves``) after one backward."""
    loss.backward()
    return float(loss.detach()), {k: v.grad.clone() for k, v in leaves.items()}


def row_parallel(inp, rank, world, out_dir):
    """``vit._row_parallel`` over every rank at bf16 on this rank's input
    columns of x [.., W*c] and weight [d, W*c] (the bias replicated): the
    output and the gradients of sum(y * g) for x's block, the weight's
    block and the bias."""
    import dataclasses

    import torch.distributed as dist

    from editor_tpu_torch.models.vit import TPGroup, _row_parallel
    c = inp["x"].shape[-1] // world
    x = inp["x"][..., rank * c:(rank + 1) * c].clone().requires_grad_(True)
    lin = dataclasses.make_dataclass("Lin", ["weight", "bias"])(
        inp["w"][:, rank * c:(rank + 1) * c].clone().requires_grad_(True),
        inp["b"].clone().requires_grad_(True))
    y = _row_parallel(x, lin, TPGroup(dist.group.WORLD, world, rank))
    (y.float() * inp["g"].float()).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": lin.weight.grad, "db": lin.bias.grad}


def ring(inp, rank, world, out_dir):
    """Each of ``inp["cases"]`` ({fn: a ``parallel.ring`` function, q, k, v,
    mask?, w}) over a 'seq' mesh of every rank: the output and the
    gradients of sum(out * w) with respect to q, k and v; then
    ``masked_attention_from_qkv(seq_mesh=)`` on an uncompacted length and
    Ulysses on 3 heads (the divisibility errors)."""
    from editor_tpu_torch.ops import masked_attention_from_qkv
    from editor_tpu_torch.parallel import ring as R
    mesh = _axis_mesh(world, "seq")
    out = {}
    for name, case in inp["cases"].items():
        qkv = {k: _t(case[k]).requires_grad_(True) for k in ("q", "k", "v")}
        args = [qkv["q"], qkv["k"], qkv["v"]]
        if "mask" in case:
            args.append(_t(case["mask"]))
        y = getattr(R, case["fn"])(*args, mesh)
        _, g = _grads((y * _t(case["w"])).sum(), qkv)
        out[name] = {"y": y.detach(), "grads": g}
    for key, fn in (("divisibility", lambda: masked_attention_from_qkv(
            torch.zeros(1, 129, 48, dtype=torch.float64),
            torch.ones(1, 129, dtype=torch.float64), 4, 0.25, use_kernels=False,
            seq_mesh=mesh)),
            ("heads", lambda: R.ulysses_attention(*(torch.zeros(1, 3, 8 * world, 4),) * 3,
                                                  mesh))):
        try:
            fn()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out


def _fusion(inp):
    """A ``BlockMask`` of ``inp["fusion"]`` (its state dict, width, experts)
    and its inputs."""
    from editor_tpu_torch.models.fusion import BlockMask
    f = inp["fusion"]
    block = BlockMask(f["dim"], f["num_classes"], mlp_ratio=f["mlp_ratio"],
                      num_heads=f["heads"], num_experts=f.get("experts", 0),
                      device="cpu").to(torch.float64)
    block.load_state_dict(f["sd"], strict=True)
    feats = [_t(x) for x in f["feats"]]
    return block, feats, _t(f["mask"]), _t(f["labels"])


def fusion_parallel(inp, rank, world, out_dir):
    """The fusion block in training over a mesh of every rank: ``seq`` (the
    masked ring) or ``expert`` (``moe_mesh``): the loss mean(fused * proj)
    + OCFR (+ 0.01 aux) and every parameter's gradient."""
    block, feats, mask, labels = _fusion(inp)
    kw = ({"seq_mesh": _axis_mesh(world, "seq")} if inp["axis"] == "seq"
          else {"moe_mesh": _axis_mesh(world, "expert")})
    fused, ocfr, aux = block(feats, mask, False, labels=labels, **kw)
    loss = (fused * _t(inp["fusion"]["proj"])).mean() + ocfr
    loss = loss + (0.0 if aux is None else 0.01 * aux)
    value, grads = _grads(loss, dict(block.named_parameters()))
    return {"loss": value, "grads": grads, "fused": fused.detach()}


def moe(inp, rank, world, out_dir):
    """``moe_ffn`` over an 'expert' mesh of every rank: y, the aux loss and
    the gradients of sum(y * w) + aux with respect to x and each
    parameter."""
    from editor_tpu_torch.parallel.moe import MoEParams, moe_ffn
    leaves = {k: _t(inp["params"][k]).requires_grad_(True) for k in MoEParams._fields}
    leaves["x"] = _t(inp["x"]).requires_grad_(True)
    y, aux = moe_ffn(MoEParams(*(leaves[k] for k in MoEParams._fields)), leaves["x"],
                     _axis_mesh(world, "expert"))
    _, grads = _grads((y * _t(inp["w"])).sum() + aux, leaves)
    return {"y": y.detach(), "aux": float(aux), "grads": grads}


class _Drops:
    """Inside ``with``: the (token, choice) pairs that each
    ``parallel.moe.dispatch`` call on this rank drops (past capacity), in
    ``counts``."""

    def __enter__(self):
        from editor_tpu_torch.parallel import moe as moe_mod
        self.mod, self.real, self.counts = moe_mod, moe_mod.dispatch, []

        def dispatch(x, idx, pos, E, capacity):
            buf, row = self.real(x, idx, pos, E, capacity)
            self.counts.append(int((row == E * capacity).sum()))
            return buf, row

        moe_mod.dispatch = dispatch
        return self

    def __exit__(self, *exc):
        self.mod.dispatch = self.real


def _moe_layouts():
    """The MoE data layouts over 4 ranks: name -> (data group, data rank,
    forward options). 'gshard': the expert group is the data group (2 data
    ranks, two replicas); 'data_expert': a 2-D ('data', 'expert') mesh;
    'shards': ``moe_shards`` 2 under a data group of 2 (each rank's rows a
    shard) and 'shards_gather' under one of 4 (a shard spans two ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    de = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "expert"))
    rd = init_device_mesh("cpu", (2, 2), mesh_dim_names=("rep", "data"))
    d4 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    pair = rd["data"]
    return {"gshard": (pair, pair.get_local_rank(), {"moe_mesh": pair.get_group()}),
            "data_expert": (de, de.get_local_rank("data"), {"moe_mesh": de}),
            "shards": (pair, pair.get_local_rank(), {"moe_shards": 2}),
            "shards_gather": (d4, d4.get_local_rank(), {"moe_shards": 2})}


def _rows(x, rank: int, size: int):
    n = x.shape[0] // size
    return x[rank * n:(rank + 1) * n]


def moe_data(inp, rank, world, out_dir):
    """The MoE beside a data axis on 4 ranks (``_moe_layouts``). Each
    layout: the fusion block of ``inp["fusion"]`` in training on this
    rank's rows of the global batch (the global labels): the loss
    mean(fused * proj) + OCFR + 0.01 aux over the all-gathered fused
    tokens, the fused tokens, the aux loss, every parameter's gradient and
    the pairs dropped here. Then ``editor``: the EDITOR with ``moe_mesh`` on
    the ('data', 'expert') mesh, the train step's loss (every pair through
    ``make_loss`` plus the aux loss) and its gradients (zeros for a
    parameter the loss does not reach)."""
    from editor_tpu_torch.losses import make_loss
    from editor_tpu_torch.config import Config
    out = {}
    layouts = _moe_layouts()
    for name, (group, r, kw) in layouts.items():
        size = 4 if name == "shards_gather" else 2
        block, feats, mask, labels = _fusion(inp)
        with _Drops() as drops:
            fused, ocfr, aux = block([_rows(f, r, size) for f in feats], _rows(mask, r, size),
                                     False, labels=labels, batch_group=group, **kw)
        fused = C.all_gather(fused, group)
        loss = (fused * _t(inp["fusion"]["proj"])).mean() + ocfr + 0.01 * aux
        value, grads = _grads(loss, dict(block.named_parameters()))
        out[name] = {"loss": value, "fused": fused.detach(), "aux": float(aux),
                     "grads": grads, "drops": sum(drops.counts)}
    group, r, _ = layouts["data_expert"]
    model = _model(inp["editor"])
    batch = {k: _t(v) for k, v in inp["editor"]["batch"].items()}
    labels = batch["pid"]
    images = {k: _rows(batch[k], r, 2) for k in ("RGB", "NI", "TI")}
    res = model(images, cam_ids=_rows(batch["camid"], r, 2), training=True, labels=labels,
                generator=torch.Generator().manual_seed(0), batch_group=group, moe_mesh=group)
    loss_func = make_loss(Config(), inp["editor"]["ecfg"].num_classes)
    total = sum(loss_func(score, feat, labels) for score, feat in res.pairs) + res.aux_loss
    total.backward()
    out["editor"] = {"loss": float(total.detach()),
                     "grads": {k: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
                               for k, p in model.named_parameters()}}
    return out


def moe_eval(inp, rank, world, out_dir):
    """The eval step of the MoE EDITOR on a data mesh of every rank: the
    features of ``batch`` and of its first ``n_pad`` rows (a size the ranks
    do not divide: the step pads it), the pairs dropped here in each, and
    the one-device eval of those rows."""
    from editor_tpu_torch.engine.evaluate import build_eval_step
    model = _model(inp)
    batch = {k: _t(v) for k, v in inp["batch"].items() if k != "pid"}
    short = {k: v[:inp["n_pad"]] for k, v in batch.items()}
    step = build_eval_step(model, torch.float64, _mesh())
    out = {}
    for name, b in (("feats", batch), ("padded", short)):
        with _Drops() as drops:
            out[name] = step(b)
        out[name + "_drops"] = sum(drops.counts)
    out["one_device"] = build_eval_step(model, torch.float64)(short)
    return out


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _toy_stage(params, h):
    w, b = params
    return torch.tanh(h @ w + b)


def pipeline_toy(inp, rank, world, out_dir):
    """The toy pipeline over a 'stage' mesh of every rank (stage s holds
    w[s], b[s]): for each of ``cases`` ({M, remat}) the output, the
    gradients of mean(out^2) with respect to w[s], b[s] and (stage 0) x, and
    ``is_recomputing()`` at each call of the stage;
    ``pipeline_train_step``'s loss and gradients; the stateful form's
    counts of calls and of valid calls; with 4 stages the long skip of
    ``tests/test_pipeline_skip_bn.py`` (stage 0 stashes its output, stage 3
    pops it and adds), its output and gradient of mean(out^2)."""
    from editor_tpu_torch.parallel.pipeline import (init_skips, is_recomputing,
                                                    pipeline_apply, pipeline_train_step, pop,
                                                    stash)
    mesh = _axis_mesh(world, "stage")
    w, b, x = (_t(inp[k]) for k in ("w", "b", "x"))
    out = {"cases": []}
    for case in inp["cases"]:
        p = (w[rank].clone().requires_grad_(True), b[rank].clone().requires_grad_(True))
        xg = x.clone().requires_grad_(True)
        calls = []

        def stage(params, h):
            calls.append(is_recomputing())
            return _toy_stage(params, h)

        y = pipeline_apply(stage, p, xg, mesh, case["M"], remat=case["remat"])
        (y ** 2).mean().backward()
        out["cases"].append({"y": y.detach(), "gw": p[0].grad, "gb": p[1].grad,
                             "gx": xg.grad if rank == 0 else None, "recomputing": calls})
    step = pipeline_train_step(_toy_stage, lambda y: (y ** 2).mean(), mesh, 4)
    loss, grads = step((w[rank].clone().requires_grad_(True),
                        b[rank].clone().requires_grad_(True)), x)
    out["train"] = {"loss": float(loss), "gw": grads[0], "gb": grads[1]}

    def counting(params, h, st, valid):
        return _toy_stage(params, h), {"ticks": st["ticks"] + 1,
                                       "valid": st["valid"] + int(valid)}

    y, st = pipeline_apply(counting, (w[rank], b[rank]), x, mesh, 3,
                           stage_state={"ticks": 0, "valid": 0})
    out["state"] = {"y": y, **st}
    if world == 4:
        def skip_stage(wl, xs):
            h, skips = xs
            o = torch.tanh(h @ wl)
            if rank == 0:
                skips = stash(skips, "s0to3", o)
            if rank == world - 1:
                val, skips = pop(skips, "s0to3")
                o = o + val
            return o, skips

        wl = w[rank].clone().requires_grad_(True)
        xs = (x, init_skips(x.shape[0], {"s0to3": torch.zeros(x.shape[1], dtype=x.dtype)}))
        y, _ = pipeline_apply(skip_stage, wl, xs, mesh, 4)
        (y ** 2).mean().backward()
        out["skip"] = {"y": y.detach(), "gw": wl.grad}
    return out


def pipeline_bn(inp, rank, world, out_dir):
    """DeferredBN inside each stage (stage s: BN, then tanh(h @ w[s])) with
    its accumulator as the stage state: the output, this stage's
    accumulator and the BN parameters it commits."""
    from editor_tpu_torch.parallel.deferred_bn import (bn_acc_init, bn_params_init,
                                                       deferred_bn_apply, deferred_bn_commit)
    from editor_tpu_torch.parallel.pipeline import pipeline_apply
    mesh = _axis_mesh(world, "stage")
    w, x = _t(inp["w"]), _t(inp["x"])
    D = x.shape[1]
    bn = bn_params_init(D, torch.float64)

    def stage_fn(params, h, acc, valid):
        wl, bnp = params
        h, acc = deferred_bn_apply(bnp, h, acc, valid)
        return torch.tanh(h @ wl), acc

    y, acc = pipeline_apply(stage_fn, (w[rank], bn), x, mesh, inp["M"],
                            stage_state=bn_acc_init(D, torch.float64))
    return {"y": y, "acc": acc, "committed": deferred_bn_commit(bn, acc)}


def pipeline_vit(inp, rank, world, out_dir):
    """The pipelined backbone on a (1, W / tp, tp) mesh with ``M``
    microbatches. ``eval``: the tokens and rollout rows of ``mods``.
    ``drop_path`` (tp 1): in training from a seeded generator, against the
    scan backbone from the same generator state, and the backbone's
    gradients of sum(mean(t^2)) both ways (the pipelined ones made whole by
    ``reduce_grads``). ``refusals``: the errors of a depth the stages do not
    divide, of dropout in training and (tp > 1) of heads the model axis does
    not divide."""
    import dataclasses

    from editor_tpu_torch.parallel.pipeline_vit import make_pipeline_backbone
    from editor_tpu_torch.parallel.tp import shard_editor
    tp = inp.get("tp", 1)
    mesh = _mesh(tp, world // tp)
    model = _model(inp)
    if tp > 1:
        shard_editor(model, mesh)
    bb = make_pipeline_backbone(mesh, inp["M"])
    ecfg = inp["ecfg"]
    mods = [_t(m) for m in inp["mods"]]
    cam = _t(inp["cam"])
    out = {}
    with torch.no_grad():
        toks, rolls = bb(model, ecfg, mods, cam, None, False, None)
    out["eval"] = {"toks": torch.cat(toks), "rolls": torch.cat(rolls)}
    if inp.get("drop_path"):
        def loss_of(toks):
            return sum((t ** 2).mean() for t in toks)

        def backbone_grads():
            return {n: p.grad.clone() for n, p in model.named_parameters()
                    if n.startswith("BACKBONE.base.") and p.grad is not None}

        toks, rolls = bb(model, ecfg, mods, cam, None, True, torch.Generator().manual_seed(7))
        loss_of(toks).backward()
        bb.reduce_grads(model)
        grads = backbone_grads()
        model.zero_grad(set_to_none=True)
        t_ref, r_ref = model.BACKBONE.base(torch.cat(mods), cam.repeat(len(mods)), None,
                                           ecfg.use_pallas, True,
                                           torch.Generator().manual_seed(7))
        loss_of(t_ref.split(mods[0].shape[0])).backward()
        out["drop_path"] = {"toks": torch.cat(toks).detach(), "rolls": torch.cat(rolls),
                            "toks_ref": t_ref.detach(), "rolls_ref": r_ref, "grads": grads,
                            "grads_ref": backbone_grads()}
    refusals = {}
    vc = ecfg.vit
    cases = [("depth", dataclasses.replace(vc, depth=vc.depth - 1)),
             ("dropout", dataclasses.replace(vc, drop_rate=0.1))]
    if tp > 1:
        cases.append(("heads", dataclasses.replace(vc, num_heads=tp + 1)))
    for key, vit in cases:
        try:
            bb(model, dataclasses.replace(ecfg, vit=vit), mods, cam, None, True,
               torch.Generator().manual_seed(0))
            refusals[key] = None
        except (ValueError, NotImplementedError) as e:
            refusals[key] = f"{type(e).__name__}: {e}"
    out["refusals"] = refusals
    return out


def train(inp, rank, world, out_dir):
    """Each of ``inp["runs"]`` (the shared fields of ``inp`` under each)."""
    shared = {k: v for k, v in inp.items() if k != "runs"}
    return [_train_run({**shared, **run}, rank, world) for run in inp["runs"]]


def loop_runs(inp, rank, world, out_dir):
    """``cli.train.main`` on the in-memory splits for each of ``inp["runs"]``
    ({argv, and optionally ``seed_ckpt``: a checkpoint file that rank 0
    copies into the run's ``OUTPUT_DIR/ckpt`` first, so that the run
    resumes from it}) in this process's group; each run's best metrics."""
    import shutil

    from editor_tpu_torch.cli import train as cli
    from editor_tpu_torch.data.datasets import DatasetSplits
    from tests.torch_dp import decode, items

    out = []
    for run in inp["runs"]:
        argv = run["argv"]
        if run.get("seed_ckpt") and rank == 0:
            ckpt = os.path.join(argv[argv.index("OUTPUT_DIR") + 1], "ckpt")
            os.makedirs(ckpt, exist_ok=True)
            shutil.copy(run["seed_ckpt"], ckpt)
        C.barrier()
        train, query, gallery = items()
        result = cli.main(argv, splits=DatasetSplits(train, query, gallery, 4, 2),
                          decode_fn=decode)
        out.append({"best": result["best"]})
    return out


def several(inp, rank, world, out_dir):
    """Each (scenario, inputs) of ``inp["parts"]`` in turn, in one group."""
    return [TASKS[name](part, rank, world, out_dir) for name, part in inp["parts"]]


# ---------------------------------------------------------------------------
# evaluation, the CLI, failures
# ---------------------------------------------------------------------------

def cmc(inp, rank, world, out_dir):
    from editor_tpu_torch.evals.metrics import sharded_cmc_map
    cmc_, mAP = sharded_cmc_map(*(_t(inp[k]) for k in ("qf", "gf", "q_pids", "g_pids",
                                                       "remove")), _mesh())
    return {"cmc": cmc_, "mAP": mAP}


def cli_train(inp, rank, world, out_dir):
    """``cli.train.main`` in a group made from the launcher's environment
    variables, on the in-memory splits: records the files this rank opened
    for writing and the item indices each ``train_epoch`` loaded."""
    import builtins

    from editor_tpu_torch.cli import train as cli
    from editor_tpu_torch.data import loader
    from editor_tpu_torch.data.datasets import DatasetSplits
    from tests.torch_dp import decode, items

    opened, loads = [], []
    real_open = builtins.open

    def spy_open(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            opened.append(os.path.abspath(str(file)))
        return real_open(file, mode, *a, **k)

    real_epoch = loader.ReIDDataModule.train_epoch

    def train_epoch(self, epoch, host_id=0, num_hosts=1, grad_accum=1):
        real = self.train_loader.batches

        def batches(idxs, bs):
            loads.append({"epoch": epoch, "host_id": host_id, "num_hosts": num_hosts,
                          "grad_accum": grad_accum, "idxs": np.asarray(idxs).copy(),
                          "bs": bs})
            return real(idxs, bs)

        self.train_loader.batches = batches
        try:
            return real_epoch(self, epoch, host_id, num_hosts, grad_accum)
        finally:
            del self.train_loader.batches

    real_save = torch.save

    def spy_save(obj, f, *a, **k):  # a path goes to torch's C++ writer, not open()
        if isinstance(f, (str, os.PathLike)):
            opened.append(os.path.abspath(str(f)))
        return real_save(obj, f, *a, **k)

    builtins.open, loader.ReIDDataModule.train_epoch = spy_open, train_epoch
    torch.save = spy_save
    try:
        train, query, gallery = items()
        result = cli.main(inp["argv"], splits=DatasetSplits(train, query, gallery, 4, 2),
                          decode_fn=decode)
    finally:
        builtins.open, loader.ReIDDataModule.train_epoch = real_open, real_epoch
        torch.save = real_save
    return {"opened": opened, "loads": loads, "best": result["best"]}


def cli_test(inp, rank, world, out_dir):
    """``cli.test.main`` in a group made from the launcher's environment."""
    from editor_tpu_torch.cli import test as cli
    from editor_tpu_torch.data.datasets import DatasetSplits
    from tests.torch_dp import decode, items

    train, query, gallery = items()
    cmc_, mAP = cli.main(inp["argv"], splits=DatasetSplits(train, query, gallery, 4, 2),
                         decode_fn=decode)
    return {"cmc": cmc_, "mAP": mAP}


def _committed(ckpt_dir: str, timeout: float = 60.0) -> None:
    """Waits until a checkpoint file is committed (renamed into place) in
    ``ckpt_dir``: an asynchronous save may still be writing."""
    import re
    import time
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if os.path.isdir(ckpt_dir) and any(re.match(r"step_\d+\.pt$", n)
                                           for n in os.listdir(ckpt_dir)):
            return
        time.sleep(0.05)
    raise TimeoutError(f"no committed checkpoint in {ckpt_dir}")


def launch_train(inp, rank, world, out_dir):
    """``cli.train.main`` under ``cli.launch`` on the in-memory splits. In
    incarnation 0 rank ``fail_rank``'s data raises as epoch ``fail_epoch``
    starts, once the checkpoint before it is committed. Records the epoch
    and step each rank resumed from."""
    from editor_tpu_torch.cli import train as cli
    from editor_tpu_torch.data import loader
    from editor_tpu_torch.data.datasets import DatasetSplits
    from editor_tpu_torch.engine import loop
    from tests.torch_dp import decode, items

    incarnation = int(os.environ["EDITOR_TPU_RESTART_COUNT"])
    argv = inp["argv"]
    out = argv[argv.index("OUTPUT_DIR") + 1]
    real_epoch, real_load = loader.ReIDDataModule.train_epoch, loop.load_train_state
    resumed = []

    def train_epoch(self, epoch, *a, **k):
        if incarnation == 0 and rank == inp["fail_rank"] and epoch == inp["fail_epoch"]:
            _committed(os.path.join(out, "ckpt"))
            raise RuntimeError(f"planted data failure in epoch {epoch}")
        return real_epoch(self, epoch, *a, **k)

    def load_train_state(payload, model, optimizer, *a, **k):
        epoch = real_load(payload, model, optimizer, *a, **k)
        resumed.append({"epoch": epoch, "count": optimizer.count})
        return epoch

    loader.ReIDDataModule.train_epoch, loop.load_train_state = train_epoch, load_train_state
    try:
        train, query, gallery = items()
        result = cli.main(argv, splits=DatasetSplits(train, query, gallery, 4, 2),
                          decode_fn=decode)
    finally:
        loader.ReIDDataModule.train_epoch, loop.load_train_state = real_epoch, real_load
    return {"resumed": resumed, "best": result["best"]}


def launch_group(inp, rank, world, out_dir):
    """Joins the group from the launcher's environment with ``RANK`` unset
    (the rank derived from ``NODE_RANK``, ``NPROC_PER_NODE`` and
    ``LOCAL_RANK``) and all-gathers every rank's view."""
    import torch.distributed as dist
    env = {k: os.environ.get(k) for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE",
                                          "LOCAL_WORLD_SIZE", "NODE_RANK", "NPROC_PER_NODE",
                                          "MASTER_ADDR", "MASTER_PORT")}
    os.environ.pop("RANK")
    multihost.initialize(device="cpu", timeout_s=60)
    mine = torch.tensor([dist.get_rank(), dist.get_world_size(), int(env["RANK"])])
    views = C.all_gather(mine, None, tiled=False)
    multihost.shutdown()
    return {"env": env, "views": views.tolist()}


def deliberate_exit(inp, rank, world, out_dir):
    """Rank 1 leaves by ``SystemExit(3)`` while rank 0 waits in a
    collective (the CLIs' handler)."""
    multihost.initialize(device="cpu", timeout_s=60)
    try:
        if rank == 1:
            raise SystemExit(3)
        C.all_reduce(torch.ones(4))
    except BaseException as e:  # noqa: BLE001
        multihost.leave_on_error(e)
        raise
    return {}


def fail(inp, rank, world, out_dir):
    """Rank 1 raises while rank 0 waits in a collective."""
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    C.all_reduce(torch.ones(4))
    return {}


def sharded(inp, rank, world, out_dir):
    """The sharded-tensor factories on a ('data',) mesh of every rank and on
    a (data 2, model 2) mesh: each tensor's metadata (every rank's shard),
    this rank's local block and the gathered whole; then
    ``utils.debug.monitored_barrier`` in time and, last, with rank 1 late
    past the deadline (every rank records what it raised; the group is
    destroyed right after, with no barrier)."""
    import dataclasses
    import time

    from torch.distributed.device_mesh import init_device_mesh

    from editor_tpu_torch.parallel import sharded_tensor as ST
    from editor_tpu_torch.utils import debug

    def record(arr):
        return {"meta": [dataclasses.astuple(m) for m in ST.shard_metadata_of(arr)],
                "local": arr.to_local().clone(), "full": arr.full_tensor()}

    out = {}
    for name, mesh in (("data", init_device_mesh("cpu", (world,), mesh_dim_names=("data",))),
                       ("data_model", init_device_mesh("cpu", (2, world // 2),
                                                       mesh_dim_names=("data", "model")))):
        spec0, spec1 = ST.ChunkShardingSpec(dim=0), ST.ChunkShardingSpec(dim=1)
        shards = tuple(ST.ShardMetadata((i * 16, 0), (16, 4), i) for i in range(4))
        out[name] = {
            "zeros": record(ST.sharded_zeros(spec0, (64, 16), mesh)),
            "ones": record(ST.sharded_ones(spec1, (4, 32), mesh)),
            "full": record(ST.sharded_full(spec0, (8, 6), 2.5, mesh)),
            "rand": record(ST.sharded_rand(spec0, tuple(inp["rand_shape"]), mesh,
                                           seed=inp["seed"])),
            "enumerable": record(ST.from_enumerable(
                ST.EnumerableShardingSpec(shards), (64, 4),
                lambda m: np.full(m.shard_sizes, m.shard_offsets[0], np.float32), mesh)),
        }
    out["barrier_s"] = debug.monitored_barrier(30.0, "in time")
    if rank == 1:
        time.sleep(inp["late_s"])
    try:
        debug.monitored_barrier(inp["deadline_s"], "late")
        out["late"] = None
    except TimeoutError as e:
        out["late"] = str(e)
    # the failed barrier leaves messages in flight: no collective after it
    torch.distributed.destroy_process_group()
    return out


TASKS = {"collectives": collectives, "sharded": sharded, "reducers": reducers, "train": train,
         "loop_runs": loop_runs, "several": several,
         "tp_eval": tp_eval, "row_parallel": row_parallel, "ring": ring, "moe": moe, "fusion_parallel": fusion_parallel,
         "moe_data": moe_data, "moe_eval": moe_eval,
         "pipeline_toy": pipeline_toy, "pipeline_bn": pipeline_bn, "pipeline_vit": pipeline_vit,
         "localsgd": localsgd, "cmc": cmc,
         "cli_train": cli_train, "cli_test": cli_test, "fail": fail,
         "launch_train": launch_train, "launch_group": launch_group,
         "deliberate_exit": deliberate_exit}
SELF_INIT = ("cli_train", "cli_test")  # the group comes from the environment (the CLIs)


def launched():
    """A worker of ``cli.launch``: the scenario joins the group itself."""
    scenario, out_dir = sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    out = TASKS[scenario](inp, rank, world, out_dir)
    torch.save(out, os.path.join(
        out_dir, f"out_{rank}_{os.environ['EDITOR_TPU_RESTART_COUNT']}.pt"))


def main():
    if sys.argv[1] == "--launched":
        return launched()
    scenario, rank, world, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    if scenario not in SELF_INIT:
        multihost.initialize(init_method="file://" + os.path.join(out_dir, "rendezvous"),
                             world_size=world, rank=rank, device="cpu",
                             timeout_s=inp.get("timeout_s", 60))
    try:
        out = TASKS[scenario](inp, rank, world, out_dir)
        torch.save(out, os.path.join(out_dir, f"out_{rank}.pt"))
    except BaseException as e:  # noqa: BLE001 - every rank must leave
        multihost.fail_fast(e)
    multihost.shutdown()


if __name__ == "__main__":
    main()
