"""JAX oracles and shared inputs of the port's data-parallel step tests
(``tests/test_torch_dp_step.py``, ``tests/test_torch_dp_ddp.py``,
``tests/test_torch_dp_loop.py``): the tiny config and batch of
``tests/test_torch_train_step.py`` (depth 2, width 96, B = 8 as 4 ids x 2,
drop path 0, no augmentation) at float64, JAX's mesh and DDP steps on the
first W of the conftest's 8 virtual CPU devices (each built and compiled
once a process; the DDP step once for all five reducers), and the comparison at ``test_torch_train_step.py``'s
tolerances. The tensor-parallel oracle (``tests/test_torch_tp.py``) is
JAX's step on a (data, model) mesh with the qkv columns permuted
shard-major and ``train_state_tp_shardings``, on the tiny config
(uncompacted: its 8 patches all fit the tail) and on a compact one (128 x 64,
HEAD_KEEP 1, FREQUENCY_KEEP 2: 32 patches cut to 15); with ``layout`` the TP
and pipelined steps take ZeRO-1's or FSDP's state shardings instead, as
JAX's loop builds them (``tests/test_torch_tp_zero.py``,
``tests/test_torch_pipeline_zero.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import lax

from editor_tpu.config import Config as JaxConfig
from editor_tpu.engine import build_train_step as jax_build_train_step
from editor_tpu.engine import make_train_state
from editor_tpu.engine.train import fsdp_state_shardings as jax_fsdp_state_shardings
from editor_tpu.losses import make_loss as jax_make_loss
from editor_tpu.models.fusion import blockmask_apply, blockmask_init, blockmask_moe_init
from editor_tpu.models.editor import EditorConfig as JaxEditorConfig
from editor_tpu.models.editor import editor_init as jax_editor_init
from editor_tpu.models.vit import ViTConfig as JaxViTConfig
from editor_tpu.parallel.compression import Reducer
from editor_tpu.parallel.compression import make_reducer as jax_make_reducer
from editor_tpu.parallel.ddp import DDPState, build_ddp_train_step
from editor_tpu.parallel.mesh import make_mesh as jax_make_mesh
from editor_tpu.parallel.mesh import shard_batch as jax_shard_batch
from editor_tpu.solver import make_optimizer as jax_make_optimizer
from editor_tpu.solver import make_scheduler as jax_make_scheduler
from editor_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.torch_parity import to_numpy_tree, torch_editor_config

B = 8
REDUCERS = ("allreduce", "fp16", "bf16", "int8", "powersgd")


def tiny_jax_config(compact: bool = False, moe_experts: int = 0):
    """The JAX EditorConfig of these tests (depth 2, width 96, drop path 0);
    ``compact``: 128 x 64 images whose tail compacts."""
    size, keep = ((128, 64), (1, 2)) if compact else ((64, 32), (2, 3))
    vit = JaxViTConfig(img_size=size, patch_size=16, stride_size=(16, 16),
                       embed_dim=96, depth=2, num_heads=4, mlp_ratio=2.0, camera=4,
                       drop_path_rate=0.0)
    return JaxEditorConfig(num_classes=4, vit=vit, head_keep=keep[0], frequency_keep=keep[1],
                           use_pallas=False, moe_experts=moe_experts)


@functools.lru_cache(maxsize=None)
def jax_setup(compact: bool = False, moe_experts: int = 0):
    """(JAX EditorConfig, Config, optimizer, float64 train state), made once
    a process."""
    jcfg = tiny_jax_config(compact, moe_experts)
    cfg = JaxConfig()
    params, _ = jax_editor_init(jax.random.PRNGKey(0), jcfg)
    opt = jax_make_optimizer(cfg, params)
    state = make_train_state(jax.random.PRNGKey(0), jcfg, opt)
    state = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, state)
    return jcfg, cfg, opt, state


def make_batch(cross_shard: bool = False, size=(64, 32)):
    rng = np.random.RandomState(1)
    batch = {m: rng.randn(B, *size, 3) for m in ("RGB", "NI", "TI")}
    batch["pid"] = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    batch["camid"] = np.arange(B) % 4
    if cross_shard:  # identity 2 (rank 1's rows) a near copy of identity 0 (rank 0's)
        for m in ("RGB", "NI", "TI"):
            batch[m][4:6] = batch[m][0:2] + 0.01 * rng.randn(2, 64, 32, 3)
    return batch


@functools.lru_cache(maxsize=None)
def jax_global_step(W, grad_accum, moe_experts=0):
    """JAX's mesh step, built (and compiled at its first call) once a module."""
    jcfg, cfg, opt, _ = jax_setup(moe_experts=moe_experts)
    mesh = jax_make_mesh(data=W, model=1, devices=jax.devices()[:W])
    return mesh, jax_build_train_step(jcfg, opt, jax_make_loss(cfg, 4),
                                      jax_make_scheduler(cfg), cfg.SOLVER.BASE_LR,
                                      compute_dtype=jnp.float64, mesh=mesh, donate=False,
                                      grad_accum=grad_accum)


@functools.lru_cache(maxsize=None)
def jax_fsdp_step(W, grad_accum):
    """JAX's FSDP step (``state_shardings=fsdp_state_shardings``,
    ``gather_params_compute=True``) and its state layout, built once a
    module."""
    jcfg, cfg, opt, state = jax_setup()
    mesh = jax_make_mesh(data=W, model=1, devices=jax.devices()[:W])
    shardings = jax_fsdp_state_shardings(state, mesh)
    return mesh, shardings, jax_build_train_step(
        jcfg, opt, jax_make_loss(cfg, 4), jax_make_scheduler(cfg), cfg.SOLVER.BASE_LR,
        compute_dtype=jnp.float64, mesh=mesh, donate=False, grad_accum=grad_accum,
        state_shardings=shardings, gather_params_compute=True)


def jax_fsdp(state, batch, W, grad_accum=1, steps=2):
    """JAX's FSDP run: (losses, the sharded train state after it, mesh)."""
    mesh, shardings, step = jax_fsdp_step(W, grad_accum)
    state = jax.tree_util.tree_map(jax.device_put, state, shardings)
    feed = jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    losses = []
    for epoch in range(1, steps + 1):
        state, m = step(state, feed, jnp.asarray(epoch))
        losses.append(float(m["loss"]))
    return losses, state, mesh


def device_shards(leaf, mesh):
    """A JAX array's block on each device of the mesh's data axis, in
    order."""
    order = {d: i for i, d in enumerate(mesh.devices.flat)}
    out = [None] * len(order)
    for sh in leaf.addressable_shards:
        out[order[sh.device]] = np.asarray(sh.data)
    return out


def switch_reducer():
    """JAX's five reducers (``REDUCERS``) behind one selector in the state
    (``which``), so that one ``build_ddp_train_step`` compile serves them
    all: each branch of a ``lax.switch`` is the JAX reducer's own
    ``reduce``; the stateless ones pass PowerSGD's state (``ps``) through."""
    reds = [jax_make_reducer(name, rank=4) for name in REDUCERS]
    ps = reds[-1]

    def branch(red):
        def f(grads, ps_state, axis_name):
            if red is ps:
                return red.reduce(grads, ps_state, axis_name)
            return red.reduce(grads, (), axis_name)[0], ps_state
        return f

    def init(template):
        return {"which": jnp.int32(0), "ps": ps.init(template)}

    def reduce(grads, state, axis_name):
        out, new_ps = lax.switch(state["which"],
                                 [functools.partial(branch(r), axis_name=axis_name)
                                  for r in reds], grads, state["ps"])
        return out, {"which": state["which"], "ps": new_ps}

    return Reducer(init, reduce, "switch")


@functools.lru_cache(maxsize=None)
def jax_ddp_step(W):
    """JAX's DDP step over ``switch_reducer``, built once a module."""
    jcfg, cfg, opt, _ = jax_setup()
    mesh = jax_make_mesh(data=W, model=1, devices=jax.devices()[:W])
    red = switch_reducer()
    return mesh, red, build_ddp_train_step(jcfg, opt, jax_make_loss(cfg, 4),
                                           jax_make_scheduler(cfg), cfg.SOLVER.BASE_LR, mesh,
                                           reducer=red, compute_dtype=jnp.float64)


def jax_global(state, batch, W, grad_accum=1, steps=2, moe_experts=0):
    mesh, step = jax_global_step(W, grad_accum, moe_experts)
    feed = jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    losses = []
    for epoch in range(1, steps + 1):
        state, m = step(state, feed, jnp.asarray(epoch))
        losses.append(float(m["loss"]))
    return losses, state


def jax_ddp(state, batch, W, name, steps=2):
    """JAX's DDP step with reducer ``name``: (losses, train state after
    each step, PowerSGD's initial state)."""
    mesh, red, step = jax_ddp_step(W)
    comm0 = dict(red.init(state.params), which=jnp.int32(REDUCERS.index(name)))
    dd = DDPState(train=state, comm=comm0)
    feed = jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    losses, states = [], []
    for epoch in range(1, steps + 1):
        dd, m = step(dd, feed, jnp.asarray(epoch))
        losses.append(float(m["loss"]))
        states.append(dd.train)
    return losses, states, comm0["ps"]


def _layout_shardings(layout, state, mesh):
    """The state layout JAX's ``do_train`` gives a run on ``mesh``: 'tp'
    (``train_state_tp_shardings``), 'zero1' or 'fsdp' (``zero1_state_shardings``,
    ``fsdp_state_shardings``, which take precedence there), or None."""
    from editor_tpu.engine.train import zero1_state_shardings
    from editor_tpu.parallel.tp import train_state_tp_shardings
    return {"tp": train_state_tp_shardings, "zero1": zero1_state_shardings,
            "fsdp": jax_fsdp_state_shardings,
            None: lambda st, m: None}[layout](state, mesh)


@functools.lru_cache(maxsize=None)
def jax_tp_step(data, model, compact=False, moe_experts=0, layout="tp"):
    """JAX's tensor-parallel step on a (data, model) mesh and its state
    layout (``layout``: the TP layout, or ZeRO-1's or FSDP's as JAX's loop
    builds them with a model axis), built once a module."""
    from editor_tpu.parallel.tp import permute_train_state
    jcfg, cfg, opt, state = jax_setup(compact, moe_experts)
    mesh = jax_make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    shardings = _layout_shardings(layout,
                                  permute_train_state(state, jcfg.vit.num_heads, model), mesh)
    return mesh, shardings, jax_build_train_step(
        jcfg, opt, jax_make_loss(cfg, 4), jax_make_scheduler(cfg), cfg.SOLVER.BASE_LR,
        compute_dtype=jnp.float64, mesh=mesh, donate=False, state_shardings=shardings,
        gather_params_compute=layout == "fsdp")


def jax_tp(state, batch, data, model, compact=False, steps=2, moe_experts=0, layout="tp"):
    """JAX's TP run from the canonical ``state``: (losses, the canonical
    train state after it)."""
    from editor_tpu.parallel.tp import permute_train_state
    jcfg = jax_setup(compact, moe_experts)[0]
    H = jcfg.vit.num_heads
    mesh, shardings, step = jax_tp_step(data, model, compact, moe_experts, layout)
    st = jax.tree_util.tree_map(jax.device_put, permute_train_state(state, H, model),
                                shardings)
    feed = jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    losses = []
    for epoch in range(1, steps + 1):
        st, m = step(st, feed, jnp.asarray(epoch))
        losses.append(float(m["loss"]))
    return losses, permute_train_state(jax.device_get(st), H, model, inverse=True)


def port_inputs(jcfg, state, batch, **kw):
    sd = state_dict_from_jax(to_numpy_tree(state.params), to_numpy_tree(state.model_state),
                             jcfg)
    return dict(ecfg=torch_editor_config(jcfg), sd=sd, batch=batch, steps=2, **kw)


def jax_state_dict(jcfg, state):
    return state_dict_from_jax(to_numpy_tree(state.params), to_numpy_tree(state.model_state),
                               jcfg)


def close_to_jax(got, ref_losses, ref_sd, sd0, param_tol=1e-7, what="", sd=None,
                 stat_tol=(1e-7, 1e-8)):
    """The port's run ``got`` against a JAX run: losses and the final state
    (or ``sd``), at test_torch_train_step.py's tolerances (``param_tol``
    and ``stat_tol``, the BN running stats' rtol and atol, where a test
    states others). Returns whether it held."""
    try:
        np.testing.assert_allclose(got["loss"], ref_losses, rtol=1e-7)
        sd = got["sd"] if sd is None else sd
        for name, start in sd0.items():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[name].numpy(), ref_sd[name].numpy(),
                                           rtol=stat_tol[0], atol=stat_tol[1], err_msg=name)
            elif name.endswith("_centers"):
                np.testing.assert_allclose(sd[name].numpy(), ref_sd[name].numpy(), rtol=1e-6,
                                           atol=1e-7, err_msg=name)
            elif sd[name].is_floating_point() and "FREQ_INDEX" not in name:
                d_got = sd[name].numpy() - start.numpy()
                d_ref = ref_sd[name].numpy() - start.numpy()
                np.testing.assert_allclose(
                    d_got, d_ref, rtol=0, err_msg=f"{what} {name}",
                    atol=max(param_tol * np.abs(d_ref).max(), 1e-15))
    except AssertionError as e:
        print(e)  # shown with the failing test's output
        return False
    return True


def fusion_state_dict(fb, num_classes: int, dim: int) -> dict:
    """The port's ``BlockMask`` state dict of JAX ``blockmask_init`` (or
    ``blockmask_moe_init``) params: LayerNorm w/b -> weight/bias, Linear w
    [in, out] -> weight [out, in], the MoE leaves as they are, zero OCFR
    centers."""
    sd = {}
    for name, sub in fb.items():
        if name == "moe_mlp":
            sd.update({f"moe_mlp.{k}": torch.tensor(np.asarray(v)) for k, v in sub.items()})
        elif "w" in sub:  # a LayerNorm
            sd[f"{name}.weight"] = torch.tensor(np.asarray(sub["w"]))
            sd[f"{name}.bias"] = torch.tensor(np.asarray(sub["b"]))
        else:
            for lin, p in sub.items():
                sd[f"{name}.{lin}.weight"] = torch.tensor(np.asarray(p["w"]).T.copy())
    for m in ("RGB", "NIR", "TIR"):
        sd[f"memory_cls.{m}_centers"] = torch.zeros(num_classes, dim, dtype=torch.float64)
    return sd


def fusion_inputs(W, experts=0, seed=3, batch=2, overflow=False):
    """A fusion block of width 96 with 12 heads (JAX's init at float64),
    its state dict in the port's names and ``batch`` rows of inputs whose
    per-modality length (1 + P = 4W) every W divides, and the fixed
    projection ``proj`` of the fused tokens that the loss takes
    (mean(fused^2) would not do: the output LayerNorm makes it nearly
    constant, and the gradients before it rounding noise). ``overflow``:
    the MoE router from :func:`overflowing_router`."""
    key = jax.random.PRNGKey(seed)
    fb = (blockmask_moe_init(key, dim=96, num_experts=experts) if experts
          else blockmask_init(key, dim=96))
    fb = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), fb)
    if overflow:
        fb["moe_mlp"]["router"] = overflowing_router(fb["moe_mlp"]["router"])
    rng = np.random.RandomState(seed)
    P = 4 * W - 1
    fusion = {"dim": 96, "num_classes": 4, "mlp_ratio": 4.0, "heads": 12, "experts": experts,
              "sd": fusion_state_dict(fb, 4, 96),
              "feats": [rng.randn(batch, 1 + P, 96) for _ in range(3)],
              "mask": (rng.rand(batch, P, 1) < 0.5).astype(np.float64),
              "labels": np.arange(batch) % 4,
              "proj": rng.randn(batch, 3 * (1 + P), 96)}
    return fb, fusion


def overflowing_router(router):
    """The MoE router [D, E] of the data-mesh tests: expert 2's column x5,
    so that expert 2 takes more (token, choice) pairs than its capacity on
    their batches (the tests count the dropped pairs)."""
    r = jnp.asarray(router)
    return r.at[:, 2].multiply(5.0)


def jax_fusion_data(params, fusion, data_mesh, **kw):
    """JAX's ``blockmask_apply`` in training jitted with the features, mask
    and labels sharded ``P('data')`` over ``data_mesh`` (``kw``: its MoE
    options), one compile: the loss mean(fused * proj) + OCFR + 0.01 aux,
    the fused tokens, the aux loss and the gradients in the port's names."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    proj = jnp.asarray(fusion["proj"])

    def loss(params, feats, mask, labels):
        centers = {m: jnp.zeros((4, 96)) for m in ("rgb", "nir", "tir")}
        fused, ocfr, _, aux = blockmask_apply(params, feats, mask, centers, labels,
                                              num_heads=12, training=True, use_pallas=False,
                                              **kw)
        return jnp.mean(fused * proj) + ocfr + 0.01 * aux, (fused, aux)

    data = NamedSharding(data_mesh, P("data"))
    fn = jax.jit(jax.value_and_grad(loss, has_aux=True), in_shardings=(None, data, data, data))
    (value, (fused, aux)), g = fn(params, [jnp.asarray(f) for f in fusion["feats"]],
                                  jnp.asarray(fusion["mask"]), jnp.asarray(fusion["labels"]))
    grads = {k: v.numpy() for k, v in fusion_state_dict(g, 4, 96).items()
             if "memory_cls" not in k}
    return {"loss": float(value), "fused": np.asarray(fused), "aux": float(aux),
            "grads": grads}


def moe_overflow_state(moe_experts=8):
    """(JAX EditorConfig, float64 train state) of :func:`jax_setup` with the
    fusion MoE's router from :func:`overflowing_router`."""
    import dataclasses
    jcfg, _, _, state = jax_setup(moe_experts=moe_experts)
    fb = dict(state.params["FUSE_block"])
    fb["moe_mlp"] = dict(fb["moe_mlp"], router=overflowing_router(fb["moe_mlp"]["router"]))
    return jcfg, dataclasses.replace(state, params=dict(state.params, FUSE_block=fb))


def jax_moe_editor_grads(jcfg, state, batch, mesh):
    """JAX's ``editor_apply(moe_mesh=mesh)`` in training, jitted with the
    batch sharded ``P('data')`` over ``mesh``, and the train step's loss
    (every (score, feat) pair through ``make_loss`` plus the aux loss):
    (the loss, its gradients in the port's names)."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from editor_tpu.models.editor import editor_apply
    cfg = jax_setup(moe_experts=jcfg.moe_experts)[1]
    loss_func = jax_make_loss(cfg, jcfg.num_classes)

    def loss(params, images, labels, cams):
        out, _ = editor_apply(params, state.model_state, jcfg, images, labels=labels,
                              cam_ids=cams, training=True, rng=jax.random.PRNGKey(0),
                              moe_mesh=mesh)
        total = jnp.asarray(0.0, jnp.float32)
        for score, feat in out.pairs:
            total = total + loss_func(score, feat, labels)
        return total + out.aux_loss

    data = NamedSharding(mesh, P("data"))
    fn = jax.jit(jax.value_and_grad(loss), in_shardings=(None, data, data, data))
    value, g = fn(state.params, {m: jnp.asarray(batch[m]) for m in ("RGB", "NI", "TI")},
                  jnp.asarray(batch["pid"]), jnp.asarray(batch["camid"]))
    return float(value), state_dict_from_jax(to_numpy_tree(g),
                                             to_numpy_tree(state.model_state), jcfg)


def jax_fusion_loss(params, fusion, **kw):
    """JAX's ``blockmask_apply`` in training (``kw``: its mesh options):
    mean(fused * proj) + OCFR (+ 0.01 aux), in one compile."""
    def loss(params, feats, mask, labels):
        centers = {m: jnp.zeros((4, 96)) for m in ("rgb", "nir", "tir")}
        fused, ocfr, _, aux = blockmask_apply(params, feats, mask, centers, labels,
                                              num_heads=12, training=True, use_pallas=False,
                                              **kw)
        return (jnp.mean(fused * jnp.asarray(fusion["proj"])) + ocfr
                + (0.0 if aux is None else 0.01 * aux))

    return float(jax.jit(loss)(params, [jnp.asarray(f) for f in fusion["feats"]],
                               jnp.asarray(fusion["mask"]), jnp.asarray(fusion["labels"])))


def local_fusion(fusion, **kw):
    """The port's fusion block on one process: (loss, gradients by name)."""
    from tests.torch_dp_worker import _fusion
    block, feats, mask, labels = _fusion({"fusion": fusion})
    fused, ocfr, aux = block(feats, mask, False, labels=labels, **kw)
    loss = (fused * torch.from_numpy(fusion["proj"])).mean() + ocfr
    loss = loss + (0.0 if aux is None else 0.01 * aux)
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in block.named_parameters()}


# ---------------------------------------------------------------------------
# the pipeline (tests/test_torch_pipeline_step.py, test_torch_pipeline_vit.py)
# ---------------------------------------------------------------------------

PP_B = 4


def pp_jax_config():
    """The JAX EditorConfig of the pipeline tests: ``tests/test_parallel.py``'s
    pipelined EDITOR (64 x 32, width 96, depth 4, 4 heads, 2 cameras) at
    drop path 0."""
    vit = JaxViTConfig(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                       embed_dim=96, depth=4, num_heads=4, mlp_ratio=2.0, camera=2,
                       drop_path_rate=0.0)
    return JaxEditorConfig(num_classes=4, vit=vit, head_keep=2, frequency_keep=3,
                           use_pallas=False)


@functools.lru_cache(maxsize=None)
def pp_jax_setup():
    """(JAX EditorConfig, Config, optimizer, float64 train state) of
    :func:`pp_jax_config`, made once a process."""
    jcfg = pp_jax_config()
    cfg = JaxConfig()
    params, _ = jax_editor_init(jax.random.PRNGKey(0), jcfg)
    opt = jax_make_optimizer(cfg, params)
    state = make_train_state(jax.random.PRNGKey(0), jcfg, opt)
    state = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, state)
    return jcfg, cfg, opt, state


def make_pp_batch():
    """B = 4 as 2 ids x 2, 2 cameras (``tests/test_parallel.py``'s pids)."""
    rng = np.random.RandomState(0)
    batch = {m: rng.randn(PP_B, 64, 32, 3) for m in ("RGB", "NI", "TI")}
    batch["pid"] = np.arange(PP_B) % 2
    batch["camid"] = np.arange(PP_B) % 2
    return batch


def pp_jax_mesh(data, stage, model):
    """JAX's mesh of the layout: ('stage',), ('data', 'stage') or
    ('data', 'stage', 'model') over the first devices."""
    from jax.sharding import Mesh
    devs = np.asarray(jax.devices()[:data * stage * model])
    if data == 1 and model == 1:
        return Mesh(devs, ("stage",))
    if model == 1:
        return Mesh(devs.reshape(data, stage), ("data", "stage"))
    return Mesh(devs.reshape(data, stage, model), ("data", "stage", "model"))


@functools.lru_cache(maxsize=None)
def jax_pp_step(data, stage, model, microbatches, layout=None):
    """JAX's train step with ``make_pipeline_backbone`` on that mesh (with
    ``layout``, ZeRO-1's or FSDP's state shardings, as ``_layout_shardings``)
    and that state layout, built once a process."""
    from editor_tpu.parallel.pipeline_vit import make_pipeline_backbone
    jcfg, cfg, opt, state = pp_jax_setup()
    mesh = pp_jax_mesh(data, stage, model)
    shardings = _layout_shardings(layout, state, mesh)
    return mesh, shardings, jax_build_train_step(
        jcfg, opt, jax_make_loss(cfg, 4), jax_make_scheduler(cfg), cfg.SOLVER.BASE_LR,
        compute_dtype=jnp.float64, mesh=mesh, donate=False,
        backbone=make_pipeline_backbone(mesh, num_microbatches=microbatches),
        state_shardings=shardings, gather_params_compute=layout == "fsdp")


def jax_pp(batch, data, stage, model, microbatches, steps=2, layout=None):
    """JAX's pipelined run from :func:`pp_jax_setup`'s state: (losses, the
    canonical train state after it); under model > 1 the qkv columns are
    permuted shard-major for the run and back after it."""
    import dataclasses

    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from editor_tpu.parallel.tp import permute_qkv_params
    jcfg, _, _, state = pp_jax_setup()
    H = jcfg.vit.num_heads
    mesh, shardings, step = jax_pp_step(data, stage, model, microbatches, layout)
    if model > 1:
        state = dataclasses.replace(state, params=permute_qkv_params(state.params, H, model))
    if shardings is not None:
        state = jax.tree_util.tree_map(jax.device_put, state, shardings)
    spec = P("data") if "data" in mesh.axis_names else P()
    feed = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec))
            for k, v in batch.items()}
    losses = []
    for epoch in range(1, steps + 1):
        state, m = step(state, feed, jnp.asarray(epoch))
        losses.append(float(m["loss"]))
    state = jax.device_get(state)
    if model > 1:
        state = dataclasses.replace(state, params=permute_qkv_params(state.params, H, model,
                                                                     inverse=True))
    return losses, state
